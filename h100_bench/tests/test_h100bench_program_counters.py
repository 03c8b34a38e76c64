"""The readers of the program's own counters (``metrics/_program_counters.py``
and the five readers beside it).

* Each reader gives ``None`` where the program has no ``counters`` (a tree
  older than them) or counted no solve, and its ratio on a snapshot.
* The harness on the CPU (``tiny``) prints each cell's counter metrics in
  a traced run and none in an untraced one.
* On the card (``card``): one captured solve to rtol 1e-5 and one
  ``norm_type="none"`` solve count their captures, the capture pool, the
  capture seconds of :class:`CudaCapture` and the reads as the loop's
  arithmetic says.
"""

import json
import math
import sys
import types

import numpy as np
import pytest

from conftest import ROOT, run_cell

PROGRAM = "new_cg_variants_tpu_torch.utils.profiling"
#: reader file -> (counter, scale)
READERS = {
    "host_syncs_per_solve": ("host_syncs", 1.0),
    "overshoot_steps_per_solve": ("steps_taken_back", 1.0),
    "captures_per_call": ("captures", 1.0),
    "capture_pool_mb": ("pool_bytes", 1e-6),
    "launch_ms": ("replay_s", 1e3),
}
SNAPSHOT = {"solves": 8, "host_syncs": 376, "steps_taken_back": 250,
            "captures": 16, "pool_bytes": 2.4e8, "replay_s": 0.05}


def _benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _counter_metrics(workload):
    return {m["name"] for m in _benchmark()["per_layer"]
            if m["name"].split(".")[0] in READERS
            and workload in m["workloads"]}


def _reader(stem):
    from h100_bench.spec import load_module

    return load_module(ROOT / "h100_bench" / "metrics" / f"{stem}.py")


def _program(monkeypatch, snapshot=None):
    """Stand in the program's profiling module: one with ``counters``
    answering ``snapshot``, or, given none, one without ``counters``."""
    module = types.ModuleType(PROGRAM)
    if snapshot is not None:
        module.counters = lambda: dict(snapshot)
    monkeypatch.setitem(sys.modules, PROGRAM, module)


@pytest.mark.parametrize("stem", sorted(READERS))
def test_no_counters_no_reading(monkeypatch, stem):
    _program(monkeypatch)
    assert _reader(stem).read({}) is None


@pytest.mark.parametrize("stem", sorted(READERS))
def test_no_solve_no_reading(monkeypatch, stem):
    _program(monkeypatch, {"solves": 0, "host_syncs": 3})
    assert _reader(stem).read({}) is None
    _program(monkeypatch, {})
    assert _reader(stem).read({}) is None


@pytest.mark.parametrize("stem", sorted(READERS))
def test_the_ratio_of_a_snapshot(monkeypatch, stem):
    counter, scale = READERS[stem]
    _program(monkeypatch, SNAPSHOT)
    assert _reader(stem).read({}) == pytest.approx(
        scale * SNAPSHOT[counter] / SNAPSHOT["solves"], rel=1e-15)
    _program(monkeypatch, {"solves": 4})
    assert _reader(stem).read({}) == 0.0


def test_every_counter_metric_has_its_reader_and_cells():
    names = [m["name"] for m in _benchmark()["per_layer"]]
    cells = {w["name"] for w in _benchmark()["workloads"]}
    ours = [n for n in names if n.split(".")[0] in READERS]
    assert len(ours) == 8 and names[-8:] == ours
    for m in _benchmark()["per_layer"][-8:]:
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert set(m["workloads"]) <= cells and m["workloads"]


@pytest.mark.parametrize("workload", ["petsc_banded_k32.fixed4000",
                                      "petsc_banded_k32.rtol1e-5"])
def test_traced_runs_print_the_counter_metrics(tiny, workload):
    rc, line, _ = run_cell(tiny, workload, trace=1)
    assert rc == 0 and line["correct"] is True
    want = _counter_metrics(workload)
    assert want and want <= set(line["metrics"])
    for name in want:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name
    if workload.endswith("rtol1e-5"):
        # on the CPU the eager loop: the tolerance, a read an iteration and
        # after the last, and solve's three reads
        assert line["metrics"]["host_syncs_per_solve"]["value"] >= 5
    rc, line, _ = run_cell(tiny, workload, trace=0)
    assert rc == 0 and not want & set(line["metrics"])


@pytest.mark.card
def test_counters_of_a_captured_solve_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from h100_bench.program_hooks import Hooks
    from new_cg_variants_tpu_torch import banded_model, solve
    from new_cg_variants_tpu_torch.solvers import graphs
    from new_cg_variants_tpu_torch.utils import profiling

    op, b, _ = banded_model(65_536, k=8, dtype=np.float32, device="cuda")
    solve(op, b, rtol=1e-5, device="cuda")  # builds the kernels

    def counted(**kw):
        hooks = Hooks()
        try:
            before = profiling.counters()
            res = solve(op, b, device="cuda", **kw)
            torch.cuda.synchronize()
            after = profiling.counters()
            seconds = hooks.capture_seconds()
        finally:
            hooks.remove()
        grown = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        print(kw, "iterations", res.iterations, "counters", grown,
              "CudaCapture seconds", seconds)
        return res, grown, seconds

    res, grown, seconds = counted(rtol=1e-5, max_iter=10_000)
    k, c = res.iterations, graphs.CHUNK
    assert res.converged and k > c + 1
    chunks, inside = -(-(k - 1) // c), (k - 1) % c
    assert grown["solves"] == 1
    assert grown["captures"] == 1 + (inside > 0)
    assert grown["replays"] == chunks + inside
    assert grown.get("steps_taken_back", 0) == (c if inside else 0)
    # the tolerance, the initial norm, the first step's, one a chunk, and
    # solve's three
    assert grown["host_syncs"] == 3 + chunks + 3
    assert grown["pool_bytes"] > 0
    assert grown["capture_s"] == pytest.approx(seconds, rel=1e-9)
    assert grown["replay_s"] > 0

    res, grown, seconds = counted(norm_type="none", max_iter=100)
    steps = 100 - 1
    assert grown["host_syncs"] == 1 and res.iterations == 100
    assert grown["captures"] == 1 + (steps % c > 0)
    assert grown["replays"] == steps // c + steps % c
    assert "steps_taken_back" not in grown
    assert grown["pool_bytes"] > 0
    assert grown["capture_s"] == pytest.approx(seconds, rel=1e-9)
