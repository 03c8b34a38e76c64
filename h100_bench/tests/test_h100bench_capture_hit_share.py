"""The reader ``metrics/capture_hit_share.py`` and the store it reads.

* The reader gives ``None`` where the program has no ``counters`` (a tree
  older than them) or counted no solve, 0 where it counts solves and no
  ``capture_hits`` (a tree older than the counter), else 100 hits over
  solves.
* ``capture_hit_share.iter`` / ``.solve`` are the last two ``per_layer``
  entries, counter metrics, better higher, in cells of the benchmark.
* The harness on the CPU (``tiny``) prints them in a traced run and not in
  an untraced one.
* On the card (``card``): a tolerance solve again on the same operator
  replays the stored graphs, captures nothing and gives the same bits.
"""

import json
import math
import sys
import types

import numpy as np
import pytest

from conftest import ROOT, run_cell

PROGRAM = "new_cg_variants_tpu_torch.utils.profiling"
NAMES = ["capture_hit_share.iter", "capture_hit_share.solve"]


def _benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _read(monkeypatch, snapshot=None):
    """The reader against a stand-in of the program's profiling module: one
    with ``counters`` answering ``snapshot``, or, given none, one without
    ``counters``."""
    from h100_bench.spec import load_module

    module = types.ModuleType(PROGRAM)
    if snapshot is not None:
        module.counters = lambda: dict(snapshot)
    monkeypatch.setitem(sys.modules, PROGRAM, module)
    path = ROOT / "h100_bench" / "metrics" / "capture_hit_share.py"
    return load_module(path).read({})


@pytest.mark.parametrize("snapshot,want", [
    (None, None),
    ({}, None),
    ({"solves": 0, "capture_hits": 3}, None),
    ({"solves": 4}, 0.0),
    ({"solves": 8, "captures": 16, "capture_hits": 7}, 87.5),
    ({"solves": 300, "captures": 2, "capture_hits": 299}, 100 * 299 / 300),
])
def test_the_reading_of_a_snapshot(monkeypatch, snapshot, want):
    got = _read(monkeypatch, snapshot)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-15)


def test_the_entries_are_the_last_two_counter_metrics():
    per_layer = _benchmark()["per_layer"]
    cells = {w["name"] for w in _benchmark()["workloads"]}
    assert [m["name"] for m in per_layer[-2:]] == NAMES
    moves = {"capture_hit_share.iter": "iter_ms",
             "capture_hit_share.solve": "solves_per_s"}
    capture_ms = {m["name"].split(".")[1]: m["workloads"] for m in per_layer
                  if m["name"].startswith("capture_ms.")}
    for m in per_layer[-2:]:
        assert m["source"] == "program_counter" and m["better"] == "higher"
        assert m["unit"] == "%" and m["layer"] == "captured loop"
        assert m["moves"] == moves[m["name"]]
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert m["workloads"] == capture_ms[m["name"].split(".")[1]]


@pytest.mark.parametrize("workload", ["petsc_banded_k32.fixed4000",
                                      "petsc_banded_k32.rtol1e-5"])
def test_traced_runs_print_the_hit_share(tiny, workload):
    want = {m["name"] for m in _benchmark()["per_layer"]
            if m["name"] in NAMES and workload in m["workloads"]}
    assert len(want) == 1
    rc, line, _ = run_cell(tiny, workload, trace=1)
    assert rc == 0 and line["correct"] is True
    for name in want:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and 0 <= value <= 100, name
    rc, line, _ = run_cell(tiny, workload, trace=0)
    assert rc == 0 and not want & set(line["metrics"])


@pytest.mark.card
def test_a_second_solve_replays_the_stored_graphs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from new_cg_variants_tpu_torch import banded_model, solve
    from new_cg_variants_tpu_torch.solvers import graphs
    from new_cg_variants_tpu_torch.utils import profiling

    op, b, _ = banded_model(65_536, k=8, dtype=np.float32, device="cuda")
    # builds the kernels, and stores no graphs
    solve(op, b, rtol=1e-5, device="cuda", use_jit=False)

    def counted():
        before = profiling.counters()
        res = solve(op, b, device="cuda", rtol=1e-5, max_iter=10_000)
        torch.cuda.synchronize()
        after = profiling.counters()
        grown = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        print("iterations", res.iterations, "counters", grown)
        return res, grown

    first, grown = counted()
    k, c = first.iterations, graphs.CHUNK
    assert first.converged and k > c + 1
    chunks, inside = -(-(k - 1) // c), (k - 1) % c
    assert grown["captures"] == 1 + (inside > 0)
    assert "capture_hits" not in grown

    again, grown = counted()
    assert again.iterations == k and torch.equal(again.x, first.x)
    assert grown["capture_hits"] == 1 and grown["solves"] == 1
    assert grown["replays"] == chunks + inside
    assert "captures" not in grown and "pool_bytes" not in grown
    assert "capture_s" not in grown
