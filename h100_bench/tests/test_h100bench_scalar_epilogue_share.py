"""The reader of ``scalar_epilogue_share.iter`` and ``.solve`` (``metrics/
scalar_epilogue_share.py``): the program's ``scalar_epilogues.kernel`` over
``scalar_epilogues.kernel + scalar_epilogues.torch``, in %.

* ``None`` where the program has no ``counters``, counts neither counter
  (a tree older than them) or counts both at 0 (a cell that runs no pipe
  step), never 0;
* its two entries, found by name, are counter metrics of the step layer,
  split by the end-to-end metric each band cell moves;
* the harness on the CPU (``tiny``) prints each in a traced run of its
  cell, at 100: every pipe step on the half-band forms its scalars in the
  kernel's entry (its plain version on the CPU); an untraced run prints
  neither.
"""

import json
import sys
import types

import pytest

from conftest import ROOT, run_cell

PROGRAM = "new_cg_variants_tpu_torch.utils.profiling"
ENTRIES = {"scalar_epilogue_share.iter": ("petsc_banded_k32.fixed4000",
                                          "iter_ms"),
           "scalar_epilogue_share.solve": ("petsc_banded_k32.rtol1e-5",
                                           "solves_per_s")}


def _read(monkeypatch, snapshot=None):
    """The reader over a stand-in for the program's profiling module: one
    with ``counters`` answering ``snapshot``, or, given none, one without
    ``counters``."""
    from h100_bench.spec import load_module

    module = types.ModuleType(PROGRAM)
    if snapshot is not None:
        module.counters = lambda: dict(snapshot)
    monkeypatch.setitem(sys.modules, PROGRAM, module)
    reader = load_module(ROOT / "h100_bench" / "metrics"
                         / "scalar_epilogue_share.py")
    return reader.read({})


@pytest.mark.parametrize("snapshot", [
    None, {}, {"solves": 8, "host_syncs": 8},
    {"vector_phases.kernel": 40},
    {"scalar_epilogues.kernel": 0, "scalar_epilogues.torch": 0}])
def test_nothing_counted_reads_none(monkeypatch, snapshot):
    assert _read(monkeypatch, snapshot) is None


@pytest.mark.parametrize("kernel, torch_, share", [
    (40, None, 100.0), (40, 0, 100.0), (None, 8, 0.0), (30, 10, 75.0)])
def test_the_share_of_a_snapshot(monkeypatch, kernel, torch_, share):
    snapshot = {"solves": 8}
    for name, n in (("kernel", kernel), ("torch", torch_)):
        if n is not None:
            snapshot[f"scalar_epilogues.{name}"] = n
    assert _read(monkeypatch, snapshot) == share


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_the_entries_are_the_cells_step_counters(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in spec["per_layer"] if m["name"] == name]
    cell, moves = ENTRIES[name]
    assert m == {"name": name, "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "step",
                 "moves": moves, "workloads": [cell]}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_a_traced_run_of_the_cell_prints_it(tiny, name):
    cell = ENTRIES[name][0]
    rc, line, _ = run_cell(tiny, cell, trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"][name] == {"value": 100.0, "unit": "%"}
    other = [n for n in ENTRIES if n != name]
    assert not set(other) & set(line["metrics"])
    rc, line, _ = run_cell(tiny, cell, trace=0)
    assert rc == 0 and name not in line["metrics"]
