"""The reader of ``vector_kernel_share.iter`` (``metrics/
vector_kernel_share.py``): the program's ``vector_phases.kernel`` over
``vector_phases.kernel + vector_phases.generic``, in %.

* ``None`` where the program has no ``counters``, counts neither counter
  (a tree older than them) or counts both at 0 (a cell whose whole-step
  kernels build no vector phase), never 0;
* its entry, found by name, is a counter metric of the step layer in
  ``hpcg_27pt_104_perm.fixed50`` alone;
* the harness on the CPU (``tiny``) prints it in a traced run of that
  cell, at 100: every step's vector phase is the kernel's entry.
"""

import json
import sys
import types

import pytest

from conftest import ROOT, run_cell

PROGRAM = "new_cg_variants_tpu_torch.utils.profiling"
CELL = "hpcg_27pt_104_perm.fixed50"
NAME = "vector_kernel_share.iter"


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
                         / "vector_kernel_share.py")
    return reader.read({})


@pytest.mark.parametrize("snapshot", [
    None, {}, {"solves": 8, "host_syncs": 8},
    {"vector_phases.kernel": 0, "vector_phases.generic": 0}])
def test_nothing_counted_reads_none(monkeypatch, snapshot):
    assert _read(monkeypatch, snapshot) is None


@pytest.mark.parametrize("kernel, generic, share", [
    (40, None, 100.0), (40, 0, 100.0), (None, 8, 0.0), (30, 10, 75.0)])
def test_the_share_of_a_snapshot(monkeypatch, kernel, generic, share):
    snapshot = {"solves": 8}
    for name, n in (("kernel", kernel), ("generic", generic)):
        if n is not None:
            snapshot[f"vector_phases.{name}"] = n
    assert _read(monkeypatch, snapshot) == share


def test_the_entry_is_the_cells_step_counter():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "step",
                 "moves": "iter_ms", "workloads": [CELL]}


def test_a_traced_run_of_the_cell_prints_it(tiny):
    rc, line, _ = run_cell(tiny, CELL, trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"][NAME] == {"value": 100.0, "unit": "%"}
    rc, line, _ = run_cell(tiny, CELL, trace=0)
    assert rc == 0 and NAME not in line["metrics"]
