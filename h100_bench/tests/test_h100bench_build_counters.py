"""The readers of the operator build's and the solver basis's counters
(``metrics/_counted.py`` and ``format_s``, ``rcm_s``, ``ell_pack_s``,
``basis_moves_per_solve``).

* Each reader gives ``None`` where the program has no ``counters`` or has
  not counted its counter (a tree older than them), never 0, and its
  counter's value (or its ratio to ``solves``) on a snapshot.
* Their entries are counter metrics of ``hpcg_27pt_104_perm.fixed50``
  alone.
* The harness on the CPU (``tiny``, grid 12, where the auto route picks
  block-banded storage) prints them in a traced run of that cell, and
  none in an untraced one.
"""

import json
import sys
import types

import pytest

from conftest import ROOT, run_cell

PROGRAM = "new_cg_variants_tpu_torch.utils.profiling"
CELL = "hpcg_27pt_104_perm.fixed50"
#: reader -> counter
VALUES = {"format_s": "format_s", "rcm_s": "rcm_s",
          "ell_pack_s": "ell.pack_s"}
SNAPSHOT = {"solves": 8, "basis_moves": 24, "format_s": 2.5,
            "rcm_s": 3.25, "ell.pack_s": 0.75, "host_syncs": 8}
READERS = sorted(VALUES) + ["basis_moves_per_solve"]


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


@pytest.mark.parametrize("stem", READERS)
def test_no_counters_no_reading(monkeypatch, stem):
    _program(monkeypatch)
    assert _reader(stem).read({}) is None


@pytest.mark.parametrize("stem", READERS)
def test_a_program_without_the_counter_reads_none(monkeypatch, stem):
    """The parent of the counters counts solves and syncs, not these."""
    _program(monkeypatch, {"solves": 8, "host_syncs": 8, "replays": 40})
    assert _reader(stem).read({}) is None
    _program(monkeypatch, {})
    assert _reader(stem).read({}) is None


@pytest.mark.parametrize("stem", sorted(VALUES))
def test_the_value_of_a_snapshot(monkeypatch, stem):
    _program(monkeypatch, SNAPSHOT)
    assert _reader(stem).read({}) == SNAPSHOT[VALUES[stem]]
    _program(monkeypatch, {VALUES[stem]: 0.0})
    assert _reader(stem).read({}) == 0.0


def test_basis_moves_over_solves(monkeypatch):
    reader = _reader("basis_moves_per_solve")
    _program(monkeypatch, SNAPSHOT)
    assert reader.read({}) == 3.0
    _program(monkeypatch, {"basis_moves": 3})
    assert reader.read({}) is None
    _program(monkeypatch, {"solves": 0, "basis_moves": 0})
    assert reader.read({}) is None


def test_the_entries_are_the_cells_counter_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    ours = {m["name"]: m for m in spec["per_layer"] if m["name"] in READERS}
    assert sorted(ours) == sorted(READERS)
    for name, m in ours.items():
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert m["workloads"] == [CELL]
        assert m["moves"] == ("iter_ms" if name == "basis_moves_per_solve"
                              else "setup_s")
    assert CELL in {w["name"] for w in spec["workloads"]}


def test_a_traced_run_of_the_cell_prints_them(tiny):
    rc, line, _ = run_cell(tiny, CELL, trace=1)
    assert rc == 0 and line["correct"] is True
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    # b and x0 into the block-banded basis, x out of it, each call
    assert metrics["basis_moves_per_solve"] == 3.0
    # (process totals: other tests' builds may be in them)
    assert 0 < metrics["format_s"] and 0 < metrics["rcm_s"]
    assert "ell_pack_s" not in metrics  # no ELL below the cell's size
    rc, line, _ = run_cell(tiny, CELL, trace=0)
    assert rc == 0 and not set(READERS) & set(line["metrics"])
