"""``correct`` comes out false when the timed path is broken underneath,
and when the control (the reference CG one precision lower) stands in the
program's place.

The run is driven on the CPU at a tiny size with the cell's own limits.
The faults that a solve cell can have: a step that returns its state
unchanged; an answer altered where it is produced (scaled by 1%, or its
entries one place out of order).  A cell has no batch to halve and, on
one card, no exchange between cards to leave out.
"""

import json

import pytest
import torch

from conftest import ROOT, make_tiny, run_cell

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _patch_solve(monkeypatch, alter):
    import new_cg_variants_tpu_torch as cgt

    solve = cgt.solve

    def broken(*args, **kwargs):
        res = solve(*args, **kwargs)
        res.x = alter(res.x)
        return res

    monkeypatch.setattr(cgt, "solve", broken)


FAULTS = {
    "state_unchanged": None,
    "answer_scaled": lambda x: x * 1.01,
    # the answer's entries one place out of order, as a scatter back to
    # the original numbering that misses by one would leave them
    "answer_out_of_order": lambda x: x.roll(1),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_fails(tiny, monkeypatch, workload, fault):
    if fault == "state_unchanged":
        from new_cg_variants_tpu_torch.solvers import families

        init, _ = families.FAMILIES["pipe_pr"]
        monkeypatch.setitem(families.FAMILIES, "pipe_pr",
                            (init, lambda ctx, s: dict(s, k=s["k"] + 1)))
    else:
        _patch_solve(monkeypatch, FAULTS[fault])
    rc, line, err = run_cell(tiny, workload, seconds=0.5)
    assert rc == 0
    assert line["correct"] is False and line["failed"] >= 1, err[-3:]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, workload):
    rc, line, _ = run_cell(tiny, workload, seconds=0.5)
    assert rc == 0 and line["correct"] is True


def _control(root, workload, device, seeds):
    from h100_bench import calibrate
    from h100_bench.spec import Cell

    cell = Cell(root, workload)
    call = calibrate.control_call(cell, torch.device(device))
    return [calibrate.readings(cell, s, call, torch.device(device),
                               int(cell.mix["sample"])) for s in seeds]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(tiny, workload):
    for rec in _control(tiny, workload, "cpu", [11, 2**31 + 12]):
        assert rec["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for rec in _control(ROOT, workload, "cuda", [101, 102, 103]):
        assert rec["correct"] is False
