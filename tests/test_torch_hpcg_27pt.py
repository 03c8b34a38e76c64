"""The port on HPCG's 27-point operator against the benchmark's plain
reference (``h100_bench/reference/``), at grid 12 (n = 1728) under the
configuration's random numbering (``perm_seed``), on the CPU.

The benchmark's cell ``hpcg_27pt_104_perm.fixed50`` hands the matrix to
``as_operator`` as scipy CSR, and at 104^3 the auto route takes ELL in
RCM order.  At grid 12 the RCM band is narrow enough that the auto route
packs it block-banded instead, so these tests build the ELL operator with
``fmt="ell"``, the cell's format:

* in float64 its product is the reference's to 1e-13 (relative);
* a float32 ``solve(pipe_pr_cg, norm_type="none", max_iter=50)`` on it,
  judged by the cell's own checks (``iterations``, ``residual``,
  ``cg_gap`` against float64 plain CG) at the cell's limits, passes; the
  cell's control, the plain CG in bfloat16, fails;
* the benchmark's package imports in the test process itself.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from new_cg_variants_tpu_torch import solve
from new_cg_variants_tpu_torch.ops.operators import (
    EllOperator,
    choose_format,
    coo_from_scipy,
    from_coo,
)

ROOT = Path(__file__).resolve().parents[1]
CELL = "hpcg_27pt_104_perm.fixed50"
GRID = 12
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def cell():
    """The benchmark's cell, its configuration cut to grid 12."""
    from h100_bench.spec import Cell

    c = Cell(ROOT, CELL)
    c.config = dict(c.config, grid=GRID)
    return c


@pytest.fixture(scope="module")
def coo(cell):
    return coo_from_scipy(cell.problem().csr(cell.config))


def test_the_benchmark_imports_here(cell):
    import h100_bench
    from h100_bench import harness, traffic  # noqa: F401

    assert Path(h100_bench.__file__).parent == ROOT / "h100_bench"
    assert cell.config["perm_seed"] is not None
    assert cell.config["dtype"] == "float32"
    assert cell.limits == json.loads(
        (ROOT / "h100_bench" / "limits" / f"{CELL}.json").read_text())
    assert cell.mix["max_iter"] == 50 and cell.mix["norm_type"] == "none"


def test_below_the_cells_size_auto_packs_block_banded(coo):
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no ELL fallback here
        assert choose_format(coo, dtype=torch.float32) == "block_banded"


def test_the_ell_product_is_the_references(cell, coo):
    op = from_coo(coo, fmt="ell", dtype=torch.float64, device="cpu")
    assert isinstance(op, EllOperator) and op.perm is not None
    mv = cell.reference().matvec(cell.config, "cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal(GRID ** 3))
        want = mv(x)
        got = op.mv(x)
        assert float(torch.linalg.vector_norm(got - want)
                     / torch.linalg.vector_norm(want)) <= 1e-13
        y = torch.from_numpy(rng.standard_normal(GRID ** 3))
        g1, g2 = op.mv2(x, y)
        assert float(torch.linalg.vector_norm(g2 - mv(y))
                     / torch.linalg.vector_norm(mv(y))) <= 1e-13
        assert float(torch.linalg.vector_norm(g1 - want)
                     / torch.linalg.vector_norm(want)) <= 1e-13


def _judged(cell, call, calls=4):
    """The harness's comparison of ``calls`` answers of ``call`` on the
    seed's right-hand sides: ``(checks, failed calls, correct)``."""
    from h100_bench import traffic
    from h100_bench.harness import judge

    n = GRID ** 3
    reference = cell.reference()
    pool = traffic.rhs_pool(SEED, n, calls, reference.matvec(cell.config,
                                                             "cpu"),
                            torch.float32, torch.device("cpu"))
    recs, answers = [], {}
    for i in range(calls):
        res = call(pool[i])
        recs.append({"i": i, "iterations": int(res.iterations),
                     "converged": bool(res.converged)})
        answers[i] = res.x
    return judge(cell, reference, SEED, recs, answers, n, calls,
                 torch.device("cpu"))


def test_the_program_passes_the_cells_checks(cell, coo):
    op = from_coo(coo, fmt="ell", dtype=torch.float32, device="cpu")
    mix = cell.mix
    checks, bad, correct = _judged(cell, lambda b: solve(
        op, b, variant=mix["variant"], norm_type=mix["norm_type"],
        max_iter=mix["max_iter"], device="cpu"))
    assert correct and not bad, checks
    assert checks["iterations"]["value"] == 0
    assert checks["residual"]["limit"] == 5e-4
    assert checks["cg_gap"]["limit"] == 2e-4
    assert checks["residual"]["value"] <= 5e-4
    assert checks["cg_gap"]["value"] <= 2e-4


def test_the_bfloat16_control_fails_them(cell):
    from h100_bench.calibrate import control_call

    assert cell.config["control"] == "reference"
    checks, bad, correct = _judged(cell, control_call(
        cell, torch.device("cpu")))
    assert not correct and bad, checks
    assert (checks["residual"]["value"] > 5e-4
            or checks["cg_gap"]["value"] > 2e-4)
