"""The step's byte counts against hand counts."""

from pathlib import Path

import pytest

from h100_bench import roofline
from h100_bench.spec import load_module

PROBLEMS = Path(__file__).parents[1] / "problems"


def test_half_band_step_reproduces_row_2_bound():
    # 32 diagonals of 655,360 rows less the 0+1+...+31 past the edge, 4
    # bytes each; 6 vectors read and 6 written, 4 bytes a value
    band = load_module(PROBLEMS / "petsc_banded.py")
    cfg = {"n": 655_360, "k": 32, "dtype": "float32"}
    assert band.operator_bytes(cfg) == (32 * 655_360 - 496) * 4
    step = roofline.step_bytes("pipe_pr_cg", 655_360,
                               band.operator_bytes(cfg), 4)
    assert step == 83_884_096 + 31_457_280
    assert step / roofline.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        0.0344, abs=5e-5)


def test_ell_step_hand_count():
    # HPCG 104^3: 310^3 stored entries, 4-byte value and 4-byte index each;
    # 12 vectors of 1,124,864 float32 values
    ell = load_module(PROBLEMS / "hpcg_27pt.py")
    cfg = {"grid": 104, "dtype": "float32"}
    assert ell.nonzeros(cfg) == 29_791_000
    step = roofline.step_bytes("pipe_pr_cg", 104 ** 3,
                               ell.operator_bytes(cfg), 4)
    assert step == 29_791_000 * 8 + 12 * 1_124_864 * 4 == 292_321_472
    # row 12's ell_spmv2 bound (0.0779 ms: n L (4 + 4) + 4 n 4) plus
    # row 4's vector phase scaled to this n (11 n 4) reads st and rt twice
    # and the padding slots; the step's own work is below their sum
    ms = step / roofline.HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(0.08726, abs=1e-5)
    two_kernels = (104 ** 3 * 27 * 8 + 4 * 104 ** 3 * 4
                   + 11 * 104 ** 3 * 4) / roofline.HBM_BYTES_PER_S * 1e3
    assert two_kernels == pytest.approx(0.093, abs=1e-3) and ms < two_kernels


def test_unknown_variant_has_no_count():
    with pytest.raises(KeyError):
        roofline.step_bytes("hs_cg", 10, 0, 4)
