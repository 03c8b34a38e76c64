"""The plain reference against scipy at small sizes, and the program's
input against the reference's formula."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from h100_bench.reference import hpcg_27pt as ref_hpcg
from h100_bench.reference import petsc_banded as ref_band
from h100_bench.reference.linalg import band_matvec, cg, stencil27_matvec

BAND = {"n": 300, "k": 5, "kappa": 1e6, "rho": 0.95, "off_value": 1e-4}


def scipy_band(cfg):
    n, k = cfg["n"], cfg["k"]
    i = np.arange(n)
    diag = 1 + i / (n - 1) * (cfg["kappa"] - 1) * cfg["rho"] ** (n - 1 - i)
    offs = [d for d in range(-(k - 1), k) if d]
    a = sp.diags([np.full(n - abs(d), cfg["off_value"]) for d in offs],
                 offs, shape=(n, n), format="csr")
    return (a + sp.diags(diag)).tocsr()


def scipy_stencil(g):
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(g, g), format="csr")
    return (27.0 * sp.eye(g ** 3, format="csr")
            - sp.kron(sp.kron(t, t), t, format="csr")).tocsr()


def test_band_matvec_matches_scipy():
    a = scipy_band(BAND)
    x = np.random.default_rng(1).standard_normal((BAND["n"], 3))
    got = ref_band.matvec(BAND, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, a @ x, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(
        ref_band.diagonal(BAND, "cpu").numpy(), a.diagonal(), rtol=1e-14)


@pytest.mark.parametrize("g", [1, 2, 5])
def test_stencil27_matches_scipy_kron(g):
    x = np.random.default_rng(g).standard_normal(g ** 3)
    got = stencil27_matvec(g, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, scipy_stencil(g) @ x, atol=1e-12)


def test_permuted_hpcg_matches_scipy_and_program_input():
    from h100_bench.spec import load_module
    from pathlib import Path

    cfg = {"grid": 6, "perm_seed": 2024, "dtype": "float64"}
    p = ref_hpcg.permutation(cfg)
    want = scipy_stencil(6)[p][:, p]
    x = np.random.default_rng(0).standard_normal(216)
    got = ref_hpcg.matvec(cfg, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want @ x, atol=1e-12)
    problem = load_module(Path(__file__).parents[1] / "problems"
                          / "hpcg_27pt.py")
    a = problem.csr(cfg)
    assert a.nnz == problem.nonzeros(cfg) == want.nnz
    assert a.has_sorted_indices
    assert (a != want).nnz == 0


def test_cg_matches_scipy_solution():
    a = scipy_band({**BAND, "kappa": 50.0})
    x_true = np.random.default_rng(3).standard_normal(BAND["n"])
    b = a @ x_true
    mv = ref_band.matvec({**BAND, "kappa": 50.0}, "cpu")
    x, k = cg(mv, torch.from_numpy(b), 500, rtol=1e-12)
    np.testing.assert_allclose(x.numpy(), spla.spsolve(a.tocsc(), b),
                               rtol=1e-9, atol=1e-9)
    assert k < 500
    x4, k4 = cg(mv, torch.from_numpy(b), 4)
    assert k4 == 4 and not np.allclose(x4.numpy(), x_true, atol=1e-6)


def test_band_matvec_blocks_and_low_precision():
    x = torch.randn(BAND["n"], 4, dtype=torch.float64)
    mv = ref_band.matvec(BAND, "cpu")
    cols = torch.stack([mv(x[:, j]) for j in range(4)], 1)
    assert torch.equal(mv(x), cols)
    low = ref_band.matvec(BAND, "cpu", torch.bfloat16)(x.bfloat16())
    assert low.dtype == torch.bfloat16
    d = band_matvec(torch.ones(3), 0.5, 2, torch.ones(3))
    assert d.tolist() == [1.5, 2.0, 1.5]
