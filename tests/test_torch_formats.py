"""Port parity: the format layer of ``ops/operators`` (the ``build_*`` host
builders, ``choose_format``, ``from_coo``, ``as_operator``) against the JAX
package's.

Matrices are made with numpy from a seed and handed to both packages as
their own ``CooMatrix`` (the same arrays) or as one scipy matrix.  The host
arrays agree bit for bit; the policy picks the same format; each operator's
products agree to rtol 1e-13 of the row's scale in float64.  Two rules of
the port differ from the JAX package on purpose (faults of the reference):
``fmt="symdia"`` refuses a matrix that is not symmetric, and the
block-banded admission scales by the type actually stored.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from new_cg_variants_tpu.matio.matrix_market import CooMatrix as JaxCoo
from new_cg_variants_tpu.ops import operators as jo
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.ops import operators as to
from new_cg_variants_tpu_torch.ops.block_banded import (
    PermutedBlockBandedOperator,
)
from new_cg_variants_tpu_torch.ops.stencil import BandedStencilOperator
from new_cg_variants_tpu_torch.ops.sym_dia import SymDiaOperator

RTOL = 1e-13


def both(row, col, val, n):
    """The same entries as the JAX package's and the port's CooMatrix."""
    row, col = np.asarray(row, np.int64), np.asarray(col, np.int64)
    val = np.asarray(val, np.float64)
    return (JaxCoo((n, n), row, col, val),
            port.CooMatrix((n, n), row.copy(), col.copy(), val.copy()))


def from_scipy(a):
    c = sp.coo_matrix(a)
    return both(c.row, c.col, c.data, a.shape[0])


def duplicates_and_empty_rows(n=60, seed=0):
    """Unsorted random entries, repeated (row, col) pairs, empty rows, a
    negative zero."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, 300)
    row[np.isin(row, (3, 17, 59))] = 4
    col = rng.integers(0, n, 300)
    row = np.concatenate([row, [5, 5, 5]])
    col = np.concatenate([col, [9, 9, 9]])
    val = np.concatenate([rng.standard_normal(300), [1.0, -0.0, 2.5]])
    return both(row, col, val, n)


def diagonal_only(n=40):
    return both(np.arange(n), np.arange(n), np.arange(1.0, n + 1.0), n)


def symmetric_band(n=700, k=5, seed=1):
    rng = np.random.default_rng(seed)
    a = sp.diags([rng.uniform(-1, 1, n - abs(o)) for o in range(-k, k + 1)],
                 list(range(-k, k + 1)), shape=(n, n)).tocsr()
    return (a + a.T + 4 * k * sp.eye(n)).tocsr()


def asymmetric_band(n=700, seed=2):
    rng = np.random.default_rng(seed)
    return sp.diags([rng.uniform(-1, 1, n - abs(o)) for o in (-3, 0, 2)],
                    [-3, 0, 2], shape=(n, n)).tocsr() + 10 * sp.eye(n)


def constant_band(n=700, k=6):
    """diag + one constant off-band at |i - j| < k: the PETSc model
    structure (the stencil route)."""
    d = np.linspace(1.0, 50.0, n)
    offs = [o for o in range(-(k - 1), k) if o]
    return (sp.diags(d) + sp.diags([np.full(n - abs(o), 0.01) for o in offs],
                                   offs, shape=(n, n))).tocsr()


def permuted_laplacian(m=30, seed=3):
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
    a = (sp.kronsum(t, t) + 0.1 * sp.eye(m * m)).tocsr()
    p = np.random.default_rng(seed).permutation(m * m)
    return a[p][:, p].tocsr()


def irreducible(n=4096, per_row=6, seed=0):
    """The JAX package's ``test_auto_route._random_irreducible_coo``:
    uniformly random pattern, symmetrised, diagonally dominant."""
    rng = np.random.default_rng(seed)
    col = rng.integers(0, n, size=(n, per_row)).ravel()
    row = np.repeat(np.arange(n), per_row)
    rows = np.concatenate([row, col, np.arange(n)])
    cols = np.concatenate([col, row, np.arange(n)])
    vals = np.concatenate([np.full(2 * n * per_row, 0.01),
                           np.full(n, float(2 * per_row))])
    return both(rows, cols, vals, n)


CASES = {
    "duplicates and empty rows": duplicates_and_empty_rows,
    "diagonal only (L = 1)": diagonal_only,
    "symmetric band": lambda: from_scipy(symmetric_band()),
    "irreducible": irreducible,
}


@pytest.mark.parametrize("case", list(CASES))
def test_builders_match_jax_bit_for_bit(case):
    jc, tc = CASES[case]()
    np.testing.assert_array_equal(to.build_dense(tc), jo.build_dense(jc))
    for build in ("build_dia", "build_sym_dia"):
        (jo_offs, jd), (to_offs, td) = (getattr(jo, build)(jc),
                                        getattr(to, build)(tc))
        assert to_offs == jo_offs
        np.testing.assert_array_equal(td, jd)
    jv, ji, jn = jo.build_ell(jc)
    tv, ti, tn = to.build_ell(tc)
    assert tn == jn == len(tc.val)
    assert tv.shape == jv.shape and ti.dtype == np.int32
    # bit for bit, -0.0 stored as 0.0 as the JAX loop stores it
    np.testing.assert_array_equal(tv.view(np.int64), jv.view(np.int64))
    np.testing.assert_array_equal(ti, ji)


def test_build_ell_slot_rules():
    """Stable (row, col) order; a duplicate takes a slot of its own; padding
    holds 0 at index i; L = max(1, longest row); nnz counts every entry."""
    jc, tc = both([2, 0, 2, 2, 0], [1, 3, 1, 0, 0], [1.0, 2.0, 3.0, 4.0, 5.0],
                  4)
    val, idx, nnz = to.build_ell(tc)
    assert nnz == 5 and val.shape == (4, 3)
    np.testing.assert_array_equal(idx, [[0, 3, 0], [1, 1, 1], [0, 1, 1],
                                        [3, 3, 3]])
    np.testing.assert_array_equal(val, [[5.0, 2.0, 0.0], [0.0, 0.0, 0.0],
                                        [4.0, 1.0, 3.0], [0.0, 0.0, 0.0]])
    assert to.build_ell(port.CooMatrix((3, 3), np.zeros(0, np.int64),
                                       np.zeros(0, np.int64),
                                       np.zeros(0)))[0].shape == (3, 1)


ROUTES = {
    "dense": (lambda: from_scipy(symmetric_band(n=300)), {}),
    "dia": (lambda: from_scipy(asymmetric_band()), {}),
    "symdia": (lambda: from_scipy(symmetric_band()), {}),
    "stencil": (lambda: from_scipy(constant_band()), {}),
    "block_banded": (lambda: from_scipy(permuted_laplacian()), {}),
    "ell": (irreducible, {"max_padded_values": 1_000_000}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_choose_format_matches_jax(route):
    make, kw = ROUTES[route]
    jc, tc = make()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = to.choose_format(tc, **kw)
    assert got == jo.choose_format(jc, **kw) == route
    warned = [str(c.message) for c in caught]
    if route == "ell":
        assert any("gather-ELL" in m for m in warned)
        assert not any("/s" in m or "TPU" in m for m in warned)
    else:
        assert not warned


def _mv_close(top, jop, n, seed=0):
    rng = np.random.default_rng(seed)
    v, w = rng.standard_normal((2, n))
    y = top.mv(torch.from_numpy(v)).numpy()
    jy = np.asarray(jop.mv(jnp.asarray(v)))
    scale = np.abs(jy).max() + 1.0
    np.testing.assert_allclose(y, jy, rtol=RTOL, atol=RTOL * scale)
    y2, z2 = top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    jy2, jz2 = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(z2.numpy(), np.asarray(jz2), rtol=RTOL,
                               atol=RTOL * scale)


FMT_KIND = {"dense": to.DenseOperator, "dia": to.DiaOperator,
            "symdia": SymDiaOperator, "stencil": BandedStencilOperator,
            "block_banded": PermutedBlockBandedOperator,
            "ell": to.EllOperator}


#: a matrix each format takes (a permuted grid has hundreds of diagonals:
#: too many for the JAX package's DIA product to compile quickly)
FMT_MATRIX = {"dense": lambda: permuted_laplacian(m=16),
              "dia": lambda: asymmetric_band(n=600),
              "symdia": lambda: symmetric_band(n=600),
              "stencil": lambda: constant_band(n=600),
              "block_banded": lambda: permuted_laplacian(m=24),
              "ell": lambda: permuted_laplacian(m=24),
              "auto": lambda: constant_band(n=600)}


@pytest.mark.parametrize("fmt", list(FMT_MATRIX))
def test_from_coo_every_fmt_matches_jax(fmt):
    a = FMT_MATRIX[fmt]()
    jc, tc = from_scipy(a)
    top = to.from_coo(tc, fmt=fmt, device="cpu")
    jop = jo.from_coo(jc, fmt=fmt, dtype=jnp.float64)
    assert isinstance(top, FMT_KIND.get(fmt, BandedStencilOperator))
    assert type(top).__name__ == type(jop).__name__
    assert (top.n, top.dtype, top.device.type) == (a.shape[0], torch.float64,
                                                   "cpu")
    _mv_close(top, jop, a.shape[0])
    np.testing.assert_allclose(top.diagonal().numpy(),
                               np.asarray(jop.diagonal()), rtol=0, atol=0)
    np.testing.assert_array_equal(top.tocsr().toarray(), a.toarray())
    f32 = top.astype(torch.float32)
    assert f32.dtype == torch.float32 and type(f32) is type(top)


def test_from_coo_takes_numpy_and_torch_dtypes():
    jc, tc = from_scipy(asymmetric_band())
    for dt in (np.float32, torch.float32):
        assert to.from_coo(tc, fmt="dia", dtype=dt,
                           device="cpu").dtype == torch.float32
    with pytest.raises(ValueError, match="unknown format"):
        to.from_coo(tc, fmt="csr", device="cpu")


@pytest.mark.parametrize("kind", ["csr", "csc", "coo", "CooMatrix"])
def test_as_operator_takes_scipy_and_coo(kind):
    a = permuted_laplacian(m=24)
    given = (to.coo_from_scipy(a) if kind == "CooMatrix"
             else a.asformat(kind))
    jgiven = jo.coo_from_scipy(a) if kind == "CooMatrix" else given
    top = to.as_operator(given, device="cpu")
    jop = jo.as_operator(jgiven)
    assert isinstance(top, PermutedBlockBandedOperator)
    assert type(jop).__name__ == "PermutedBlockBandedOperator"
    assert top.dtype == torch.float64
    _mv_close(top, jop, a.shape[0])
    assert to.as_operator(given, dtype=torch.float32,
                          device="cpu").dtype == torch.float32


def test_coo_from_scipy_matches_jax():
    a = sp.random(50, 50, density=0.1, random_state=4, format="csc")
    j, t = jo.coo_from_scipy(a), to.coo_from_scipy(a)
    assert isinstance(t, port.CooMatrix) and t.shape == j.shape == (50, 50)
    for field in ("row", "col", "val"):
        got, want = getattr(t, field), getattr(j, field)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_symdia_refuses_a_matrix_that_is_not_symmetric():
    """Reference fault: the JAX package's ``from_coo(fmt="symdia")`` drops the
    lower triangle of any matrix without a check.  The port raises."""
    jc, tc = from_scipy(asymmetric_band())
    with pytest.raises(ValueError, match="symmetric"):
        to.from_coo(tc, fmt="symdia", device="cpu")
    jop = jo.from_coo(jc, fmt="symdia", dtype=jnp.float64)  # no check there
    assert jop.n == 700
    ok = to.from_coo(from_scipy(symmetric_band())[1], fmt="symdia",
                     device="cpu")
    assert isinstance(ok, SymDiaOperator)


def test_stencil_fmt_refuses_a_band_that_is_not_constant():
    jc, tc = from_scipy(symmetric_band())
    with pytest.raises(ValueError, match="stencil"):
        to.from_coo(tc, fmt="stencil", device="cpu")
    with pytest.raises(ValueError, match="stencil"):
        jo.from_coo(jc, fmt="stencil")


def test_block_banded_admission_scales_by_the_stored_type():
    """Reference fault: the JAX package scales its block-banded admission by
    the itemsize of the type ``from_coo`` was asked for, not of what it
    stores.  Here the admission holds for float32 storage and fails for
    float64 at a budget between the two, and ``from_coo`` routes by the
    dtype it stores."""
    jc, tc = from_scipy(permuted_laplacian(m=24))  # bw 24: bs 128, n_pad 640
    padded = 3 * 128 * 640
    budget = padded + padded // 2  # in float32 values: f32 fits, f64 not
    assert to.choose_format(tc, max_padded_values=budget,
                            dtype=torch.float32) == "block_banded"
    with pytest.warns(UserWarning, match="gather-ELL"):
        assert to.choose_format(tc, max_padded_values=budget,
                                dtype=torch.float64) == "ell"
    assert to.choose_format(tc, max_padded_values=budget,
                            dtype=np.float32) == "block_banded"
    assert to.choose_format(tc, max_padded_values=budget) == jo.choose_format(
        jc, max_padded_values=budget) == "block_banded"


def test_ell_route_needs_no_block_banded_budget_overflow():
    """The admission is computed in Python integers: at the sizes of a chip
    run (band 32,137 at n = 1,124,864) an int32 product would overflow."""
    bs, n_pad = 32_256, 1_128_960
    assert 3 * bs * n_pad * 4 > 2 ** 31
    jc, tc = irreducible(n=2048)
    with pytest.warns(UserWarning):
        assert to.choose_format(tc, max_padded_values=10) == "ell"
    assert isinstance(to.choose_format(tc), str)
