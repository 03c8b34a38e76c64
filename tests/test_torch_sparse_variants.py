"""Port parity, end to end: general sparse input.

The CG variants on the three operator kinds this slice adds (padded ELL, the
constant-band stencil, the reordered block-banded packing), scipy and
``CooMatrix`` input through the auto route, and the double-word mode on an
ELL inner, against the JAX package on the same float64 problems made with
numpy:

* nu and alpha histories over 25 iterations to rtol 1e-10, one name per
  family and a Jacobi ``_pcg`` name on each kind;
* ``run`` with ``save_x`` through a permuted block-banded operator returns
  its rows in the original order, as the JAX package's;
* ``solve`` under each norm type;
* ``df_operator`` picks the formats the JAX package picks, and the f32x2
  histories on an ELL inner agree (bit for bit: both take the same
  roundings).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import new_cg_variants_tpu as cgt
from new_cg_variants_tpu.matio import problems as jp
from new_cg_variants_tpu.matio.matrix_market import CooMatrix as JaxCoo
from new_cg_variants_tpu.ops import doublefloat as jdf
from new_cg_variants_tpu.ops import operators as jo
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.ops import doublefloat as tdf
from new_cg_variants_tpu_torch.ops import operators as to

ITERS = 25
RTOL = 1e-10
NAMES = ("hs_cg", "cg_cg", "gv_cg", "pr_cg", "m_cg", "pipe_p_cg",
         "pipe_pr_cg", "pipe_pr_m_cg", "pipe_pr_pcg")


def both(a):
    c = sp.coo_matrix(a)
    row, col = c.row.astype(np.int64), c.col.astype(np.int64)
    return (JaxCoo(a.shape, row, col, c.data),
            port.CooMatrix(a.shape, row.copy(), col.copy(), c.data.copy()))


def permuted(a, seed=0):
    p = np.random.default_rng(seed).permutation(a.shape[0])
    return a[p][:, p].tocsr()


def grid9(m=24):
    """The 9-point operator of an m x m grid (diagonal 8, -1 to each
    neighbour, kappa near 60 at m = 24), permuted."""
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(m, m))
    return permuted((9.0 * sp.eye(m * m) - sp.kron(t, t)).tocsr())


def laplacian(m=20, shift=0.01):
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
    return permuted((sp.kronsum(t, t) + shift * sp.eye(m * m)).tocsr(), 1)


def _ell():
    a = grid9()
    jc, tc = both(a)
    return (jo.from_coo(jc, fmt="ell", dtype=jnp.float64),
            to.from_coo(tc, fmt="ell", device="cpu"), a @ np.ones(a.shape[0]))


def _block_banded():
    a = laplacian()
    jc, tc = both(a)
    return (jo.from_coo(jc, fmt="block_banded", dtype=jnp.float64),
            to.from_coo(tc, fmt="block_banded", device="cpu"),
            a @ np.ones(a.shape[0]))


def _stencil(prec):
    # Jacobi on the model problem converges within six iterations; the
    # preconditioned name runs on a band of -0.16 (1 + 6 c = 0.04)
    kw = (dict(off_value=-0.16, kappa=10.0) if prec else dict(kappa=100.0))
    jop, b, _ = jp.banded_model(512, k=4, fmt="stencil", **kw)
    top, _, _ = port.banded_model(512, k=4, fmt="stencil", device="cpu", **kw)
    return jop, top, b


@pytest.fixture(scope="module")
def problems():
    return {"ell": _ell(), "block_banded": _block_banded(),
            "stencil": _stencil(False), "stencil jacobi": _stencil(True)}


def _histories(jA, tA, b, name, **kw):
    kw = dict(max_iter=ITERS + 1, probes=("nu", "alpha"),
              preconditioner="jacobi" if name.endswith("pcg") else None, **kw)
    return (cgt.run(name, jA, b, **kw),
            port.run(name, tA, b, device="cpu", **kw))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["ell", "stencil", "block_banded"])
def test_histories_match_jax(problems, kind, name):
    if kind == "stencil" and name.endswith("pcg"):
        kind = "stencil jacobi"
    jop, top, b = problems[kind]
    want, got = _histories(jop, top, b, name, dtype=np.float64)
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL)
    assert got["nu"][-1] < 1e-3 * got["nu"][0]  # it iterates
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=1e-8, atol=1e-10)


def test_save_x_through_a_permuted_operator_is_in_original_order(problems):
    jop, top, b = problems["block_banded"]
    kw = dict(max_iter=12, probes=("save_x", "save_r", "nu"))
    want = cgt.run("pipe_pr_cg", jop, b, dtype=np.float64, **kw)
    got = port.run("pipe_pr_cg", top, b, device="cpu", **kw)
    assert got["save_x"].shape == (12, top.n) == np.asarray(
        want["save_x"]).shape
    for p in ("save_x", "save_r"):
        np.testing.assert_allclose(got[p], np.asarray(want[p]), rtol=1e-9,
                                   atol=1e-12)
    # original order: the iterate's residual in the original system
    a = top.tocsr()
    x = got["x"].numpy()
    np.testing.assert_allclose(got["save_x"][-1], x)
    r = b - a @ x
    assert np.linalg.norm(r) < np.linalg.norm(b)
    np.testing.assert_allclose(got["save_r"][-1], r, rtol=1e-8,
                               atol=1e-10 * np.linalg.norm(b))


def test_error_probes_through_a_permuted_operator(problems):
    jop, top, b = problems["block_banded"]
    x_true = np.ones(top.n)
    kw = dict(max_iter=10, probes=("error_A_norm", "residual_2_norm"))
    want = cgt.run("pr_cg", jop, b, x_true=x_true, dtype=np.float64, **kw)
    got = port.run("pr_cg", top, b, x_true=x_true, device="cpu", **kw)
    auto = port.run("pr_cg", top, b, device="cpu", **kw)  # x_true solved for
    for p in kw["probes"]:
        np.testing.assert_allclose(got[p], np.asarray(want[p]), rtol=1e-9)
        np.testing.assert_allclose(auto[p], got[p], rtol=1e-8)


@pytest.mark.parametrize("norm_type", ["natural", "unpreconditioned",
                                       "preconditioned", "none"])
def test_solve_under_each_norm_type_matches_jax(problems, norm_type):
    jop, top, b = problems["block_banded"]
    kw = dict(variant="pipe_pr_pcg", preconditioner="jacobi", rtol=1e-8,
              max_iter=60 if norm_type == "none" else 2000,
              norm_type=norm_type)
    want = cgt.solve(jop, b, dtype=np.float64, **kw)
    got = port.solve(top, b, device="cpu", **kw)
    assert got.iterations == want.iterations and got.converged == \
        want.converged
    assert got.x.shape == (top.n,)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8,
                               atol=1e-10)
    if norm_type != "none":
        np.testing.assert_allclose(got.x.numpy(), np.ones(top.n), rtol=1e-5)


@pytest.mark.parametrize("given", ["csr", "csc", "CooMatrix"])
@pytest.mark.parametrize("matrix", ["block_banded", "stencil"])
def test_run_and_solve_take_scipy_and_coo(matrix, given):
    """The auto route inside ``run`` and ``solve``: a permuted grid goes to
    the block-banded packing, a constant band to the stencil."""
    if matrix == "block_banded":
        a = laplacian(m=30, shift=0.05)
    else:
        jst, _, _ = jp.banded_model(700, k=5, kappa=100.0, fmt="stencil")
        a = jst.tocsr()
    jc, tc = both(a)
    jA, tA = (jc, tc) if given == "CooMatrix" else (a.asformat(given),) * 2
    b = a @ np.ones(a.shape[0])
    assert type(to.as_operator(tA, device="cpu")).__name__ == type(
        jo.as_operator(jA)).__name__ == {
            "block_banded": "PermutedBlockBandedOperator",
            "stencil": "BandedStencilOperator"}[matrix]
    want, got = _histories(jA, tA, b, "pipe_pr_cg", dtype=np.float64)
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL)
    res = port.solve(tA, b, rtol=1e-10, device="cpu")
    ref = cgt.solve(jA, b, rtol=1e-10, dtype=np.float64)
    assert res.converged and res.iterations == ref.iterations
    np.testing.assert_allclose(res.x.numpy(), np.ones(a.shape[0]), rtol=1e-6)


def _df_route(matrix):
    if matrix == "dense":
        return laplacian(m=20)                      # n = 400
    if matrix == "dia":
        rng = np.random.default_rng(2)
        return (sp.diags([rng.uniform(-1, 1, 700 - abs(o)) for o in (-3, 2)],
                         [-3, 2], shape=(700, 700)) + 10 * sp.eye(700)).tocsr()
    if matrix == "symdia":
        return jp.banded_model(700, k=5, kappa=1e3, fmt="dia")[0].tocsr() \
            + sp.diags(np.linspace(0, 1, 700))
    if matrix == "stencil":
        return jp.banded_model(700, k=5, kappa=1e3, fmt="stencil")[0].tocsr()
    return laplacian(m=24)                          # block-banded, n = 576


@pytest.mark.parametrize("matrix,kind", [
    ("dense", "DenseOperator"), ("dia", "DiaOperator"),
    ("symdia", "DiaOperator"), ("stencil", "DiaOperator"),
    ("block_banded", "DenseOperator")])
def test_df_operator_picks_the_formats_jax_picks(matrix, kind):
    a = _df_route(matrix)
    jc, tc = both(a)
    jop, top = jdf.df_operator(jc), tdf.df_operator(tc, device="cpu")
    assert type(top.inner).__name__ == type(jop.inner).__name__ == kind
    for j, t in ((jop.lo_data, top.lo_data), (jop.lo2_data, top.lo2_data)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(top.todense(), a.toarray())


def test_df_operator_sends_large_block_banded_matrices_to_ell(monkeypatch):
    """Past the dense route's limit (JAX ``supports_df_dense``: n <= 8192; set
    lower here to keep the test small) a block-banded choice becomes ELL."""
    a = laplacian(m=24)
    jc, tc = both(a)
    monkeypatch.setattr(tdf, "DF_DENSE_ROUTE_MAX_N", 500)
    top = tdf.df_operator(tc, device="cpu")
    jop = jdf.df_operator(jc, fmt="ell")
    assert isinstance(top.inner, port.EllOperator)
    np.testing.assert_array_equal(top.inner.val.numpy(),
                                  np.asarray(jop.inner.val))
    assert tdf.DF_DENSE_ROUTE_MAX_N == 500 and jdf.df_operator(
        jc).inner.__class__.__name__ == "DenseOperator"


@pytest.mark.parametrize("name", ["pipe_pr_cg", "pr_cg", "hs_pcg"])
def test_f32x2_on_an_ell_inner_matches_jax(name):
    a = grid9(m=20)
    b = a @ np.ones(a.shape[0])
    jc, tc = both(a)
    jop = jdf.df_operator(jc, fmt="ell")
    top = tdf.df_operator(tc, fmt="ell", device="cpu")
    assert isinstance(top.inner, port.EllOperator)
    want, got = _histories(jop, top, b, name, dtype="f32x2")
    for p in ("nu", "alpha"):
        assert got[p].dtype == np.float32
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL)
    np.testing.assert_array_equal(got["nu"], want["nu"])
