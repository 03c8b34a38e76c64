"""Port parity: double-word values, operators and context (``ops/doublefloat``).

The same float64 inputs, made with numpy from a seed, are split into words by
both packages and go through the JAX package's ``ops/doublefloat.py`` (its
generic formulations: off the TPU it runs no kernel) and the port's plain
versions.  Both take the same roundings in the same order, so splits,
arithmetic, dots and products agree bit for bit (asserted); accuracy is held
to float64 as the JAX package's own tests hold it (~eps^2, componentwise
1e-11 for products).
"""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import make_spd

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops import doublefloat as jdf
from new_cg_variants_tpu.solvers.context import (
    generic_pipe_vector_phase as jax_generic_phase,
)
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import (
    df_operator_from_numpy,
    operator_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from new_cg_variants_tpu_torch.ops import df_spmv
from new_cg_variants_tpu_torch.ops import doublefloat as tdf
from new_cg_variants_tpu_torch.solvers import api


def same(j, t):
    """A JAX DF and a port DF hold the same words."""
    return (np.array_equal(np.asarray(j.hi), t.hi.numpy())
            and np.array_equal(np.asarray(j.lo), t.lo.numpy()))


def both_split(a):
    return jdf.df_split(a), tdf.df_split(a, device="cpu")


@pytest.fixture(scope="module")
def rng_vectors():
    rng = np.random.default_rng(1)
    return rng.standard_normal(2000), rng.standard_normal(2000)


def test_df_split3_is_exact_and_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((50, 50)) * np.exp(rng.uniform(-30, 30, (50, 50)))
    words = tdf.df_split3(a, device="cpu")
    assert all(w.dtype == torch.float32 for w in words)
    recon = sum(w.double() for w in words)
    np.testing.assert_array_equal(recon.numpy(), a)
    for j, t in zip(jdf.df_split3(a), words):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_df_split_matches_jax(rng_vectors):
    j, t = both_split(rng_vectors[0])
    assert same(j, t)
    assert float(t.lo.abs().max()) > 0
    np.testing.assert_allclose(t.value64().numpy(), rng_vectors[0],
                               rtol=2.0 ** -47)


def test_df_arithmetic_eps2_accuracy(rng_vectors):
    """The JAX package's accuracy check, on the port's values."""
    x64, y64 = rng_vectors
    x, y = (tdf.df_split(v, device="cpu") for v in (x64, y64))
    a = tdf.df_split(np.float64(0.7324821094721), device="cpu")
    z = x + a * y
    assert float((z.value64() - torch.from_numpy(x64 + 0.7324821094721 * y64))
                 .abs().max()) < 1e-12
    d = tdf.df_dot(x, y).value64().item()
    assert abs(d - x64 @ y64) / abs(x64 @ y64) < 1e-13
    q = (a / tdf.df_split(np.float64(3.14159), device="cpu")).value64().item()
    assert abs(q - 0.7324821094721 / 3.14159) < 1e-14


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "neg", "radd",
                                "rsub", "rmul", "rtruediv"])
def test_df_overloads_bitwise_against_jax(rng_vectors, op):
    x64, y64 = rng_vectors
    (jx, tx), (jy, ty) = both_split(x64), both_split(np.abs(y64) + 0.5)
    fns = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
           "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
           "neg": lambda a, b: -a, "radd": lambda a, b: 2.5 + a,
           "rsub": lambda a, b: 2.5 - a, "rmul": lambda a, b: 2.0 * a,
           "rtruediv": lambda a, b: 1.0 / b}
    assert same(fns[op](jx, jy), fns[op](tx, ty))


def test_df_dot_and_safe_div_match_jax(rng_vectors):
    (jx, tx), (jy, ty) = (both_split(v) for v in rng_vectors)
    assert same(jdf.df_dot(jx, jy), tdf.df_dot(tx, ty))
    jn, tn = both_split(np.array([1.5, -2.0, 0.0]))
    jd, td = both_split(np.array([0.0, 3.0, 0.0]))
    q = tdf.df_safe_div(tn, td)
    assert same(jdf.df_safe_div(jn, jd), q)
    assert q.hi[0] == 0 and q.lo[0] == 0 and q.hi[2] == 0
    assert abs(q.value64()[1].item() + 2.0 / 3.0) < 1e-15
    # a plain number on either side
    assert same(jdf.df_safe_div(1.0, jd), tdf.df_safe_div(1.0, td))


def test_df_zeros_where_collapse():
    z = tdf.df_zeros(3, device="cpu")
    assert z.shape == (3,) and z.dtype == torch.float32 and not z.hi.any()
    a = tdf.df_split(np.array([1.0, 2.0, 3.0]) / 3.0, device="cpu")
    w = tdf.df_where(torch.tensor([True, False, True]), a, z)
    assert w.hi[1] == 0 and w.hi[0] == a.hi[0] and w.lo[2] == a.lo[2]
    assert torch.equal(tdf.collapse(a), a.hi + a.lo)
    t = torch.ones(2)
    assert tdf.collapse(t) is t
    assert a.device.type == "cpu" and a.value().dtype == torch.float32


def sparse_spd(n=600, per_row=5, seed=0):
    """A random symmetric, diagonally dominant sparse matrix (scipy CSR, no
    band an RCM order can make narrow), made with numpy."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=per_row / n, random_state=rng,
                  data_rvs=lambda k: rng.uniform(-1.0, 1.0, k))
    a = (a + a.T).tocsr()
    return (a + sp.diags(np.abs(a).sum(axis=1).A1 + 1.0)).tocsr()


def both_coo(a):
    """The same scipy matrix as the JAX package's and the port's CooMatrix."""
    from new_cg_variants_tpu.ops.operators import coo_from_scipy

    return coo_from_scipy(a), port.ops.operators.coo_from_scipy(a)


def _operators(kind):
    """(JAX DF operator, port DF operator, float64 matrix) of one kind."""
    if kind == "ell":
        a = sparse_spd()
        jc, tc = both_coo(a)
        return (jdf.df_operator(jc, fmt="ell"),
                tdf.df_operator(tc, fmt="ell", device="cpu"), a.toarray())
    if kind == "dense":
        a = make_spd(64, cond=1e4)
        return jdf.df_operator(a), tdf.df_operator(a, device="cpu"), a
    jop, _, _ = jax_banded(2048, k=8, kappa=1e4,
                           fmt="symdia" if kind == "symdia" else "dia")
    if kind == "symdia":
        top = operator_from_numpy(jop.offsets, np.asarray(jop.data),
                                  device="cpu")
    else:
        top = operator_from_numpy(jop.offsets, np.asarray(jop.data),
                                  kind="dia", device="cpu")
    dense = top.todense()
    return jdf.df_operator(jop), tdf.df_operator(top, device="cpu"), dense


@pytest.mark.parametrize("kind", ["dia", "symdia", "dense", "ell"])
def test_df_operator_mv_matches_jax_and_float64(kind):
    jop, top, a64 = _operators(kind)
    assert isinstance(top.inner, {"dense": port.DenseOperator,
                                  "ell": port.EllOperator}.get(
                                      kind, port.DiaOperator))
    assert float(top.lo_data.abs().max()) > 0  # a float64 split, not f32
    rng = np.random.default_rng(2)
    (jv, tv), (jw, tw) = (both_split(rng.standard_normal(top.n))
                          for _ in range(2))
    y = top.mv(tv)
    assert same(jop.mv(jv), y)
    y2, z2 = top.mv2(tv, tw)
    assert torch.equal(y2.hi, y.hi) and torch.equal(y2.lo, y.lo)
    assert same(jop.mv(jw), z2)
    for got, v in ((y, tv), (z2, tw)):
        want = a64 @ v.value64().numpy()
        scale = np.abs(a64) @ np.abs(v.value64().numpy())
        err = np.abs(got.value64().numpy() - want) / scale
        assert err.max() < 1e-11, f"{kind}: {err.max():.2e}"


@pytest.mark.parametrize("kind", ["dia", "symdia", "dense", "ell"])
def test_df_operator_words_diagonal_and_csr(kind):
    jop, top, a64 = _operators(kind)
    field = {"dense": "a", "ell": "val"}.get(kind, "data")
    jinner, tinner = getattr(jop.inner, field), getattr(top.inner, field)
    for j, t in ((jinner, tinner), (jop.lo_data, top.lo_data),
                 (jop.lo2_data, top.lo2_data)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert same(jop.diagonal(), top.diagonal())
    np.testing.assert_array_equal(top.todense(), a64)
    assert (top.n, top.dtype, top.device.type) == (a64.shape[0],
                                                   torch.float32, "cpu")


def test_df_operator_symdia_expands_before_the_split():
    """The half-band is expanded on the host in float64, then split: every
    stored value comes back exactly, the low words are not zero."""
    jop, _, _ = jax_banded(2048, k=8, kappa=1e4, fmt="symdia")
    sym = operator_from_numpy(jop.offsets, np.asarray(jop.data), device="cpu")
    dop = tdf.df_operator(sym, device="cpu")
    offsets, full = sym.todia_host()
    assert dop.inner.offsets == offsets
    rec = (dop.inner.data.double() + dop.lo_data.double()
           + dop.lo2_data.double())
    np.testing.assert_array_equal(rec.numpy(), full)
    assert float(dop.lo_data.abs().max()) > 0


def test_df_operator_of_float32_data_has_zero_low_words():
    op, _, _ = port.banded_model(256, k=4, fmt="dia", device="cpu")
    dop = tdf.df_operator(op.astype(torch.float32), device="cpu")
    assert not dop.lo_data.any() and not dop.lo2_data.any()
    assert tdf.df_operator(dop, device="cpu").inner is not None


@pytest.mark.parametrize("what", ["scipy", "coo", "ell", "ell inner"])
def test_unported_formats_raise_naming_the_roadmap_item(what):
    """Sparse input, which raised naming ROADMAP item 1.5 before the format
    layer was ported, now builds the JAX package's double-word operator word
    for word (scipy and ``CooMatrix`` through the auto route and its
    rewrites, an ``EllOperator`` split as it stands); an inner operator of
    another kind still raises, as does an object that is no matrix."""
    from new_cg_variants_tpu.ops import operators as jo

    a = sparse_spd()
    jc, tc = both_coo(a)
    if what == "ell inner":
        with pytest.raises(TypeError, match="ELL"):
            tdf.DFOperator(types.SimpleNamespace(n=8), torch.zeros(8),
                           torch.zeros(8))
        with pytest.raises(TypeError):
            tdf.df_operator(object(), device="cpu")
        return
    if what == "ell":
        jgiven = jo.from_coo(jc, fmt="ell")
        given = port.from_coo(tc, fmt="ell", device="cpu")
    else:
        jgiven, given = (a, a) if what == "scipy" else (jc, tc)
    jop, top = jdf.df_operator(jgiven), tdf.df_operator(given, device="cpu")
    assert type(top.inner).__name__ == type(jop.inner).__name__
    field = "val" if what == "ell" else "a"
    for j, t in ((getattr(jop.inner, field), getattr(top.inner, field)),
                 (jop.lo_data, top.lo_data), (jop.lo2_data, top.lo2_data)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("kind", ["dia", "dense"])
def test_df_jacobi_matches_jax(kind):
    jop, top, a64 = _operators(kind)
    jj, tj = jdf.DFJacobi.from_operator(jop), tdf.DFJacobi.from_operator(top)
    assert same(jj.inv_diag, tj.inv_diag)
    np.testing.assert_allclose(tj.inv_diag.value64().numpy(),
                               1.0 / np.diag(a64), rtol=1e-13)
    jv, tv = both_split(np.random.default_rng(4).standard_normal(top.n))
    assert same(jj.apply(jv), tj.apply(tv))
    assert same(jj.inv_diag, tj.to("cpu").inv_diag)


def test_double_float_context_declines_every_fused_phase():
    _, top, _ = _operators("dia")
    ctx = tdf.DoubleFloatContext(top)
    assert not ctx.has_prec and ctx.extra_norm is None
    v = tdf.df_split(np.ones(top.n), device="cpu")
    s_ = dict.fromkeys(("x", "r", "w", "u", "p", "s", "rt", "st", "wt", "ut"),
                       v)
    for hook, args in (("pipe_full_step", (s_, v, v, True)),
                       ("pipe_full_step_prec", (s_, v, v, True)),
                       ("pr_full_step", (s_, v, v)),
                       ("pr_full_step_prec", (s_, v, v)),
                       ("cgcg_matvec_phase", (s_, v)),
                       ("cgcg_matvec_phase_prec", (s_, v)),
                       ("gv_matvec_phase", (s_, v)),
                       ("gv_matvec_phase_prec", (s_, v)),
                       ("hs_matvec_phase", (v, v, v)),
                       ("pipe_vector_phase_prec", (s_, v, v))):
        assert getattr(ctx, hook)(*args) is None, hook
    assert ctx.prec(v) is v
    assert abs(ctx.norm(v).item() - np.sqrt(top.n)) < 1e-6


def test_double_float_context_vector_phase_matches_jax_generic():
    """The context's vector phase (the plain version of the kernel on the
    CPU) against the JAX generic formulation over double words: vectors bit
    for bit, and the dots too (the same double-word tree)."""
    jop, top, _ = _operators("dia")
    rng = np.random.default_rng(3)
    vecs = [rng.standard_normal(top.n) for _ in range(6)]
    scal = (np.float64(0.3712345678901234), np.float64(0.1298765432109876))
    jctx, tctx = jdf.DoubleFloatContext(jop), tdf.DoubleFloatContext(top)
    want = jax_generic_phase(jctx, *[jdf.df_split(v) for v in vecs],
                             *[jdf.df_split(c) for c in scal])
    got = tctx.pipe_vector_phase(*[tdf.df_split(v, device="cpu")
                                   for v in vecs],
                                 *[tdf.df_split(c, device="cpu")
                                   for c in scal])
    for j, t in zip(want[:5], got[:5]):
        assert same(j, t)
    for j, t in zip(want[5], got[5]):
        assert same(j, t)
    # a plain number as a scalar is coerced
    plain = tctx.pipe_vector_phase(*[tdf.df_split(v, device="cpu")
                                     for v in vecs], 0.5, 0.25)
    assert len(plain) == 6 and len(plain[5]) == 4


def test_convert_carries_double_word_operators_and_states():
    jop, top, _ = _operators("dia")
    conv = df_operator_from_numpy(jop.inner.offsets,
                                  np.asarray(jop.inner.data),
                                  np.asarray(jop.lo_data),
                                  np.asarray(jop.lo2_data), device="cpu")
    for a, b in ((conv.inner.data, top.inner.data), (conv.lo_data, top.lo_data),
                 (conv.lo2_data, top.lo2_data)):
        assert torch.equal(a, b)
    jd, _, _ = _operators("dense")
    dense = df_operator_from_numpy(None, np.asarray(jd.inner.a),
                                   np.asarray(jd.lo_data),
                                   np.asarray(jd.lo2_data), device="cpu")
    assert isinstance(dense.inner, port.DenseOperator)
    je, te, _ = _operators("ell")
    ell = df_operator_from_numpy(None, np.asarray(je.inner.val),
                                 np.asarray(je.lo_data),
                                 np.asarray(je.lo2_data),
                                 idx=np.asarray(je.inner.idx),
                                 nnz=je.inner.nnz, device="cpu")
    assert isinstance(ell.inner, port.EllOperator) and ell.nnz == te.nnz
    v = tdf.df_split(np.random.default_rng(5).standard_normal(ell.n),
                     device="cpu")
    y, want = ell.mv(v), te.mv(v)
    assert torch.equal(y.hi, want.hi) and torch.equal(y.lo, want.lo)
    jv = jdf.df_split(np.arange(5.0) / 7.0)
    state = {"x": (np.asarray(jv.hi), np.asarray(jv.lo)), "k": np.int32(3),
             "nu": (np.float32(1.5), np.float32(2.0 ** -30))}
    tstate = state_from_numpy(state, device="cpu")
    assert isinstance(tstate["x"], tdf.DF) and tstate["k"] == 3
    assert same(jv, tstate["x"])
    back = state_to_numpy(tstate)
    for key in ("x", "nu"):
        assert all(np.array_equal(a, b) for a, b in zip(back[key], state[key]))


def test_selfcheck_passes_on_the_cpu_and_raises_when_words_are_lost(
        monkeypatch):
    monkeypatch.setattr(api, "_DF_CHECKED", set())
    api._df_selfcheck(torch.device("cpu"))
    assert "cpu" in api._DF_CHECKED

    def contracted(a, b):  # what a fused multiply-add leaves of 2Prod
        p = a * b
        return p, torch.zeros_like(p)

    monkeypatch.setattr(api, "_DF_CHECKED", set())
    monkeypatch.setattr(df_spmv, "two_prod", contracted)
    with pytest.raises(RuntimeError, match="error words"):
        api._df_selfcheck(torch.device("cpu"))
    assert not api._DF_CHECKED


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["df_split", "df_split3", "df_zeros",
                                   "df_operator", "run", "solve"])
def test_default_device_without_cuda_raises(no_cuda, entry):
    op, b, _ = port.banded_model(64, k=2, fmt="dia", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "df_zeros":
            tdf.df_zeros(4)
        elif entry == "df_operator":
            tdf.df_operator(op)
        elif entry == "run":
            port.run("pipe_pr_cg", op, b, max_iter=2, dtype="f32x2")
        elif entry == "solve":
            port.solve(op, b, max_iter=2, dtype="f32x2")
        else:
            getattr(tdf, entry)(np.ones(4))

