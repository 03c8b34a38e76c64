"""Port parity: error-free transforms, compensated dots, ``compensated=True``.

The same float32 inputs, made with numpy from a seed, go through the JAX
package's ``ops/compensated.py`` and the port's.  Each transform is a fixed
sequence of roundings, so the two agree bit for bit, eagerly and under
``jax.jit`` alike (asserted).

``Context(compensated=True)`` in float32: the port's ``run`` against the JAX
families stepped one operation at a time over 25 iterations, bit for bit, on
the diagonal model spectrum and on a banded operator (unpreconditioned), and
with Jacobi on the scaled band of ``test_torch_variants.py`` (on the other two
Jacobi converges within a few iterations, into the float32 underflow range,
where XLA's CPU flushes subnormal values and torch keeps them).  JAX's own
``run`` compiles its step inside ``lax.scan``, and XLA's compiled float32 step
rounds differently from the same step taken eagerly from iteration 1 on (at
~1e-7, growing with the iterations at kappa = 1e4); that spread is JAX's, and
the test states it.  In float64 the port's ``run`` is held to JAX's ``run`` at rtol
1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.matio.problems import model_spectrum as jax_spectrum
from new_cg_variants_tpu.ops import compensated as jc
from new_cg_variants_tpu.ops.operators import DiaOperator as JaxDia
from new_cg_variants_tpu.solvers import api as japi
from new_cg_variants_tpu.solvers.context import Context as JaxContext
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.ops import compensated as tc
from new_cg_variants_tpu_torch.solvers.context import Context
from test_torch_variants import scaled_band

ITERS = 25


def _f32(rng, n, spread=10.0):
    """float32 values over many binades, signs mixed."""
    return (rng.standard_normal(n)
            * np.exp(rng.uniform(-spread, spread, n))).astype(np.float32)


def _same(jax_out, torch_out):
    return all(np.array_equal(np.asarray(j), t.numpy())
               for j, t in zip(jax_out, torch_out))


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(11)
    return [_f32(rng, 4099) for _ in range(4)]


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("fn,nargs", [
    ("two_sum", 2), ("two_prod", 2), ("fast_two_sum", 2), ("df_add", 4)])
def test_transform_bitwise_against_jax(words, fn, nargs, jit):
    jfn = getattr(jc, fn)
    if jit:
        jfn = jax.jit(jfn)
    args = words[:nargs]
    if fn == "fast_two_sum":  # needs |a| >= |b|
        args = [args[0], (args[1] * np.float32(2.0 ** -30)).astype(np.float32)]
    got = getattr(tc, fn)(*(torch.from_numpy(a) for a in args))
    assert _same(jfn(*(jnp.asarray(a) for a in args)), got)


def test_two_sum_and_two_prod_are_exact(words):
    a, b = (torch.from_numpy(w) for w in words[:2])
    s, e = tc.two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
    p, e = tc.two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a.double() * b.double())
    a64 = torch.tensor([1e16], dtype=torch.float64)
    s, e = tc.two_sum(a64, torch.ones(1, dtype=torch.float64))
    assert s.item() == 1e16 and e.item() == 1.0
    p, e = tc.two_prod(torch.tensor(1.0 + 2.0 ** -12), torch.tensor(1.0 - 2.0 ** -12))
    assert p.double() + e.double() == (1.0 + 2.0 ** -12) * (1.0 - 2.0 ** -12)


@pytest.mark.parametrize("n", [1, 7, 4096, 4099])
def test_tree_sum_bitwise_against_jax(words, n):
    hi, lo = (w[:n] for w in words[:2])
    lo = (lo * np.float32(2.0 ** -24)).astype(np.float32)
    got = tc._df_tree_sum(torch.from_numpy(hi), torch.from_numpy(lo))
    assert _same(jc._df_tree_sum(jnp.asarray(hi), jnp.asarray(lo)), got)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_comp_dot_bitwise_against_jax(words, jit):
    x, y = words[:2]
    pair = jax.jit(jc.comp_dot_pair) if jit else jc.comp_dot_pair
    dot = jax.jit(jc.comp_dot) if jit else jc.comp_dot
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert _same(pair(jnp.asarray(x), jnp.asarray(y)), tc.comp_dot_pair(tx, ty))
    assert np.asarray(dot(jnp.asarray(x), jnp.asarray(y))) == tc.comp_dot(tx, ty).numpy()


def test_comp_dot_beats_the_plain_float32_dot():
    """The JAX package's accuracy check: on a sum with heavy cancellation
    the compensated dot is within 1e-6 of the exact dot of the float32
    inputs, or 50 times closer than the plain one."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(1 << 16) * 1e4).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(1 << 16).astype(np.float32))
    exact = float(torch.dot(x.double(), y.double()))
    err_plain = abs(float(torch.dot(x, y)) - exact)
    err_comp = abs(float(tc.comp_dot(x, y)) - exact)
    assert err_comp < err_plain / 50 or err_comp < 1e-6 * abs(exact)


def test_df_mul_and_div_are_double_word_accurate():
    rng = np.random.default_rng(3)
    a64, b64 = rng.standard_normal(1000), rng.uniform(0.5, 2.0, 1000)

    def split(v):
        hi = v.astype(np.float32)
        return torch.from_numpy(hi), torch.from_numpy((v - hi).astype(np.float32))

    (ah, al), (bh, bl) = split(a64), split(b64)
    a, b = ah.double() + al.double(), bh.double() + bl.double()
    ph, pl = tc.df_mul(ah, al, bh, bl)
    assert float(((ph.double() + pl.double()) - a * b).abs().max()) < 1e-13
    qh, ql = tc.df_div(ah, al, bh, bl)
    assert float(((qh.double() + ql.double()) - a / b).abs().max()) < 1e-13


def scaled_band_dia():
    """The scaled band in full-DIA storage, float64, through the port's exact
    expansion of the half-band."""
    offsets, data = scaled_band()
    return port.SymDiaOperator(offsets, torch.from_numpy(data)).todia_host()


def _jax_history(name, jop, b, precond_spec):
    """nu and alpha of JAX's families stepped one operation at a time."""
    init_fn, step_fn, precond = japi._resolve(name, jop, precond_spec)
    ctx = JaxContext(jop, precond, compensated=True)
    s = init_fn(ctx, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)))
    nu, alpha = [s["nu"]], [s["a"]]
    for _ in range(ITERS):
        s = step_fn(ctx, s)
        nu.append(s["nu"])
        alpha.append(s["a"])
    return np.array(nu), np.array(alpha)


@pytest.fixture(scope="module")
def problems32():
    out = {}
    for label, (jop, b, _) in (
            ("spectrum", jax_spectrum(4096, kappa=1e4)),
            ("band", jax_banded(512, k=4, kappa=1e4))):
        jop32 = jop.astype(jnp.float32)
        top = port.DiaOperator(jop.offsets, torch.from_numpy(
            np.asarray(jop.data, np.float32)))
        out[label] = (jop32, top, np.asarray(b, np.float32))
    offsets, data = scaled_band_dia()
    top = port.DiaOperator(offsets, torch.from_numpy(data.astype(np.float32)))
    out["scaled_band"] = (JaxDia(offsets, jnp.asarray(data, jnp.float32)), top,
                          (top.todense() @ np.ones(top.n)).astype(np.float32))
    return out


@pytest.mark.parametrize("problem,name", [
    (problem, name) for problem in ("spectrum", "band")
    for name in ("pipe_pr_cg", "pr_cg", "hs_cg", "cg_cg", "gv_cg",
                 "pipe_p_m_cg")] + [
    ("scaled_band", name) for name in ("hs_pcg", "pipe_pr_pcg", "pr_pcg",
                                       "gv_pcg", "cg_pcg", "pipe_p_pcg")])
def test_compensated_float32_history_bitwise(problems32, problem, name):
    jop, top, b = problems32[problem]
    spec = "jacobi" if name.endswith("pcg") else None
    jnu, jalpha = _jax_history(name, jop, b, spec)
    out = port.run(name, top, b, max_iter=ITERS + 1, probes=("nu", "alpha"),
                   preconditioner=spec, compensated=True, device="cpu")
    assert out["nu"].dtype == np.float32
    np.testing.assert_array_equal(out["nu"], jnu)
    np.testing.assert_array_equal(out["alpha"], jalpha)


def test_jax_compiled_float32_run_has_its_own_rounding(problems32):
    """Why the float32 histories are held against JAX's eager steps: JAX's
    ``run`` (its step compiled inside ``lax.scan``) leaves its own eager
    steps at iteration 1 already, while the port's ``run`` never does."""
    jop, top, b = problems32["spectrum"]
    jnu, _ = _jax_history("pipe_pr_cg", jop, b, None)
    compiled = japi.run("pipe_pr_cg", jop, b, max_iter=ITERS + 1,
                        probes=("nu",), compensated=True)["nu"]
    assert compiled[0] == jnu[0] and not np.array_equal(compiled, jnu)
    rel = np.abs(compiled - jnu) / jnu
    assert 0 < rel[1] < 1e-6


def test_compensated_context_declines_every_fused_phase(problems32):
    _, top, _ = problems32["band"]
    ctx = Context(top, None, compensated=True)
    v = torch.ones(top.n)
    s_ = dict.fromkeys(("x", "r", "w", "u", "p", "s"), v)
    assert ctx.pipe_full_step(s_, False, True) is None
    assert ctx.pr_full_step(s_, 0.5, 0.5) is None
    assert ctx.hs_matvec_phase(v, v, 0.5) is None
    assert ctx.cgcg_matvec_phase(s_, 0.5) is None
    assert ctx.gv_matvec_phase(s_, 0.5) is None
    (d,) = ctx.dots((v, v))
    assert d.item() == top.n


@pytest.mark.parametrize("name", ["pipe_pr_cg", "pr_pcg", "gv_cg"])
def test_compensated_float64_run_matches_jax(name):
    spec = "jacobi" if name.endswith("pcg") else None
    if spec:
        offsets, data = scaled_band_dia()
        jop = JaxDia(offsets, jnp.asarray(data))
        top = port.DiaOperator(offsets, torch.from_numpy(data))
        b = top.todense() @ np.ones(top.n)
    else:
        jop, b, _ = jax_banded(512, k=4, kappa=1e4)
        top = port.DiaOperator(jop.offsets,
                               torch.from_numpy(np.asarray(jop.data)))
    kw = dict(max_iter=ITERS + 1, probes=("nu", "alpha"), preconditioner=spec,
              compensated=True)
    want = japi.run(name, jop, b, **kw)
    got = port.run(name, top, b, device="cpu", **kw)
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(got[p], want[p], rtol=1e-10)


def test_compensated_solve_reaches_the_plain_accuracy():
    """The JAX package's outcome: float32 with compensated dots is at least
    as accurate as without (400 iterations, kappa = 1e4)."""
    op, b, x_true = port.banded_model(2048, k=4, kappa=1e4, fmt="dia",
                                      device="cpu")
    op32 = op.astype(torch.float32)
    b32 = b.astype(np.float32)
    kw = dict(max_iter=400, probes=("error_2_norm",), x_true=x_true,
              device="cpu")
    plain = port.run("pipe_pr_cg", op32, b32, **kw)["error_2_norm"]
    comp = port.run("pipe_pr_cg", op32, b32, compensated=True,
                    **kw)["error_2_norm"]
    assert np.nanmin(comp) <= np.nanmin(plain) * 1.1
