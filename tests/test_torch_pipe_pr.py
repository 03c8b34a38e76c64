"""Port parity, end to end: pipe-P/PR CG on half-band storage.

The same problem (built bit-identically by both packages, and carried across
with ``convert.py``) goes through the JAX package and the port, in float64 on
the CPU.  Two kinds of agreement are held, because no finer one can be:

* Per iteration, the scalar histories agree to rtol 1e-10 over the first
  25 iterations at kappa = 1e6.  The JAX package's own two paths (generic
  and fused) differ only in summation order, agree to 1e-12 through
  iteration ~27 and then drift apart (rounding is amplified by the Krylov
  recurrences), so no assertion reaches past iteration 25.
* On a problem that converges (kappa = 100), the outcome: the iteration
  count within 1 of the JAX package's two stops, the solution to
  kappa * rtol at the stop and to 1e-10 after 150 iterations (see
  ``test_solve_outcome_matches_jax`` for why not 1e-10 at the stop).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.solvers import api as japi
from new_cg_variants_tpu.solvers.context import Context as JaxContext
from new_cg_variants_tpu.solvers.families import FAMILIES as JAX_FAMILIES
from new_cg_variants_tpu_torch import run, solve
from new_cg_variants_tpu_torch.convert import (
    operator_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from new_cg_variants_tpu_torch.solvers.context import Context
from new_cg_variants_tpu_torch.solvers.families import FAMILIES, _safe_div

N, K = 4096, 32
ITERS = 25
HIST_RTOL = 1e-10
SCALARS = {"nu": "nu", "mu": "mu", "delta": "delta", "gamma": "gamma",
           "alpha": "a", "beta": "b"}


def _probes():
    out = []
    for name, key in SCALARS.items():
        if name in ("nu", "mu", "alpha", "beta"):
            out.append(name)
        else:
            out.append((name, lambda ctx, s, aux, key=key: s[key]))
    return tuple(out)


def _port_op(jop):
    return operator_from_numpy(jop.offsets, np.asarray(jop.data),
                               device="cpu")


@pytest.fixture(scope="module")
def kappa_1e6():
    jop, b, _ = jax_banded(N, k=K, fmt="symdia")
    return jop, _port_op(jop), b


@pytest.fixture(scope="module")
def port_history(kappa_1e6):
    _, top, b = kappa_1e6
    return run("pipe_pr_cg", top, b, max_iter=ITERS + 1, probes=_probes(),
               device="cpu")


@pytest.mark.parametrize("jax_path", ["generic", "fused_interpret"])
def test_scalar_histories_match_jax(kappa_1e6, port_history, jax_path,
                                    monkeypatch):
    jop, _, b = kappa_1e6
    if jax_path == "fused_interpret":
        monkeypatch.setenv("NCGV_FULL_FUSED", "1")
        monkeypatch.setenv("NCGV_FUSED_TILE", "1024")
    want = japi.run("pipe_pr_cg", jop, b, max_iter=ITERS + 1,
                    probes=_probes())
    for name in SCALARS:
        got = port_history[name]
        assert got.shape == np.asarray(want[name]).shape == (ITERS + 1,)
        np.testing.assert_allclose(got, np.asarray(want[name]),
                                   rtol=HIST_RTOL, err_msg=name)


@pytest.mark.parametrize("variant", ["pipe_pr_cg", "pipe_p_cg",
                                     "pipe_pr_m_cg", "pipe_p_m_cg"])
def test_state_carried_across_matches_jax(kappa_1e6, variant):
    """A JAX state after init and 5 steps, carried into the port, takes the
    same next 10 steps in both packages."""
    jop, top, b = kappa_1e6
    key = variant[: -len("_cg")]
    jinit, jstep = JAX_FAMILIES[key]
    jctx = JaxContext(jop)
    jb = jnp.asarray(b)
    js = jinit(jctx, jb, jnp.zeros_like(jb))
    for _ in range(5):
        js = jstep(jctx, js)
    state = state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                             device="cpu")
    assert state["k"] == 5 and state["x"].dtype == torch.float64
    _, step = FAMILIES[key]
    ctx = Context(top)
    for _ in range(10):
        js = jstep(jctx, js)
        state = step(ctx, state)
    got = state_to_numpy(state)
    assert got["k"] == int(js["k"]) == 15
    for name in ("nu", "mu", "delta", "gamma", "a", "b", "a1", "b1"):
        np.testing.assert_allclose(got[name], np.asarray(js[name]),
                                   rtol=HIST_RTOL, err_msg=name)
    for name in ("x", "r", "w", "u", "p", "s"):
        want = np.asarray(js[name])
        np.testing.assert_allclose(got[name], want, rtol=HIST_RTOL,
                                   atol=HIST_RTOL * np.abs(want).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def kappa_100():
    jop, b, x_true = jax_banded(N, k=K, kappa=100.0, fmt="symdia")
    return jop, _port_op(jop), b, x_true


@pytest.mark.parametrize("variant", ["pipe_pr_cg", "pipe_p_cg",
                                     "pipe_pr_m_cg"])
def test_solve_outcome_matches_jax(kappa_100, variant, monkeypatch):
    """Held to the spread of the JAX package's own two paths.

    Past iteration ~30 the histories of any two summation orders drift
    apart, also at kappa = 100, so where a solve stops at rtol 1e-10 (about
    85 iterations) moves by an iteration or two: the JAX generic and fused
    paths themselves stop at 89 and 87 for pipe_p_cg, and their solutions
    differ by 8e-10 there.  So the stop is held to JAX's two stops +- 1 and
    to the forward-error bound kappa * rtol, and the solution to 1e-10 after
    150 iterations, past the attainable-accuracy floor, where each solution
    is within ~1e-12 of the true one.
    """
    jop, top, b, x_true = kappa_100
    kappa, rtol = 100.0, 1e-10
    got = solve(top, b, variant=variant, rtol=rtol, device="cpu")
    want = japi.solve(jop, b, variant=variant, rtol=rtol)
    monkeypatch.setenv("NCGV_FULL_FUSED", "1")
    monkeypatch.setenv("NCGV_FUSED_TILE", "1024")
    want_fused = japi.solve(jop, b, variant=variant, rtol=rtol)
    monkeypatch.delenv("NCGV_FULL_FUSED")
    assert want.converged and want_fused.converged and got.converged
    stops = (want.iterations, want_fused.iterations)
    # the reference's own spread, as recorded above: a change to the JAX
    # package that widens it shows up here
    assert max(stops) - min(stops) <= 2, stops
    np.testing.assert_allclose(np.asarray(want_fused.x), np.asarray(want.x),
                               rtol=0, atol=kappa * rtol)
    assert min(stops) - 1 <= got.iterations <= max(stops) + 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=kappa * rtol)

    floor = solve(top, b, variant=variant, max_iter=150, norm_type="none",
                  device="cpu")
    want_floor = japi.solve(jop, b, variant=variant, max_iter=150,
                            norm_type="none")
    np.testing.assert_allclose(floor.x.numpy(), np.asarray(want_floor.x),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(floor.x.numpy(), x_true, rtol=0, atol=1e-10)

    probes = ("updated_residual_2_norm", "nu", "alpha")
    jr = japi.run(variant, jop, b, max_iter=30, probes=probes)
    tr = run(variant, top, b, max_iter=30, probes=probes, device="cpu")
    for name in probes:
        assert tr[name].shape == np.asarray(jr[name]).shape == (30,)
        np.testing.assert_allclose(tr[name][:ITERS], np.asarray(jr[name])[:ITERS],
                                   rtol=HIST_RTOL, err_msg=name)


def test_fixed_iteration_solve_runs_max_iter(kappa_100):
    _, top, b, _ = kappa_100
    res = solve(top, b, max_iter=7, norm_type="none", device="cpu")
    assert res.iterations == 7 and res.converged
    assert res.x.shape == (N,) and bool(torch.isfinite(res.x).all())


def test_safe_div_freezes_on_zero_denominator():
    num = torch.tensor([1.0, 0.0, -2.0], dtype=torch.float64)
    den = torch.tensor([0.0, 0.0, 4.0], dtype=torch.float64)
    out = _safe_div(num, den)
    assert torch.equal(out, torch.tensor([0.0, 0.0, -0.5], dtype=torch.float64))
    zero = torch.zeros((), dtype=torch.float32)
    assert _safe_div(zero, zero).item() == 0.0
    assert _safe_div(zero, zero).dtype == torch.float32


@pytest.mark.parametrize("variant,kw,exc", [
    ("pipe_pr_pcg", {"preconditioner": "ilu"}, ValueError),
    ("pipe_pr_pcg", {"preconditioner": 3}, TypeError),
    ("pipe_pr_cg", {"A": "triple"}, TypeError),
    ("pipe_pr_cg", {"dtype": "f32x2", "A": "triple"}, TypeError),
    ("pipe_pr_cg", {"dtype": "f32x2", "A": "ell"}, TypeError),
    ("bogus_cg", {}, KeyError),
])
def test_unported_options_raise(kappa_100, variant, kw, exc):
    """What still raises: an unknown preconditioner or variant name, and a
    matrix that is neither an operator, an array, a scipy sparse matrix nor
    a ``CooMatrix`` (a bare object with ``row``/``col``/``val`` or
    ``val``/``idx``), as in the JAX package.  (The names and the
    preconditioner that raised before every variant was ported run in
    test_torch_variants.py; dense and full-DIA operators in
    test_torch_dia_variants.py; double-word arithmetic and compensated dots,
    which raised before they were ported, in test_torch_df_variants.py and
    test_torch_compensated.py; scipy, ``CooMatrix`` and ELL input, which
    raised before the format layer was ported, in
    test_torch_sparse_variants.py.)"""
    import types

    _, top, b, _ = kappa_100
    kw = dict(kw)
    n = b.shape[0]
    A = {"triple": types.SimpleNamespace(row=np.arange(n), col=np.arange(n),
                                         val=np.ones(n)),
         "ell": types.SimpleNamespace(val=np.ones((n, 1)),
                                      idx=np.zeros((n, 1), int)),
         }.get(kw.pop("A", None), top)
    with pytest.raises(exc):
        solve(A, b, variant=variant, max_iter=2, device="cpu", **kw)
