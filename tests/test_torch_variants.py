"""Port parity, end to end: every CG variant on half-band storage.

The same problems go through the JAX package and the port, in float64 on the
CPU; ``_pcg`` names run with ``preconditioner="jacobi"`` unless a test says
otherwise.  Three problems, all built with numpy and handed to both:

* ``banded_model`` (kappa = 1e6, n = 4096, k = 32), the main path's problem.
  Unpreconditioned, its histories are held over 25 iterations.  With Jacobi
  it is nearly solved by the preconditioner alone (off-diagonals 1e-4 beside
  a diagonal >= 1): nu falls six orders per iteration and sits on the
  rounding floor from iteration 6 on, and each iteration multiplies a
  rounding difference by that same 1e6, so the JAX package's own generic and
  fused paths disagree by 7e-7 at iteration 5.  There the ``_pcg`` names are
  held on nu and alpha over iterations 0-2 (the predicted beta of the pr, m
  and pipe families, ``(nu - 2 a delta + a^2 gamma) / nu``, cancels those six
  orders within one iteration and is held only through the nu and alpha that
  follow from it) and on the solution after 25 iterations.
* a scaled band (n = 512, half-band 4): ``D^1/2 T D^1/2`` with ``T`` a
  diagonally dominant Toeplitz band and ``D`` random in [1, 100], so that
  Jacobi leaves ``T`` with a condition number near 1e3 and no variant
  converges within 25 iterations.  Every name is held over 25 iterations
  against both JAX paths (generic, and fused Pallas kernels in interpret
  mode: tile 128, four tiles).
* ``make_spd(64)`` of ``tests/conftest.py`` carried into half-band form
  (64 stored diagonals); the JAX package runs it as a dense operator.  Its
  histories are held over iterations 0-19: from iteration 20 on a rounding
  difference grows a hundredfold per iteration (the Krylov space starts to
  exhaust the 64 eigenvalues), 1e-12 at iteration 20 and 1e-5 at 24.

Scalar histories agree to rtol 1e-10; past iteration ~27 any two summation
orders drift apart (``test_torch_pipe_pr.py``), so nothing reaches further.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_spd

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops.sym_dia import SymDiaOperator as JaxSymDia
from new_cg_variants_tpu.solvers import api as japi
from new_cg_variants_tpu.solvers.context import Context as JaxContext
from new_cg_variants_tpu.solvers.precond import (
    JacobiPreconditioner as JaxJacobi,
)
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import (
    operator_from_numpy,
    preconditioner_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from new_cg_variants_tpu_torch.ops import sym_dia, sym_fused
from new_cg_variants_tpu_torch.probes.probes import PROBES
from new_cg_variants_tpu_torch.solvers import api as tapi
from new_cg_variants_tpu_torch.solvers.context import Context
from new_cg_variants_tpu_torch.solvers.precond import (
    IdentityPreconditioner,
    JacobiPreconditioner,
)

ITERS = 25
SPD64_ROWS = 20
RTOL = 1e-10
SCALARS = ("nu", "alpha", "beta")
NAMES = port.VARIANT_NAMES
FAMILY_KEYS = ("hs", "cg", "gv", "pr", "m", "pipe_p", "pipe_pr", "pipe_p_m",
               "pipe_pr_m")


def _jacobi(name):
    return "jacobi" if name.endswith("pcg") else None


def _port_op(jop):
    return operator_from_numpy(jop.offsets, np.asarray(jop.data),
                               device="cpu")


def scaled_band(n=512, h=4, seed=0, eps=1e-3):
    """``D^1/2 T D^1/2`` in half-band storage (see the module docstring)."""
    rng = np.random.default_rng(seed)
    c = -rng.uniform(0.5, 1.0, h)
    dsc = np.sqrt(rng.uniform(1.0, 100.0, n))
    data = np.zeros((h + 1, n))
    data[0] = 2.0 * np.abs(c).sum() * (1.0 + eps) * dsc * dsc
    for d in range(1, h + 1):
        data[d, : n - d] = c[d - 1] * dsc[: n - d] * dsc[d:]
    return tuple(range(h + 1)), data


def dense_to_halfband(a):
    n = a.shape[0]
    data = np.zeros((n, n))
    for d in range(n):
        data[d, : n - d] = np.diagonal(a, d)
    return tuple(range(n)), data


@pytest.fixture(scope="module")
def model():
    jop, b, x_true = jax_banded(4096, k=32, fmt="symdia")
    return jop, _port_op(jop), b, x_true


@pytest.fixture(scope="module")
def sband():
    offsets, data = scaled_band()
    jop = JaxSymDia(offsets, jnp.asarray(data))
    top = operator_from_numpy(offsets, data, device="cpu")
    b = top.todense() @ np.ones(data.shape[1])
    return jop, top, b


@pytest.fixture(scope="module")
def spd64():
    a = make_spd(64)
    top = operator_from_numpy(*dense_to_halfband(a), device="cpu")
    np.testing.assert_array_equal(top.todense(), a)
    return a, top, a @ np.ones(64)


def _histories(jop, top, b, name, **kw):
    kw = dict(max_iter=ITERS + 1, probes=SCALARS, preconditioner=_jacobi(name),
              **kw)
    want = japi.run(name, jop, b, **kw)
    got = port.run(name, top, b, device="cpu", **kw)
    return got, want


def _assert_histories(got, want, rows=ITERS + 1, scalars=SCALARS):
    for p in scalars:
        assert got[p].shape == np.asarray(want[p]).shape == (ITERS + 1,)
        np.testing.assert_allclose(got[p][:rows], np.asarray(want[p])[:rows],
                                   rtol=RTOL, err_msg=p)


# --- (b) histories of every name -------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_histories_on_banded_model(model, name):
    jop, top, b, x_true = model
    got, want = _histories(jop, top, b, name)
    if not name.endswith("pcg"):
        _assert_histories(got, want)
        return
    _assert_histories(got, want, rows=3, scalars=("nu", "alpha"))
    # both packages sit on the attainable floor after 25 iterations; gv and
    # pipe_p(_m), which recompute nothing, keep the least accuracy
    for x in (got["x"].numpy(), np.asarray(want["x"])):
        np.testing.assert_allclose(x, x_true, rtol=0, atol=1e-7)


@pytest.mark.parametrize("jax_path", ["generic", "fused_interpret"])
@pytest.mark.parametrize("name", NAMES)
def test_histories_on_scaled_band(sband, name, jax_path, monkeypatch):
    if jax_path == "fused_interpret":
        monkeypatch.setenv("NCGV_FULL_FUSED", "1")
        monkeypatch.setenv("NCGV_FUSED_TILE", "128")
    got, want = _histories(*sband, name)
    _assert_histories(got, want)
    # not converged: every row compared is a row of the descent
    assert got["nu"][-1] > 1e-6 * got["nu"][0]


@pytest.mark.parametrize("name", NAMES)
def test_histories_on_make_spd_in_halfband_form(spd64, name):
    a, top, b = spd64
    got, want = _histories(a, top, b, name, dtype=jnp.float64)
    _assert_histories(got, want, rows=SPD64_ROWS)


@pytest.mark.parametrize("name", NAMES)
def test_variant_function_is_run_under_its_name(sband, name):
    _, top, b = sband
    fn = getattr(port, name)
    assert fn.__name__ == name and name in port.__all__
    kw = dict(max_iter=6, probes=("nu",), preconditioner=_jacobi(name),
              device="cpu")
    np.testing.assert_array_equal(fn(top, b, **kw)["nu"],
                                  port.run(name, top, b, **kw)["nu"])


def test_cg_name_ignores_a_preconditioner(sband):
    """As in the JAX package: only a ``_pcg`` name takes the spec."""
    _, top, b = sband
    kw = dict(max_iter=8, probes=SCALARS, device="cpu")
    with_spec = port.run("pipe_pr_cg", top, b, preconditioner="jacobi", **kw)
    without = port.run("pipe_pr_cg", top, b, **kw)
    for p in SCALARS:
        np.testing.assert_array_equal(with_spec[p], without[p])
    res = port.solve(top, b, variant="pipe_pr_cg", preconditioner="jacobi",
                     max_iter=2, norm_type="none", device="cpu")
    assert res.iterations == 2


# --- (c) a _pcg name without a preconditioner is its _cg twin ---------------


@pytest.mark.parametrize("key", FAMILY_KEYS)
def test_pcg_without_preconditioner_equals_cg_twin(sband, key):
    """Bit for bit.  M = I sends the ``_pcg`` name through the generic body
    (hs: through the same fused phase), which on the CPU forms every vector
    and every dot with the same torch expressions, in the same order, as the
    plain version of the ``_cg`` twin's fused phase."""
    _, top, b = sband
    kw = dict(max_iter=ITERS + 1, probes=SCALARS + ("mu", "save_x"),
              device="cpu")
    twin = port.run(f"{key}_cg", top, b, **kw)
    pcg = port.run(f"{key}_pcg", top, b, **kw)
    for p in SCALARS + ("mu", "save_x"):
        np.testing.assert_array_equal(pcg[p], twin[p], err_msg=p)


# --- (d) tolerance solves under each norm type -----------------------------


@pytest.mark.parametrize("norm_type", ["natural", "unpreconditioned",
                                       "preconditioned", "none"])
@pytest.mark.parametrize("name", ["pr_pcg", "pipe_pr_pcg"])
def test_solve_stops_where_jax_stops(sband, name, norm_type, monkeypatch):
    """Held to the spread of the JAX package's own two paths, as
    ``test_torch_pipe_pr.py::test_solve_outcome_matches_jax`` does: under
    the natural norm its generic and fused paths stop within 2 iterations
    of each other; under the other two the norm rides the dot batch and
    only the generic body runs, so there is one JAX stop."""
    jop, top, b = sband
    kw = dict(variant=name, rtol=1e-8, max_iter=300, norm_type=norm_type,
              preconditioner="jacobi")
    if norm_type == "none":
        kw["max_iter"] = 40
    got = port.solve(top, b, device="cpu", **kw)
    want = japi.solve(jop, b, **kw)
    monkeypatch.setenv("NCGV_FULL_FUSED", "1")
    monkeypatch.setenv("NCGV_FUSED_TILE", "128")
    want_fused = japi.solve(jop, b, **kw)
    stops = (want.iterations, want_fused.iterations)
    assert got.converged and want.converged and want_fused.converged
    assert max(stops) - min(stops) <= 2, stops
    assert min(stops) - 1 <= got.iterations <= max(stops) + 1
    if norm_type == "none":
        assert got.iterations == 40 and got.norm == 0.0
        return
    assert 50 < got.iterations < 300
    # the reported norm is the requested flavour of the final residual, and
    # the tolerance is relative to the same flavour of b
    inv = 1.0 / top.data[0].numpy()
    flavour = {"natural": lambda v: np.sqrt(v @ (inv * v)),
               "unpreconditioned": np.linalg.norm,
               "preconditioned": lambda v: np.linalg.norm(inv * v)}[norm_type]
    assert got.norm <= 1e-8 * flavour(b)
    r_true = b - top.todense() @ got.x.numpy()
    np.testing.assert_allclose(flavour(r_true), got.norm, rtol=1e-3)
    cond_jacobi = 1.2e3
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=cond_jacobi * 1e-8)


@pytest.mark.parametrize("name", ["hs_pcg", "cg_pcg", "gv_pcg", "pr_pcg",
                                  "pipe_pr_pcg", "pipe_p_pcg"])
@pytest.mark.parametrize("norm_type", ["unpreconditioned", "preconditioned"])
def test_norm_in_batch_histories_match_jax(sband, name, norm_type):
    """With the norm in the dot batch every family takes its generic body
    and carries ``rho``: 25 steps of both packages' step functions."""
    jop, top, b = sband
    key = tapi.family_of(name)[0]
    jinit, jstep = japi.FAMILIES[key]
    tinit, tstep = tapi.FAMILIES[key]
    jctx = JaxContext(jop, JaxJacobi.from_operator(jop))
    tctx = Context(top, JacobiPreconditioner.from_operator(top))
    jctx.extra_norm = tctx.extra_norm = {"unpreconditioned": "r",
                                         "preconditioned": "rt"}[norm_type]
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    js = jinit(jctx, jb, jnp.zeros_like(jb))
    ts = tinit(tctx, tb, torch.zeros_like(tb))
    for _ in range(ITERS):
        js, ts = jstep(jctx, js), tstep(tctx, ts)
    for k in ("rho", "nu", "a", "b"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=RTOL,
                                   err_msg=k)
    v = ts["r"] if norm_type == "unpreconditioned" else ts["rt"]
    np.testing.assert_allclose(float(ts["rho"]), float(v @ v), rtol=1e-12)


# --- dispatch: which steps take a fused phase ------------------------------


@pytest.fixture
def fused_calls(monkeypatch):
    """Count the calls of each fused entry point and of the SpMV wrappers
    (on the CPU the launch counters stay 0, so the calls are counted)."""
    calls = {}

    def count(module, name):
        fn = getattr(module, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)

    for fn in sym_fused.FAMILY_WRAPPERS:
        count(sym_fused, fn.__name__)
    count(sym_fused, "fused_sym_pipe_full_step_scalars")
    count(sym_dia, "sym_dia_spmv")
    count(sym_dia, "sym_dia_spmv2")
    return calls


FUSED_ENTRY = {
    "hs_cg": "hs_matvec_phase", "hs_pcg": "hs_matvec_phase",
    "cg_cg": "cgcg_matvec_phase", "cg_pcg": "cgcg_matvec_phase_prec",
    "gv_cg": "gv_matvec_phase", "gv_pcg": "gv_matvec_phase_prec",
    "pr_cg": "pr_full_step", "pr_pcg": "pr_full_step_prec",
    "m_cg": "pr_full_step", "m_pcg": "pr_full_step_prec",
}
INIT_SPMVS = {"hs": 2, "cg": 3, "gv": 3, "pr": 2, "m": 2}


@pytest.mark.parametrize("name", NAMES)
def test_one_fused_call_per_iteration(sband, fused_calls, name):
    """Unpreconditioned and Jacobi runs: the family's own entry once per
    iteration (the unpreconditioned pipe names: with its scalar epilogue),
    the SpMV wrapper in init only, nothing else."""
    _, top, b = sband
    port.solve(top, b, variant=name, preconditioner=_jacobi(name),
               max_iter=7, norm_type="none", device="cpu")
    base = name.rsplit("_", 1)[0]
    entry = FUSED_ENTRY.get(name, "pipe_full_step_prec" if name.endswith("pcg")
                            else "pipe_full_step_scalars")
    assert fused_calls == {"fused_sym_" + entry: 7,
                           "sym_dia_spmv": INIT_SPMVS.get(base, 3)}


@pytest.mark.parametrize("config", ["identity", "callable", "norm_in_batch",
                                    "gv_replace"])
def test_generic_body_configurations_take_no_fused_phase(sband, fused_calls,
                                                         config):
    _, top, b = sband
    inv = 1.0 / top.data[0]
    kw = dict(max_iter=5, device="cpu")
    if config == "gv_replace":
        port.run("gv_cg", top, b, w_replace=lambda k, view: k % 2 == 0,
                 max_iter=6, probes=("nu",), device="cpu")
        # init 3; per step one mv, plus the replacement at k = 2, 4
        assert fused_calls == {"sym_dia_spmv": 3 + 5 + 2}
        return
    pre = {"identity": None, "callable": lambda v: inv * v,
           "norm_in_batch": "jacobi"}[config]
    norm = "unpreconditioned" if config == "norm_in_batch" else "none"
    res = port.solve(top, b, variant="pipe_pr_pcg", preconditioner=pre,
                     norm_type=norm, rtol=0.0, **kw)
    assert res.iterations == 5
    assert fused_calls == {"sym_dia_spmv": 3, "sym_dia_spmv2": 5}
    fused_calls.clear()
    port.solve(top, b, variant="pr_pcg", preconditioner=pre, norm_type=norm,
               rtol=0.0, **kw)
    assert fused_calls == {"sym_dia_spmv": 2 + 5}


def test_hs_fused_phase_serves_any_preconditioner(sband, fused_calls):
    _, top, b = sband
    inv = 1.0 / top.data[0]
    port.solve(top, b, variant="hs_pcg", preconditioner=lambda v: inv * v,
               max_iter=4, norm_type="none", device="cpu")
    assert fused_calls == {"fused_sym_hs_matvec_phase": 4, "sym_dia_spmv": 2}
    fused_calls.clear()
    # ... but not with the norm in the batch (the JAX rule)
    port.solve(top, b, variant="hs_pcg", preconditioner="jacobi", rtol=0.0,
               max_iter=4, norm_type="preconditioned", device="cpu")
    assert fused_calls == {"sym_dia_spmv": 2 + 4}


def test_preconditioner_is_cast_and_moved_with_the_operator(sband):
    _, top, b = sband
    pre = preconditioner_from_numpy(1.0 / top.data[0].numpy(), device="cpu")
    got = tapi.resolve("pr_pcg", top.astype(torch.float32), pre)[5]
    assert isinstance(got, JacobiPreconditioner)
    assert got.inv_diag.dtype == torch.float32
    assert isinstance(tapi.resolve("pr_pcg", top, None)[5],
                      IdentityPreconditioner)
    assert tapi.resolve("pr_cg", top, "jacobi")[5] is None
    f32 = port.run("pr_pcg", top, b, preconditioner=pre, dtype=np.float32,
                   max_iter=4, probes=("nu",), device="cpu")
    assert f32["nu"].dtype == np.float32 and np.all(np.isfinite(f32["nu"]))


# --- (e) gv residual replacement -------------------------------------------


@pytest.mark.parametrize("name", ["gv_cg", "gv_pcg"])
def test_gv_w_replace_matches_jax(spd64, sband, name):
    a, top64, b64 = spd64
    every10 = (lambda k, view: (k % 10) == 0)
    kw = dict(max_iter=80, w_replace=every10,
              probes=("updated_residual_2_norm", "nu"))
    want = japi.run("gv_cg", a, b64, dtype=jnp.float64, **kw)
    got = port.run("gv_cg", top64, b64, device="cpu", **kw)
    # past iteration ~30 the two packages' roundings part ways and gv's
    # delayed convergence ends at 1e-6 (JAX) and 4e-6 (port) of the start
    for out in (got, want):
        res = np.asarray(out["updated_residual_2_norm"])
        assert res[-1] < 1e-5 * res[0]
    np.testing.assert_allclose(got["nu"][:SPD64_ROWS],
                               np.asarray(want["nu"])[:SPD64_ROWS], rtol=RTOL)
    # with and without Jacobi on the scaled band, against JAX, and a tensor
    # answer (always-computed torch.where) equal to the Python bool's branch
    jop, top, b = sband
    kw = dict(max_iter=ITERS + 1, probes=SCALARS, preconditioner=_jacobi(name))
    want = japi.run(name, jop, b, w_replace=every10, **kw)
    got = port.run(name, top, b, w_replace=every10, device="cpu", **kw)
    plain = port.run(name, top, b, device="cpu", **kw)
    where = port.run(name, top, b, device="cpu",
                     w_replace=lambda k, view: torch.tensor(k % 10 == 0), **kw)
    _assert_histories(got, want)
    for p in SCALARS:
        np.testing.assert_array_equal(where[p], got[p])
    assert not np.array_equal(plain["nu"][11:], got["nu"][11:])


def test_gv_w_replace_stateful_matches_jax(spd64):
    """The doubling-interval policy of ``tests/test_variants.py``: replace
    at k = 5, 15, 35, 75; the hook's state rides the solver state."""
    a, top, b = spd64

    def jax_policy(k, view, st):
        do = k >= st["next_k"]
        return do, dict(
            next_k=jnp.where(do, st["next_k"] + st["interval"], st["next_k"]),
            interval=jnp.where(do, 2 * st["interval"], st["interval"]),
            count=st["count"] + do.astype(jnp.int32))

    def port_policy(k, view, st):
        do = k >= st["next_k"]
        if not do:
            return do, st
        return do, dict(next_k=st["next_k"] + st["interval"],
                        interval=2 * st["interval"], count=st["count"] + 1)

    kw = dict(max_iter=80, probes=("updated_residual_2_norm", "nu"))
    want = japi.run("gv_cg", a, b, dtype=jnp.float64, w_replace=jax_policy,
                    w_replace_init=dict(next_k=np.int32(5),
                                        interval=np.int32(10),
                                        count=np.int32(0)), **kw)
    init = dict(next_k=5, interval=10, count=0)
    got = port.run("gv_cg", top, b, device="cpu", w_replace=port_policy,
                   w_replace_init=init, **kw)
    res = got["updated_residual_2_norm"]
    assert res[-1] < 1e-4 * res[0]
    np.testing.assert_allclose(got["nu"][:SPD64_ROWS],
                               np.asarray(want["nu"])[:SPD64_ROWS], rtol=RTOL)
    init_fn, step_fn = tapi.resolve("gv_cg", top, None, w_replace=port_policy,
                                    w_replace_init=init)[3:5]
    ctx = Context(top)
    tb = torch.from_numpy(b)
    st = init_fn(ctx, tb, torch.zeros_like(tb))
    for _ in range(40):
        st = step_fn(ctx, st)
    assert st["wrep"] == dict(next_k=75, interval=80, count=3)
    assert init == dict(next_k=5, interval=10, count=0)


# --- (f) a JAX state carried into the port ---------------------------------


@pytest.mark.parametrize("name", ["hs_pcg", "cg_pcg", "gv_pcg", "pr_pcg",
                                  "m_pcg", "pipe_p_pcg", "pipe_pr_pcg",
                                  "hs_cg", "cg_cg", "gv_cg", "m_cg"])
def test_state_carried_across_matches_jax(sband, name):
    """A JAX state after init and 5 steps, carried into the port, takes the
    same next 10 steps in both packages (tilde vectors and eta included)."""
    jop, top, b = sband
    key, prec = tapi.family_of(name)
    jinit, jstep = japi.FAMILIES[key]
    _, tstep = tapi.FAMILIES[key]
    jctx = JaxContext(jop, JaxJacobi.from_operator(jop) if prec else None)
    tctx = Context(top, JacobiPreconditioner.from_operator(top) if prec
                   else None)
    jb = jnp.asarray(b)
    js = jinit(jctx, jb, jnp.zeros_like(jb))
    for _ in range(5):
        js = jstep(jctx, js)
    state = state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                             device="cpu")
    assert state["k"] == 5 and set(state) == set(js)
    for _ in range(10):
        js, state = jstep(jctx, js), tstep(tctx, state)
    got = state_to_numpy(state)
    assert got["k"] == int(js["k"]) == 15 and set(got) == set(js)
    for k, want in js.items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            got[k], want, rtol=RTOL,
            atol=RTOL * np.abs(want).max() if want.ndim else 0, err_msg=k)


def test_state_conversion_carries_rho_and_wrep():
    state = {"x": np.ones(4), "rho": np.float64(2.5), "k": np.int32(3),
             "wrep": {"next_k": np.int32(5), "flag": np.bool_(True),
                      "scale": np.float64(0.5)}}
    t = state_from_numpy(state, dtype=torch.float32, device="cpu")
    assert t["k"] == 3 and t["rho"].dtype == torch.float32
    assert t["wrep"]["next_k"].dtype == torch.int32
    assert t["wrep"]["flag"].dtype == torch.bool
    assert t["wrep"]["scale"].dtype == torch.float32
    back = state_to_numpy(t)
    assert back["k"] == np.int32(3) and back["rho"] == np.float32(2.5)
    assert back["wrep"]["next_k"] == 5 and bool(back["wrep"]["flag"])
    # a hook state of plain Python values survives too
    assert state_to_numpy({"wrep": {"count": 3}})["wrep"]["count"] == 3


# --- probes and progress lines ---------------------------------------------


@pytest.mark.parametrize("name", ["pr_pcg", "gv_pcg", "pipe_pr_pcg"])
def test_every_probe_on_a_preconditioned_state(sband, name):
    jop, top, b = sband
    x_true = np.ones(b.shape[0])
    kw = dict(max_iter=12, probes=tuple(PROBES), preconditioner="jacobi",
              x_true=x_true)
    want = japi.run(name, jop, b, **kw)
    got = port.run(name, top, b, device="cpu", **kw)
    for p in PROBES:
        w = np.asarray(want[p])
        assert got[p].shape == w.shape
        np.testing.assert_allclose(got[p], w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=p)
    # x_true worked out on the host when it is not given
    auto = port.run(name, top, b, device="cpu", max_iter=3,
                    probes=("error_A_norm",), preconditioner="jacobi")
    np.testing.assert_allclose(auto["error_A_norm"], got["error_A_norm"][:3],
                               rtol=1e-8)


def test_print_every_reads_nu_back_every_k_iterations(sband, capsys):
    _, top, b = sband
    out = port.run("pr_pcg", top, b, preconditioner="jacobi", max_iter=10,
                   probes=("nu",), print_every=4, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["iter 4", "iter 8"]
    assert float(lines[0].split("= ")[1]) == pytest.approx(
        np.sqrt(out["nu"][4]), rel=1e-12)
    port.run("pr_pcg", top, b, max_iter=10, probes=("nu",), device="cpu")
    assert capsys.readouterr().out == ""
