"""Port parity, end to end: every CG variant on full-DIA and dense operators.

The same problems go through the JAX package and the port, in float64 on the
CPU; ``_pcg`` names run with ``preconditioner="jacobi"``.  The problems are
those of ``test_torch_variants.py`` in their full-DIA form (both triangles
stored), built with numpy and handed to both packages:

* ``banded_model(4096, k=32, fmt="dia")``, the JAX package's default model
  problem.  Unpreconditioned histories are held over 25 iterations; with
  Jacobi the problem is solved within six iterations and only nu and alpha of
  iterations 0-2 and the final solution are held (the limits that
  ``test_torch_variants.py`` states).
* the scaled band ``D^1/2 T D^1/2`` (n = 512, half-band 4), on which Jacobi
  leaves a condition number near 1e3: every name over 25 iterations against
  the JAX generic bodies, and also against its fused Pallas kernels on
  full-DIA storage in interpret mode (tile 128).
* ``make_spd(64)`` of ``tests/conftest.py`` as a dense operator, held over
  iterations 0-19 (from 20 on a rounding difference grows a hundredfold per
  iteration).

Scalar histories agree to rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_spd

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops.operators import DiaOperator as JaxDia
from new_cg_variants_tpu.solvers import api as japi
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.ops import (
    fused_family,
    fused_step,
    spmv_dia,
    sym_fused,
)
from new_cg_variants_tpu_torch.solvers.context import Context
from test_torch_variants import scaled_band

ITERS = 25
SPD64_ROWS = 20
RTOL = 1e-10
SCALARS = ("nu", "mu", "alpha", "beta")
NAMES = port.VARIANT_NAMES


def _jacobi(name):
    return "jacobi" if name.endswith("pcg") else None


def full_dia(offsets, data):
    """The full-DIA form of a half-band operator, through the port's own
    exact conversion (``SymDiaOperator.todia_host``)."""
    sym = operator_from_numpy(offsets, data, device="cpu")
    return sym.todia_host()


@pytest.fixture(scope="module")
def model():
    jop, b, x_true = jax_banded(4096, k=32)
    top = operator_from_numpy(jop.offsets, np.asarray(jop.data), kind="dia",
                              device="cpu")
    return jop, top, b, x_true


@pytest.fixture(scope="module")
def sband():
    offsets, data = full_dia(*scaled_band())
    jop = JaxDia(offsets, jnp.asarray(data))
    top = operator_from_numpy(offsets, data, kind="dia", device="cpu")
    b = top.todense() @ np.ones(data.shape[1])
    return jop, top, b


@pytest.fixture(scope="module")
def spd64():
    a = make_spd(64)
    return a, operator_from_numpy(None, a, kind="dense", device="cpu"), \
        a @ np.ones(64)


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


def test_full_dia_form_is_the_same_matrix(sband):
    offsets, data = scaled_band()
    sym = operator_from_numpy(offsets, data, device="cpu")
    _, top, _ = sband
    assert top.offsets == tuple(range(-4, 5))
    np.testing.assert_array_equal(top.todense(), sym.todense())
    np.testing.assert_array_equal(top.diagonal().numpy(),
                                  sym.diagonal().numpy())


@pytest.mark.parametrize("name", NAMES)
def test_histories_on_banded_model_dia(model, name):
    jop, top, b, x_true = model
    got, want = _histories(jop, top, b, name)
    if not name.endswith("pcg"):
        _assert_histories(got, want)
        return
    _assert_histories(got, want, rows=3, scalars=("nu", "alpha"))
    for x in (got["x"].numpy(), np.asarray(want["x"])):
        np.testing.assert_allclose(x, x_true, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_histories_on_scaled_band_dia(sband, name):
    got, want = _histories(*sband, name)
    _assert_histories(got, want)
    # not converged: every row compared is a row of the descent
    assert got["nu"][-1] > 1e-6 * got["nu"][0]


@pytest.mark.parametrize("name", NAMES)
def test_pipe_histories_against_jax_fused_kernels(sband, name, monkeypatch):
    """The JAX package's fused Pallas kernels on full-DIA storage
    (``fused_pipe_full_step``, its Jacobi twin and the entries of
    ``ops/fused_family.py``) in interpret mode, every name."""
    monkeypatch.setenv("NCGV_FULL_FUSED", "1")
    monkeypatch.setenv("NCGV_FUSED_TILE", "128")
    got, want = _histories(*sband, name)
    _assert_histories(got, want)


@pytest.mark.parametrize("name", ["hs_cg", "pr_pcg", "pipe_pr_cg"])
def test_histories_on_a_dense_operator(spd64, name):
    a, top, b = spd64
    got, want = _histories(a, top, b, name, dtype=jnp.float64)
    _assert_histories(got, want, rows=SPD64_ROWS)
    # a plain array is taken as well (as_operator)
    again = port.run(name, a, b, max_iter=ITERS + 1, probes=SCALARS,
                     preconditioner=_jacobi(name), device="cpu")
    for p in SCALARS:
        np.testing.assert_array_equal(again[p], got[p])


@pytest.mark.parametrize("norm_type", ["natural", "unpreconditioned",
                                       "preconditioned", "none"])
@pytest.mark.parametrize("name", ["pr_pcg", "pipe_pr_pcg"])
def test_solve_on_dia_stops_where_jax_stops(sband, name, norm_type):
    jop, top, b = sband
    kw = dict(variant=name, rtol=1e-8, max_iter=300, norm_type=norm_type,
              preconditioner="jacobi")
    if norm_type == "none":
        kw["max_iter"] = 40
    got = port.solve(top, b, device="cpu", **kw)
    want = japi.solve(jop, b, **kw)
    assert got.converged and want.converged
    # JAX's own two paths stop within 2 iterations of each other
    # (test_torch_variants.py); the port is held to the same spread
    assert abs(got.iterations - want.iterations) <= 2
    if norm_type == "none":
        assert got.iterations == 40 and got.norm == 0.0
        return
    assert 50 < got.iterations < 300
    inv = 1.0 / top.diagonal().numpy()
    flavour = {"natural": lambda v: np.sqrt(v @ (inv * v)),
               "unpreconditioned": np.linalg.norm,
               "preconditioned": lambda v: np.linalg.norm(inv * v)}[norm_type]
    assert got.norm <= 1e-8 * flavour(b)
    r_true = b - top.todense() @ got.x.numpy()
    np.testing.assert_allclose(flavour(r_true), got.norm, rtol=1e-3)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1.2e3 * 1e-8)


def test_error_probe_works_out_x_true_on_each_kind(sband, spd64):
    """``_compute_x_true`` goes through ``todense`` / ``tocsr`` of the
    operator: small operators densely, n >= 4096 through scipy's sparse LU."""
    _, top, b = sband
    out = port.run("pr_cg", top, b, max_iter=3, probes=("error_A_norm",),
                   device="cpu")
    given = port.run("pr_cg", top, b, max_iter=3, probes=("error_A_norm",),
                     x_true=np.ones(top.n), device="cpu")
    np.testing.assert_allclose(out["error_A_norm"], given["error_A_norm"],
                               rtol=1e-8)
    a, dense, bd = spd64
    out = port.run("hs_cg", dense, bd, max_iter=3, probes=("error_A_norm",),
                   device="cpu")
    assert np.all(np.diff(out["error_A_norm"]) < 0)
    big, bb, x_true = port.banded_model(4096, k=4, kappa=100.0, fmt="dia",
                                        device="cpu")
    out = port.run("hs_cg", big, bb, max_iter=3, probes=("error_A_norm",),
                   device="cpu")
    given = port.run("hs_cg", big, bb, max_iter=3, probes=("error_A_norm",),
                     x_true=x_true, device="cpu")
    np.testing.assert_allclose(out["error_A_norm"], given["error_A_norm"],
                               rtol=1e-8)


# --- dispatch: which kernel entry each step reaches, per operator kind -------


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count the calls of every kernel wrapper (on the CPU the launch
    counters stay 0, so the calls are counted)."""
    calls = {}

    def count(module, name):
        fn = getattr(module, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)

    for fn in sym_fused.FAMILY_WRAPPERS:
        count(sym_fused, fn.__name__)
    for fn in fused_step.FUSED_STEP_WRAPPERS:
        count(fused_step, fn.__name__)
    for fn in fused_family.FUSED_FAMILY_WRAPPERS:
        count(fused_family, fn.__name__)
    for fn in spmv_dia.DIA_WRAPPERS:
        count(spmv_dia, fn.__name__)
    return calls


#: the fused entry each family calls once per iteration on a qualifying
#: ``DiaOperator`` (``_pcg``: its Jacobi twin; hs has one entry for both), and
#: its SpMV calls in init
DIA_ENTRY = {"hs": ("fused_hs_matvec_phase", 2),
             "cg": ("fused_cgcg_matvec_phase", 3),
             "gv": ("fused_gv_matvec_phase", 3),
             "pr": ("fused_pr_full_step", 2),
             "m": ("fused_pr_full_step", 2),
             "pipe_p": ("fused_pipe_full_step", 3),
             "pipe_pr": ("fused_pipe_full_step", 3),
             "pipe_p_m": ("fused_pipe_full_step", 3),
             "pipe_pr_m": ("fused_pipe_full_step", 3)}
#: SpMV calls in init and per iteration of each family's generic body
GENERIC_SPMVS = {"hs": (2, 1), "cg": (3, 1), "gv": (3, 1), "pr": (2, 1),
                 "m": (2, 1)}
STEPS = 7


@pytest.mark.parametrize("name", NAMES)
def test_dia_operator_kernel_calls_per_iteration(sband, kernel_calls, name):
    """On a ``DiaOperator`` whose band the full-DIA family kernel takes, every
    name calls its own fused entry once per iteration (``_pcg`` with Jacobi:
    the Jacobi twin) and the SpMV in init only, as on half-band storage."""
    _, top, b = sband
    port.solve(top, b, variant=name, preconditioner=_jacobi(name),
               max_iter=STEPS, norm_type="none", device="cpu")
    base, kind = name.rsplit("_", 1)
    entry, init = DIA_ENTRY[base]
    if kind == "pcg" and base != "hs":
        entry += "_prec"
    assert kernel_calls == {"dia_spmv": init, entry: STEPS}


@pytest.mark.parametrize("name", ["hs_cg", "cg_pcg", "gv_cg", "pr_pcg",
                                  "m_cg"])
def test_wide_band_takes_the_generic_body(kernel_calls, name):
    """Offsets the family kernel does not take: the generic body, one SpMV
    kernel call per product."""
    top, b, _ = wide_band()
    port.solve(top, b, variant=name, preconditioner=_jacobi(name),
               max_iter=STEPS, norm_type="none", device="cpu")
    init, per = GENERIC_SPMVS[name.rsplit("_", 1)[0]]
    assert kernel_calls == {"dia_spmv": init + per * STEPS}


def wide_band():
    """A 5-diagonal operator whose offsets the family kernel does not take."""
    n, far = 2048, 600
    rng = np.random.default_rng(0)
    offsets = (-far, -1, 0, 1, far)
    data = np.zeros((5, n))
    data[2] = 4.0 + rng.uniform(0.0, 1.0, n)
    data[1, 1:] = data[3, :-1] = -1.0
    data[0, far:] = data[4, :-far] = -1.0
    top = operator_from_numpy(offsets, data, kind="dia", device="cpu")
    assert not fused_step.supports_full_step(offsets)
    return top, top.todense() @ np.ones(n), JaxDia(offsets, jnp.asarray(data))


@pytest.mark.parametrize("name", ["pipe_pr_cg", "pipe_p_cg", "pipe_pr_pcg",
                                  "pipe_p_pcg"])
def test_wide_band_takes_the_split_formulation(kernel_calls, name):
    """Offsets the whole-iteration kernel does not take: vector-phase kernel,
    then the SpMV kernel, with the same histories as the fused step's plain
    version gives on the same matrix."""
    top, b, jop = wide_band()
    out = port.run(name, top, b, max_iter=STEPS + 1, probes=SCALARS,
                   preconditioner=_jacobi(name), device="cpu")
    recompute = "pipe_pr" in name
    phase = ("fused_pipe_vector_phase_prec" if name.endswith("pcg")
             else "fused_pipe_vector_phase")
    want = {"dia_spmv": 3 + (0 if recompute else STEPS), phase: STEPS}
    if recompute:
        want["dia_spmv2"] = STEPS
    assert kernel_calls == want
    ref = japi.run(name, jop, b, max_iter=STEPS + 1, probes=SCALARS,
                   preconditioner=_jacobi(name))
    for p in SCALARS:
        np.testing.assert_allclose(out[p], np.asarray(ref[p]), rtol=RTOL)


def test_norm_in_the_dot_batch_takes_the_generic_body(sband, kernel_calls):
    _, top, b = sband
    res = port.solve(top, b, variant="pipe_pr_pcg", preconditioner="jacobi",
                     norm_type="unpreconditioned", rtol=0.0, max_iter=5,
                     device="cpu")
    assert res.iterations == 5
    assert kernel_calls == {"dia_spmv": 3, "dia_spmv2": 5}


def test_vector_phase_prec_serves_any_preconditioner(sband, kernel_calls):
    _, top, b = sband
    inv = 1.0 / top.diagonal()
    kw = dict(variant="pipe_pr_pcg", max_iter=4, norm_type="none",
              device="cpu")
    port.solve(top, b, preconditioner=lambda v: inv * v, **kw)
    assert kernel_calls == {"dia_spmv": 3, "dia_spmv2": 4,
                            "fused_pipe_vector_phase_prec": 4}
    kernel_calls.clear()
    port.solve(top, b, preconditioner=None, **kw)  # M = I
    assert kernel_calls == {"dia_spmv": 3, "dia_spmv2": 4,
                            "fused_pipe_vector_phase_prec": 4}


@pytest.mark.parametrize("name", ["hs_cg", "cg_pcg", "gv_cg", "pr_pcg",
                                  "pipe_pr_cg", "pipe_p_pcg"])
def test_dense_operator_reaches_no_kernel(spd64, kernel_calls, name):
    _, top, b = spd64
    res = port.solve(top, b, variant=name, preconditioner=_jacobi(name),
                     max_iter=5, norm_type="none", device="cpu")
    assert res.iterations == 5 and kernel_calls == {}


def test_context_choice_reads_the_operator_kind_only(sband, spd64):
    """The hooks answer from the operator's kind and the configuration, on
    the CPU as on the card: no hook looks at the device."""
    _, dia, b = sband
    sym = operator_from_numpy(*scaled_band(), device="cpu")
    dense = spd64[1]
    tb = torch.from_numpy(b)
    state = {k: tb for k in "x r w u p s rt st wt ut".split()}
    one = torch.tensor(1.0, dtype=torch.float64)
    wide = wide_band()[0]
    for op, full, vec_prec in ((sym, True, False), (dia, True, True),
                               (wide, False, True), (dense, False, False)):
        n = op.n
        s_ = {k: v[:n] for k, v in state.items()}
        ctx = Context(op, port.make_preconditioner("jacobi", op))
        assert (Context(op).pipe_full_step(s_, one, one, True) is not None) \
            == full
        assert (ctx.pipe_vector_phase_prec(s_, one, one) is not None) \
            == vec_prec
        assert (ctx.pipe_full_step_prec(s_, one, one, True) is not None) \
            == full
        assert (Context(op).pr_full_step(s_, one, one) is not None) == full
        assert (Context(op).hs_matvec_phase(s_["r"], s_["p"], one)
                is not None) == full
        assert (ctx.gv_matvec_phase_prec(s_, one) is not None) == full
        # a kernel that applies inv_diag itself serves Jacobi only
        other = Context(op, port.make_preconditioner(lambda v: v, op))
        assert other.cgcg_matvec_phase_prec(s_, one) is None
        assert other.pipe_full_step_prec(s_, one, one, True) is None
        ctx.extra_norm = "r"
        assert ctx.pipe_vector_phase_prec(s_, one, one) is None
