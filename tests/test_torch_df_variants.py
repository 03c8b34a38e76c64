"""Port parity, end to end: every CG variant in the double-word mode.

``run(..., dtype="f32x2")`` and ``solve(..., dtype="f32x2")`` of the port (its
plain versions on the CPU) against the JAX package's (compiled with XLA's
fusion pass off, as its f32x2 mode runs), on the same float64 problems made
with numpy:

* every name on full-DIA storage: the unpreconditioned names on
  ``banded_model(512, k=4, kappa=100, fmt="dia")``, the ``_pcg`` names with
  Jacobi on the scaled band of ``test_torch_variants.py`` (on the model
  problem Jacobi converges within six iterations);
* every name on ``make_spd(64)`` as a dense array, and on a
  ``SymDiaOperator`` (expanded to its full band before the split);
* collapsed nu and alpha histories over 25 iterations to rtol 1e-10 (they
  agree bit for bit, both packages taking the same roundings);
* the accuracy outcomes of the JAX package's own f32x2 tests, the gv
  replacement hook (stateless, stateful, and a tensor answer), user
  preconditioners, the four norm types, the probes, and scipy, ``CooMatrix``
  and ELL input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_spd

import new_cg_variants_tpu as cgt
from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops import doublefloat as jdf
from new_cg_variants_tpu.ops.operators import DiaOperator as JaxDia
from new_cg_variants_tpu.ops.sym_dia import SymDiaOperator as JaxSymDia
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.ops import doublefloat as tdf
from test_torch_compensated import scaled_band_dia
from test_torch_variants import scaled_band

ITERS = 25
RTOL = 1e-10
NAMES = port.VARIANT_NAMES


def _spec(name):
    return "jacobi" if name.endswith("pcg") else None


def _histories(jA, tA, b, name, **kw):
    kw = dict(max_iter=ITERS + 1, probes=("nu", "alpha"), dtype="f32x2",
              preconditioner=_spec(name), **kw)
    return cgt.run(name, jA, b, **kw), port.run(name, tA, b, device="cpu",
                                                **kw)


def _assert_same_history(want, got):
    for p in ("nu", "alpha"):
        assert got[p].dtype == np.float32
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL)


@pytest.fixture(scope="module")
def dia_problems():
    jop, b, x_true = jax_banded(512, k=4, kappa=100.0, fmt="dia")
    top = operator_from_numpy(jop.offsets, np.asarray(jop.data), kind="dia",
                              device="cpu")
    offsets, data = scaled_band_dia()
    sop = port.DiaOperator(offsets, torch.from_numpy(data))
    return {"model": (jop, top, b, x_true),
            "scaled": (JaxDia(offsets, jnp.asarray(data)), sop,
                       sop.todense() @ np.ones(sop.n))}


@pytest.mark.parametrize("name", NAMES)
def test_every_name_on_dia_matches_jax(dia_problems, name):
    if name.endswith("pcg"):
        jop, top, b = dia_problems["scaled"]
    else:
        jop, top, b, _ = dia_problems["model"]
    want, got = _histories(jop, top, b, name)
    _assert_same_history(want, got)
    assert got["x"].dtype == torch.float64


@pytest.mark.parametrize("name", NAMES)
def test_every_name_on_a_dense_array_matches_jax(name):
    a = make_spd(64)
    b = a @ np.ones(64)
    want, got = _histories(a, a, b, name)
    _assert_same_history(want, got)


@pytest.mark.parametrize("problem,name", [
    ("model", "pipe_pr_cg"), ("model", "gv_cg"), ("scaled", "hs_pcg"),
    ("scaled", "pipe_pr_pcg")])
def test_symdia_input_is_expanded_and_matches_jax(problem, name):
    if problem == "model":
        jop, b, _ = jax_banded(512, k=4, kappa=100.0, fmt="symdia")
        offsets, data = jop.offsets, np.asarray(jop.data)
    else:
        offsets, data = scaled_band()
        jop = JaxSymDia(offsets, jnp.asarray(data))
    sym = operator_from_numpy(offsets, data, device="cpu")
    if problem == "scaled":
        b = sym.todia_host()[1].sum(axis=0)  # A @ 1: explicit zeros off A
    want, got = _histories(jop, sym, b, name)
    _assert_same_history(want, got)
    offsets, full = sym.todia_host()
    dia = port.DiaOperator(offsets, torch.from_numpy(full))
    again = port.run(name, dia, b, max_iter=ITERS + 1, probes=("nu", "alpha"),
                     dtype="f32x2", preconditioner=_spec(name), device="cpu")
    np.testing.assert_array_equal(again["nu"], got["nu"])


def test_f32x2_unpreconditioned_run():
    """JAX's ``test_f32x2_unpreconditioned_run`` (on the DIA form of its
    problem; the dense form is held to JAX above): the best relative A-norm
    error falls below 1e-10 within 120 iterations."""
    op, b, x_true = port.banded_model(512, k=4, kappa=100.0, fmt="dia",
                                      device="cpu")
    out = port.run("pipe_pr_cg", op, b, max_iter=120,
                   probes=("error_A_norm", "nu"), x_true=x_true, dtype="f32x2",
                   device="cpu")
    rel = out["error_A_norm"] / out["error_A_norm"][0]
    assert np.nanmin(rel) < 1e-10
    assert np.isfinite(out["nu"]).all()


def test_f32x2_solve_path():
    """JAX's ``test_f32x2_solve_path`` (DIA form), and the same stop and
    solution as JAX's solve."""
    jop, b, x_true = jax_banded(512, k=4, kappa=100.0, fmt="dia")
    op = operator_from_numpy(jop.offsets, np.asarray(jop.data), kind="dia",
                             device="cpu")
    res = port.solve(op, b, variant="pipe_pr_cg", rtol=1e-10, max_iter=500,
                     dtype="f32x2", device="cpu")
    assert res.converged
    assert res.x.dtype == torch.float64 and res.x.device.type == "cpu"
    err = np.linalg.norm(res.x.numpy() - x_true) / np.linalg.norm(x_true)
    assert err < 1e-8, err
    want = cgt.solve(jop, b, variant="pipe_pr_cg", rtol=1e-10, max_iter=500,
                     dtype="f32x2")
    assert res.iterations == want.iterations
    np.testing.assert_allclose(res.x.numpy(), want.x, rtol=1e-12)


@pytest.mark.parametrize("norm_type", ["natural", "unpreconditioned",
                                       "preconditioned", "none"])
@pytest.mark.parametrize("name", ["pipe_pr_pcg", "hs_pcg", "pr_cg"])
def test_four_norm_types_match_jax(dia_problems, norm_type, name):
    jop, top, b = dia_problems["scaled"]
    kw = dict(variant=name, rtol=1e-9, max_iter=400, norm_type=norm_type,
              dtype="f32x2", preconditioner=_spec(name))
    want = cgt.solve(jop, b, **kw)
    got = port.solve(top, b, device="cpu", **kw)
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    if norm_type == "none":
        assert got.iterations == 400
    else:
        np.testing.assert_allclose(got.norm, want.norm, rtol=1e-6)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=1e-10, atol=1e-12)


def test_probes_match_jax(dia_problems):
    jop, top, b, x_true = dia_problems["model"]
    probes = ("error_A_norm", "error_2_norm", "residual_2_norm",
              "updated_residual_2_norm", "mu", "beta", "save_x", "save_r")
    kw = dict(max_iter=ITERS + 1, probes=probes, x_true=x_true, dtype="f32x2")
    want = cgt.run("pr_cg", jop, b, **kw)
    got = port.run("pr_cg", top, b, device="cpu", **kw)
    for p in probes:
        assert got[p].shape == np.asarray(want[p]).shape, p
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL, atol=1e-30,
                                   err_msg=p)
    # without x_true the direct solve supplies it (float64, from the words)
    again = port.run("pr_cg", top, b, max_iter=ITERS + 1,
                     probes=("error_A_norm",), dtype="f32x2", device="cpu")
    np.testing.assert_allclose(again["error_A_norm"], got["error_A_norm"],
                               rtol=1e-6)


def test_w_replace_matches_jax(dia_problems):
    jop, top, b = dia_problems["scaled"]
    want, got = _histories(jop, top, b, "gv_pcg",
                           w_replace=lambda k, view: (k % 10) == 0)
    _assert_same_history(want, got)
    # the replacement moves the iterate (below the float32 resolution of
    # the collapsed probe rows, not of the double-word x)
    plain = port.run("gv_pcg", top, b, max_iter=ITERS + 1, probes=(),
                     dtype="f32x2", preconditioner="jacobi", device="cpu")
    assert not torch.equal(plain["x"], got["x"])
    # a tensor answer selects in double words, with the same history
    tens = port.run("gv_pcg", top, b, max_iter=ITERS + 1,
                    probes=("nu", "alpha"), dtype="f32x2",
                    preconditioner="jacobi", device="cpu",
                    w_replace=lambda k, view: torch.tensor(k % 10 == 0))
    _assert_same_history(got, tens)


def test_w_replace_stateful_matches_jax(dia_problems):
    jop, top, b, _ = dia_problems["model"]

    def jax_policy(k, view, st):
        do = k >= st["next_k"]
        return do, dict(next_k=jnp.where(do, st["next_k"] + 10, st["next_k"]),
                        count=st["count"] + do.astype(jnp.int32))

    def port_policy(k, view, st):
        do = k >= st["next_k"]
        return do, dict(next_k=st["next_k"] + 10 if do else st["next_k"],
                        count=st["count"] + int(do))

    kw = dict(max_iter=ITERS + 1, probes=("nu", "alpha"), dtype="f32x2")
    want = cgt.run("gv_cg", jop, b, w_replace=jax_policy,
                   w_replace_init=dict(next_k=np.int32(5), count=np.int32(0)),
                   **kw)
    got = port.run("gv_cg", top, b, w_replace=port_policy,
                   w_replace_init=dict(next_k=5, count=0), device="cpu", **kw)
    _assert_same_history(want, got)


def test_user_preconditioners_match_jax(dia_problems):
    """A DFJacobi of a custom inverse diagonal and a raw double-word callable
    (JAX's ``test_f32x2_user_preconditioner``), against the same objects in
    the JAX package, and near the built-in Jacobi."""
    jop, top, b = dia_problems["scaled"]
    inv = 1.0 / np.diag(top.todense())
    cases = {
        "object": (jdf.DFJacobi(jdf.df_split(inv)),
                   tdf.DFJacobi(tdf.df_split(inv, device="cpu"))),
        "callable": ((lambda v, s=jdf.df_split(inv): s * v),
                     (lambda v, s=tdf.df_split(inv, device="cpu"): s * v)),
    }
    builtin = port.run("hs_pcg", top, b, max_iter=ITERS + 1, probes=("nu",),
                       dtype="f32x2", preconditioner="jacobi", device="cpu")
    for label, (jpre, tpre) in cases.items():
        kw = dict(max_iter=ITERS + 1, probes=("nu", "alpha"), dtype="f32x2")
        want = cgt.run("hs_pcg", jop, b, preconditioner=jpre, **kw)
        got = port.run("hs_pcg", top, b, preconditioner=tpre, device="cpu",
                       **kw)
        _assert_same_history(want, got)
        np.testing.assert_allclose(got["nu"][:20], builtin["nu"][:20],
                                   rtol=1e-6, err_msg=label)
    ident = port.run("pr_pcg", top, b, max_iter=5, probes=("nu",),
                     dtype="f32x2", preconditioner="identity", device="cpu")
    none = port.run("pr_cg", top, b, max_iter=5, probes=("nu",),
                    dtype="f32x2", device="cpu")
    np.testing.assert_array_equal(ident["nu"], none["nu"])
    with pytest.raises(ValueError):
        port.run("pr_pcg", top, b, max_iter=2, dtype="f32x2",
                 preconditioner="ilu", device="cpu")


def test_print_every_reads_collapsed_values(dia_problems, capsys):
    jop, top, b, _ = dia_problems["model"]
    port.run("pipe_pr_cg", top, b, max_iter=11, dtype="f32x2",
             print_every=5, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["iter 5", "iter 10"]


@pytest.mark.parametrize("what", ["scipy", "coo", "ell"])
@pytest.mark.parametrize("entry", ["run", "solve"])
def test_unported_inputs_raise(what, entry):
    """scipy, ``CooMatrix`` and ELL input, which raised naming ROADMAP item
    1.5 before the format layer was ported, now run in double words as the
    JAX package runs them: equal histories (``run``), equal iterates
    (``solve``)."""
    from test_torch_doublefloat import both_coo, sparse_spd

    from new_cg_variants_tpu.ops import operators as jo

    a = sparse_spd(n=300)
    b = a @ np.ones(a.shape[0])
    jc, tc = both_coo(a)
    jA, tA = {"scipy": (a, a), "coo": (jc, tc),
              "ell": (jo.from_coo(jc, fmt="ell"),
                      port.from_coo(tc, fmt="ell", device="cpu"))}[what]
    if entry == "run":
        want, got = _histories(jA, tA, b, "pipe_pr_cg")
        _assert_same_history(want, got)
    else:
        kw = dict(max_iter=12, dtype="f32x2", norm_type="none")
        got = port.solve(tA, b, device="cpu", **kw)
        want = cgt.solve(jA, b, **kw)
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))


def test_f32x2_beats_float32_where_float32_stalls():
    """The point of the mode: at kappa = 1e6 float32 stalls near 1e-6
    relative A-norm error while double words go on to 1e-13 (float64:
    5e-15) within 300 iterations."""
    op, b, x_true = port.model_spectrum(512, kappa=1e6, rho=0.5, device="cpu")
    kw = dict(max_iter=300, probes=("error_A_norm",), x_true=x_true,
              device="cpu")
    f32 = port.run("pipe_pr_cg", op.astype(torch.float32), b, **kw)
    df = port.run("pipe_pr_cg", op, b, dtype="f32x2", **kw)
    best32 = np.nanmin(f32["error_A_norm"] / f32["error_A_norm"][0])
    bestdf = np.nanmin(df["error_A_norm"] / df["error_A_norm"][0])
    assert best32 > 1e-7 and bestdf < 1e-10, (best32, bestdf)
