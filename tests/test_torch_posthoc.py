"""Port parity: the post-hoc probes (``probes/posthoc.py``).

``updated_error_A_norm`` and ``lanczos_recurrence`` derive their quantities
on the host from a run's saved histories.  Held here:

* the port's functions against the JAX package's on the same histories and
  the same matrix (a port operator beside the JAX one, dense below 4096 rows
  and through the sparse LU from 4096), to rtol 1e-12;
* the JAX package's own assertions (``tests/test_posthoc.py``: the
  reference callbacks' definitions recomputed in numpy), on histories from
  the port's ``run(device="cpu")`` in float64;
* a history or a matrix handed over as a tensor gives the numpy result.
"""

import numpy as np
import pytest
import torch

import new_cg_variants_tpu as cgt
from new_cg_variants_tpu.ops.operators import as_operator as jax_operator
from new_cg_variants_tpu.probes import posthoc as jph
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.probes import posthoc

from conftest import make_spd

RTOL = 1e-12
LANCZOS_KEYS = ("lanczos_z", "lanczos_alpha", "lanczos_beta",
                "lanczos_3_term_error", "lanczos_orthogonality")


def _histories(a, b, max_iter, name="hs_cg"):
    return port.run(name, a, b, max_iter=max_iter,
                    probes=("save_r", "save_x", "alpha", "beta"),
                    dtype=torch.float64, device="cpu")


def _pair(kind):
    """(port operator, JAX operator, b) of one matrix."""
    if kind == "dense":
        a = make_spd(48, cond=100.0, seed=3)
        b = a @ np.linspace(0.5, 1.5, 48)
        return port.as_operator(a, device="cpu"), jax_operator(a), b
    top, b, _ = port.banded_model(4096, k=4, kappa=100.0, device="cpu")
    jop, _, _ = cgt.banded_model(4096, k=4, kappa=100.0, fmt="symdia")
    return top, jop, b


def _close(got, want):
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("kind", ["dense", "banded-4096"])
def test_updated_error_A_norm_matches_jax(kind):
    top, jop, b = _pair(kind)
    hist = _histories(top, b, 30)
    got = posthoc.updated_error_A_norm(top, dict(hist))
    want = jph.updated_error_A_norm(jop, dict(hist))
    _close(got, want)


@pytest.mark.parametrize("kind", ["dense", "banded-4096"])
def test_lanczos_recurrence_matches_jax(kind):
    top, jop, b = _pair(kind)
    hist = _histories(top, b, 20)
    got, want = dict(hist), dict(hist)
    _close(posthoc.lanczos_recurrence(top, got),
           jph.lanczos_recurrence(jop, want))
    for key in LANCZOS_KEYS:
        _close(got[key], want[key])


def test_updated_error_A_norm_matches_reference_definition():
    a = make_spd(48, cond=100.0, seed=3)
    b = a @ np.linspace(0.5, 1.5, 48)
    out = _histories(a, b, 40)
    vals = posthoc.updated_error_A_norm(port.as_operator(a, device="cpu"),
                                        out)
    # reference: per-iteration solve(A, r); sqrt(error @ r)
    # (updated_error_A_norm.py:42-48)
    for k in range(0, 40, 7):
        r = out["save_r"][k]
        err = np.linalg.solve(a, r)
        assert abs(vals[k] - np.sqrt(err @ r)) <= 1e-10 * max(1.0, vals[k])
    assert out["updated_error_A_norm"] is vals


def test_lanczos_recurrence_quantities():
    a = make_spd(48, cond=50.0, seed=4)
    b = a @ np.ones(48)
    out = _histories(a, b, 20)
    posthoc.lanczos_recurrence(port.as_operator(a, device="cpu"), out)

    Z = out["lanczos_z"]
    # z_k = (-1)^k r_k / ||r_k|| (lanczos_recurrence.py:57,65)
    for k in (0, 1, 5):
        r = out["save_r"][k]
        np.testing.assert_allclose(
            Z[:, k], (-1.0) ** k * r / np.linalg.norm(r), rtol=1e-12
        )
    # alpha/beta index mapping (lanczos_recurrence.py:61-64)
    a_cg = out["alpha"]
    b_cg = out["beta"]
    rn = np.linalg.norm(out["save_r"], axis=1)
    assert abs(out["lanczos_alpha"][0] - 1.0 / a_cg[0]) < 1e-12
    k = 3
    expect = 1.0 / a_cg[k - 1] + b_cg[k - 1] / a_cg[k - 2]
    assert abs(out["lanczos_alpha"][k - 1] - expect) < 1e-12
    expect_b = rn[k] / (a_cg[k - 1] * rn[k - 1])
    assert abs(out["lanczos_beta"][k - 1] - expect_b) < 1e-12

    # the 3-term recurrence must nearly hold in exact arithmetic regime
    assert np.nanmax(out["lanczos_3_term_error"][1:-1]) < 1e-6
    # successive Lanczos vectors near-orthogonal early on
    assert np.all(out["lanczos_orthogonality"][:5] < 1e-8)


@pytest.mark.parametrize("name", ["pipe_pr_cg", "pr_cg", "cg_cg"])
def test_other_variants_histories_match_jax(name):
    """A history of another family, from the port's run, through both
    packages' probes."""
    top, jop, b = _pair("dense")
    hist = _histories(top, b, 16, name)
    got, want = dict(hist), dict(hist)
    posthoc.lanczos_recurrence(top, got)
    jph.lanczos_recurrence(jop, want)
    _close(posthoc.updated_error_A_norm(top, got),
           jph.updated_error_A_norm(jop, want))
    for key in LANCZOS_KEYS:
        _close(got[key], want[key])


def test_tensor_histories_and_matrix():
    a = make_spd(32, cond=30.0, seed=6)
    b = a @ np.ones(32)
    out = _histories(a, b, 12)
    ref = dict(out)
    tens = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in out.items()}
    np.testing.assert_array_equal(
        posthoc.updated_error_A_norm(torch.from_numpy(a), tens),
        posthoc.updated_error_A_norm(a, ref))
    np.testing.assert_array_equal(
        posthoc.lanczos_recurrence(torch.from_numpy(a), tens),
        posthoc.lanczos_recurrence(a, ref))


def test_required_probes_documented():
    assert posthoc.REQUIRED_PROBES == jph.REQUIRED_PROBES
    for name, req in posthoc.REQUIRED_PROBES.items():
        assert "save_r" in req
