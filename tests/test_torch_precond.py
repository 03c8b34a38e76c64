"""Port parity: preconditioners against the JAX package, float64, CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.solvers import precond as jpre
from new_cg_variants_tpu_torch.convert import (
    operator_from_numpy,
    preconditioner_from_numpy,
)
from new_cg_variants_tpu_torch.solvers import precond as tpre

N, K = 512, 8


@pytest.fixture(scope="module")
def problem():
    jop, b, _ = jax_banded(N, k=K, kappa=1e4, fmt="symdia")
    top = operator_from_numpy(jop.offsets, np.asarray(jop.data), device="cpu")
    v = np.random.default_rng(3).standard_normal(N)
    return jop, top, v


def test_jacobi_from_operator_matches_jax_bit_for_bit(problem):
    jop, top, v = problem
    want = jpre.JacobiPreconditioner.from_operator(jop)
    got = tpre.JacobiPreconditioner.from_operator(top)
    # one division and one product per entry: no summation order to differ
    np.testing.assert_array_equal(got.inv_diag.numpy(),
                                  np.asarray(want.inv_diag))
    np.testing.assert_array_equal(got.apply(torch.from_numpy(v)).numpy(),
                                  np.asarray(want.apply(jnp.asarray(v))))


def test_jacobi_of_bf16_storage_stays_float32(problem):
    _, top, _ = problem
    got = tpre.JacobiPreconditioner.from_operator(top.astype(torch.bfloat16))
    assert got.inv_diag.dtype == torch.float32
    want = 1.0 / top.data[0].to(torch.bfloat16).to(torch.float32)
    assert torch.equal(got.inv_diag, want)


def test_astype_and_to_return_new_preconditioners(problem):
    _, top, _ = problem
    pre = tpre.JacobiPreconditioner.from_operator(top)
    f32 = pre.astype(torch.float32)
    assert f32.inv_diag.dtype == torch.float32
    assert pre.inv_diag.dtype == torch.float64
    moved = pre.to("cpu")
    assert moved.inv_diag.device.type == "cpu" and moved.inv_diag.is_contiguous()
    for other in (tpre.IdentityPreconditioner(),
                  tpre.FunctionPreconditioner(lambda t: 2 * t)):
        assert other.astype(torch.float32) is other
        assert other.to("cpu") is other


def test_identity_and_function_apply(problem):
    _, _, v = problem
    t = torch.from_numpy(v)
    assert tpre.IdentityPreconditioner().apply(t) is t
    np.testing.assert_array_equal(
        tpre.FunctionPreconditioner(lambda a: 0.5 * a).apply(t).numpy(),
        np.asarray(jpre.FunctionPreconditioner(lambda a: 0.5 * a).apply(
            jnp.asarray(v))))


@pytest.mark.parametrize("spec,kind", [
    (None, type(None)),
    ("jacobi", tpre.JacobiPreconditioner),
    (tpre.IdentityPreconditioner(), tpre.IdentityPreconditioner),
    (lambda t: t, tpre.FunctionPreconditioner),
])
def test_make_preconditioner_resolves_each_spec(problem, spec, kind):
    jop, top, _ = problem
    got = tpre.make_preconditioner(spec, top)
    assert isinstance(got, kind)
    if hasattr(spec, "apply"):
        assert got is spec
    # the JAX package resolves the same spec to its class of the same name
    jspec = jpre.IdentityPreconditioner() if hasattr(spec, "apply") else spec
    assert type(jpre.make_preconditioner(jspec, jop)).__name__ == kind.__name__


@pytest.mark.parametrize("spec,exc", [("ilu", ValueError), (3, TypeError)])
def test_make_preconditioner_rejects_bad_specs(problem, spec, exc):
    jop, top, _ = problem
    with pytest.raises(exc):
        tpre.make_preconditioner(spec, top)
    with pytest.raises(exc):
        jpre.make_preconditioner(spec, jop)


def test_preconditioner_from_numpy(problem, monkeypatch):
    jop, _, v = problem
    inv = np.asarray(jpre.JacobiPreconditioner.from_operator(jop).inv_diag)
    pre = preconditioner_from_numpy(inv, dtype=torch.float32, device="cpu")
    assert isinstance(pre, tpre.JacobiPreconditioner)
    assert pre.inv_diag.dtype == torch.float32
    np.testing.assert_array_equal(pre.inv_diag.numpy(), inv.astype(np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        preconditioner_from_numpy(inv)
