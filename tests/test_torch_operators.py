"""Port parity: dense and full-DIA operators, ``as_operator`` and the model
problems that build them, against the JAX package's classes.

Inputs are made with numpy from a seed and handed to both packages; both run
in float64 on the CPU.  Products agree to rtol 1e-13 of the row's scale (the
two packages add the same terms in the same order; only the matrix product
of the dense operator may group them differently); conversions and model
problems are bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import make_spd

import new_cg_variants_tpu as cgt
from new_cg_variants_tpu.matio import problems as jp
from new_cg_variants_tpu.ops import operators as jo
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.matio import problems as tp
from new_cg_variants_tpu_torch.ops import operators as to
from new_cg_variants_tpu_torch.ops.sym_dia import SymDiaOperator

RTOL = 1e-13


def random_dia(n, offsets, seed):
    """O(1) random DIA data with explicit zeros outside the matrix."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(-1.0, 1.0, (len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            data[d, max(n - off, 0):] = 0.0
        elif off < 0:
            data[d, :min(-off, n)] = 0.0
    return data


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


OFFSETS = [(0,), (-1, 0, 1), (-3, -1, 0, 2, 7), (5, 0, -5, 1),
           tuple(range(-31, 32)), (-300, 0, 300)]


@pytest.mark.parametrize("offsets", OFFSETS, ids=str)
def test_dia_operator_matches_jax(offsets):
    n = 777
    data = random_dia(n, offsets, seed=len(offsets))
    jop = jo.DiaOperator(offsets, jnp.asarray(data))
    top = operator_from_numpy(offsets, data, kind="dia", device="cpu")
    rng = np.random.default_rng(1)
    v, w = rng.standard_normal((2, n))
    scale = np.abs(data).sum(axis=0).max() * max(np.abs(v).max(),
                                                 np.abs(w).max())
    _close(top.mv(torch.from_numpy(v)).numpy(), np.asarray(jop.mv(jnp.asarray(v))),
           scale)
    y, z = top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    jy, jz = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    _close(y.numpy(), np.asarray(jy), scale)
    _close(z.numpy(), np.asarray(jz), scale)
    np.testing.assert_array_equal(top.todense(), np.asarray(jop.todense()))
    np.testing.assert_array_equal(top.tocsr().toarray(),
                                  jop.tocsr().toarray())
    _close(top.todense() @ v, y.numpy(), scale)
    assert top.nnz == jop.nnz and top.n == jop.n == n
    if 0 in offsets:
        np.testing.assert_array_equal(top.diagonal().numpy(),
                                      np.asarray(jop.diagonal()))
    f32 = top.astype(torch.float32)
    assert f32.dtype == torch.float32 and f32.offsets == top.offsets
    np.testing.assert_array_equal(
        f32.data.numpy(), np.asarray(jop.astype(jnp.float32).data))
    assert top.to("cpu").device.type == "cpu"


def test_dia_operator_rejects_bad_input():
    with pytest.raises(ValueError, match="repeated"):
        to.DiaOperator((0, 1, 1), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="does not match"):
        to.DiaOperator((0, 1), torch.zeros(3, 8))


@pytest.mark.parametrize("n", [8, 64])
def test_dense_operator_matches_jax(n):
    a = make_spd(n)
    jop = jo.DenseOperator(jnp.asarray(a))
    top = operator_from_numpy(None, a, kind="dense", device="cpu")
    rng = np.random.default_rng(n)
    v, w = rng.standard_normal((2, n))
    scale = np.abs(a).sum(axis=1).max() * max(np.abs(v).max(), np.abs(w).max())
    _close(top.mv(torch.from_numpy(v)).numpy(),
           np.asarray(jop.mv(jnp.asarray(v))), scale)
    y, z = top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    jy, jz = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    _close(y.numpy(), np.asarray(jy), scale)
    _close(z.numpy(), np.asarray(jz), scale)
    np.testing.assert_array_equal(top.diagonal().numpy(),
                                  np.asarray(jop.diagonal()))
    np.testing.assert_array_equal(top.todense(), np.asarray(jop.todense()))
    np.testing.assert_array_equal(top.tocsr().toarray(),
                                  jop.tocsr().toarray())
    assert top.nnz == jop.nnz == n * n and top.n == jop.n
    assert top.astype(torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match="square"):
        to.DenseOperator(torch.zeros(3, 4))


def test_as_operator_passes_operators_through():
    sym = SymDiaOperator((0, 1), torch.ones(2, 8, dtype=torch.float64))
    dia = to.DiaOperator((-1, 0, 1), torch.ones(3, 8, dtype=torch.float64))
    dense = to.DenseOperator(torch.eye(8, dtype=torch.float64))
    for op in (sym, dia, dense):
        assert to.as_operator(op, device="cpu") is op
        f32 = to.as_operator(op, dtype=torch.float32, device="cpu")
        assert type(f32) is type(op) and f32.dtype == torch.float32


@pytest.mark.parametrize("kind", ["numpy", "tensor", "list"])
def test_as_operator_makes_arrays_dense(kind):
    a = make_spd(8)
    given = {"numpy": a, "tensor": torch.from_numpy(a), "list": a.tolist()}[kind]
    op = to.as_operator(given, device="cpu")
    want = jo.as_operator(a)
    assert isinstance(op, to.DenseOperator) and isinstance(want, jo.DenseOperator)
    assert op.dtype == torch.float64
    np.testing.assert_array_equal(op.a.numpy(), np.asarray(want.a))
    assert to.as_operator(a, dtype=torch.float32, device="cpu").dtype == torch.float32


@pytest.mark.parametrize("kind", ["csr", "coo", "triple"])
def test_as_operator_sparse_input_names_its_roadmap_item(kind):
    """Sparse input, which raised naming ROADMAP item 1.5 before the format
    layer was ported, now takes the auto policy as in the JAX package (at
    n = 16: dense), and solves as the JAX package solves."""
    a = make_spd(16) * (sp.random(16, 16, density=0.3, random_state=0)
                        .toarray() != 0)
    a = sp.csr_matrix(a + a.T + 16 * np.eye(16))
    if kind == "triple":
        given, jgiven = to.coo_from_scipy(a), jo.coo_from_scipy(a)
    else:
        given = jgiven = a.asformat(kind)
    op = to.as_operator(given, device="cpu")
    want = jo.as_operator(jgiven)
    assert isinstance(op, to.DenseOperator) and isinstance(want,
                                                           jo.DenseOperator)
    assert op.dtype == torch.float64
    np.testing.assert_array_equal(op.a.numpy(), np.asarray(want.a))
    b = a @ np.ones(16)
    got = port.solve(given, b, rtol=1e-12, device="cpu")
    ref = cgt.solve(jgiven, b, rtol=1e-12, dtype=np.float64)
    assert got.converged and got.iterations == ref.iterations
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-10)


@pytest.mark.parametrize("n,k", [(64, 2), (1000, 8), (4096, 32), (4099, 17)])
def test_banded_model_dia_bit_identical(n, k):
    jop, jb, jx = jp.banded_model(n, k=k)  # the JAX default is fmt="dia"
    top, tb, tx = tp.banded_model(n, k=k, fmt="dia", device="cpu")
    assert isinstance(top, to.DiaOperator)
    assert top.offsets == tuple(jop.offsets) == tuple(range(-(k - 1), k))
    np.testing.assert_array_equal(top.data.numpy(), np.asarray(jop.data))
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tx, jx)
    assert top.nnz == jop.nnz
    # the half-band form of the same problem is the same matrix
    sym, sb, _ = tp.banded_model(n, k=k, fmt="symdia", device="cpu")
    assert tp.banded_model(n, k=k, device="cpu")[0].offsets == sym.offsets
    offs, full = sym.todia_host()
    assert offs == top.offsets
    np.testing.assert_array_equal(full, top.data.numpy())
    # (its b is diag + off_value * count, not a sum over the diagonals)
    np.testing.assert_allclose(sb, tb, rtol=1e-14)


@pytest.mark.parametrize("n,kappa", [(777, 1e6), (4096, 1e4)])
def test_model_spectrum_bit_identical(n, kappa):
    jop, jb, jx = jp.model_spectrum(n, kappa=kappa)
    top, tb, tx = tp.model_spectrum(n, kappa=kappa, device="cpu")
    assert isinstance(top, to.DiaOperator) and top.offsets == (0,)
    np.testing.assert_array_equal(top.data.numpy(), np.asarray(jop.data))
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(
        top.mv(torch.from_numpy(tx)).numpy(), tb)
