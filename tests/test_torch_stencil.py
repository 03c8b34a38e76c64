"""Port parity: the constant-band stencil operator (``ops/stencil``) and
``banded_model(fmt="stencil")`` against the JAX package.

Both packages take the same two-level prefix sum (blocks of 256); XLA and
torch may add within a prefix in another order, so the window sums agree to
rtol 1e-13 of the window's scale in float64, not bit for bit.  The model
problem's arrays agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.matio import problems as jp
from new_cg_variants_tpu.ops import stencil as js
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.matio import problems as tp
from new_cg_variants_tpu_torch.ops import stencil as ts

RTOL = 1e-13


@pytest.mark.parametrize("n,k", [(1000, 1), (1000, 2), (700, 900), (256, 3),
                                 (257, 300), (5000, 64), (1, 4), (511, 256)],
                         ids=lambda x: str(x))
def test_window_sum_matches_jax(n, k):
    v = np.random.default_rng(n + k).standard_normal(n)
    got = ts.window_sum(torch.from_numpy(v), k).numpy()
    want = np.asarray(js.window_sum(jnp.asarray(v), k))
    scale = (2 * min(k, n) - 1) * np.abs(v).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    # the definition: sum over |i - j| < k inside [0, n)
    i = np.arange(n)
    direct = np.array([v[max(0, j - k + 1): j + k].sum() for j in i])
    np.testing.assert_allclose(got, direct, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("n,k", [(64, 2), (1000, 8), (4099, 17)])
def test_banded_model_stencil_matches_jax(n, k):
    top, b, x = tp.banded_model(n, k=k, kappa=1e4, fmt="stencil",
                                device="cpu")
    jop, jb, jx = jp.banded_model(n, k=k, kappa=1e4, fmt="stencil")
    assert isinstance(top, port.BandedStencilOperator)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(top.diag.numpy(), np.asarray(jop.diag))
    assert float(top.off_value) == float(jop.off_value)
    assert top.off_value.dtype == top.diag.dtype == torch.float64
    assert (top.n, top.k, top.nnz) == (jop.n, jop.k, jop.nnz)
    # b = A 1 in the operator's own product too
    np.testing.assert_allclose(top.mv(torch.ones(n, dtype=torch.float64))
                               .numpy(), b, rtol=1e-12)


@pytest.fixture(scope="module")
def stencil_pair():
    jop, _, _ = jp.banded_model(1500, k=9, kappa=1e3, fmt="stencil")
    top = operator_from_numpy(kind="stencil", diag=np.asarray(jop.diag),
                              off_value=np.asarray(jop.off_value), k=jop.k,
                              device="cpu")
    return jop, top


def test_stencil_operator_matches_jax(stencil_pair):
    jop, top = stencil_pair
    rng = np.random.default_rng(4)
    v, w = rng.standard_normal((2, top.n))
    scale = np.abs(np.asarray(jop.diag)).max() * 3.0
    np.testing.assert_allclose(top.mv(torch.from_numpy(v)).numpy(),
                               np.asarray(jop.mv(jnp.asarray(v))),
                               rtol=RTOL, atol=RTOL * scale)
    y, z = top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    jy, jz = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_array_equal(top.diagonal().numpy(),
                                  np.asarray(jop.diagonal()))
    np.testing.assert_array_equal(top.todense(), np.asarray(jop.todense()))
    np.testing.assert_array_equal(top.tocsr().toarray(),
                                  jop.tocsr().toarray())
    np.testing.assert_allclose(top.todense() @ v, y.numpy(), rtol=1e-12,
                               atol=1e-12 * scale)


def test_stencil_operator_astype_and_to(stencil_pair):
    jop, top = stencil_pair
    f32 = top.astype(torch.float32)
    assert f32.dtype == f32.off_value.dtype == torch.float32 and f32.k == 9
    np.testing.assert_array_equal(f32.diag.numpy(),
                                  np.asarray(jop.astype(jnp.float32).diag))
    moved = top.to("cpu")
    assert moved.device.type == "cpu" and moved.off_value.device.type == "cpu"
