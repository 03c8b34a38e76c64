"""Port parity: the full-DIA SpMV entry points against the JAX package.

The JAX side runs its Pallas kernel in interpret mode (as
``tests/test_spmv_pallas.py`` does) where the band fits its window, and the
XLA shift formulation of ``DiaOperator.mv`` otherwise; the port runs the
plain PyTorch version (CPU tensors).  Float64, inputs from a numpy seed,
rtol 1e-13 of the row's scale: both add the same terms in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops import operators as jo
from new_cg_variants_tpu.ops import spmv_pallas as jsp
from new_cg_variants_tpu_torch.ops import spmv_dia as tsp
from test_torch_operators import random_dia

RTOL = 1e-13


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize(
    "n,k",
    [
        (2048, 1),   # diagonal only
        (5000, 5),   # small band, ragged n
        (4099, 32),  # PETSc bandwidth, ragged n
        (1000, 8),   # n smaller than the JAX tile
    ],
)
def test_dia_spmv_matches_jax_kernel(n, k):
    op, _, _ = jax_banded(n, k=k, kappa=100.0)
    offsets, data = tuple(op.offsets), np.asarray(op.data)
    rng = np.random.default_rng(n)
    v, w = rng.standard_normal((2, n))
    scale = np.abs(data).sum(axis=0).max() * 5.0
    want = jsp.dia_spmv(offsets, op.data, jnp.asarray(v), interpret=True)
    _close(tsp.dia_spmv(offsets, _t(data), _t(v)), want, scale)
    y, z = tsp.dia_spmv2(offsets, _t(data), _t(v), _t(w))
    jy, jz = jsp.dia_spmv2(offsets, op.data, jnp.asarray(v), jnp.asarray(w),
                           interpret=True)
    _close(y, jy, scale)
    _close(z, jz, scale)
    # one RHS of the 2-RHS entry is the 1-RHS entry, bit for bit
    np.testing.assert_array_equal(
        y.numpy(), tsp.dia_spmv(offsets, _t(data), _t(v)).numpy())


@pytest.mark.parametrize("offsets", [
    (-3, -1, 0, 2, 7),          # not symmetric
    (4, 0, -9),                 # stored in no order
    (1, 2, 3),                  # no main diagonal, upper only
    (-2048, -1, 0, 1, 2048),    # wide: the JAX kernel's window does not fit
    (-5000, 0, 5000),           # |offset| > n: nothing but zeros beside the main
], ids=str)
@pytest.mark.parametrize("n", [300, 4099])
def test_dia_spmv_any_offsets(offsets, n):
    data = random_dia(n, offsets, seed=n + len(offsets))
    rng = np.random.default_rng(5)
    v, w = rng.standard_normal((2, n))
    jop = jo.DiaOperator(offsets, jnp.asarray(data))
    scale = np.abs(data).sum(axis=0).max() * 5.0
    dense = np.asarray(jop.todense())
    got = tsp.dia_spmv(offsets, _t(data), _t(v))
    _close(got, dense @ v, scale)
    if max(abs(o) for o in offsets) < n:
        # the XLA shift formulation (it cannot shift further than n)
        _close(got, jop.mv(jnp.asarray(v)), scale)
    if jsp.supports(offsets, tile=1024):
        _close(got, jsp.dia_spmv(offsets, jop.data, jnp.asarray(v), tile=1024,
                                 interpret=True), scale)
    y, z = tsp.dia_spmv2(offsets, _t(data), _t(v), _t(w))
    _close(y, dense @ v, scale)
    _close(z, dense @ w, scale)


def test_dia_spmv_ext_matches_sliced_global_product():
    """The halo-extended entries against a manually sliced global matvec
    (the slicing of ``tests/test_spmv_pallas.py``) and the JAX kernel."""
    n, k, p = 4096, 8, 4
    op, _, _ = jax_banded(n, k=k, kappa=100.0)
    offsets, data = tuple(op.offsets), np.asarray(op.data)
    h, m = k - 1, n // p
    rng = np.random.default_rng(3)
    v, w = rng.standard_normal((2, n))
    y_full = tsp.dia_spmv(offsets, _t(data), _t(v)).numpy()
    z_full = tsp.dia_spmv(offsets, _t(data), _t(w)).numpy()
    scale = np.abs(data).sum(axis=0).max() * 5.0

    def ext(x, lo, hi):
        padded = np.concatenate([np.zeros(h), x, np.zeros(h)])
        return padded[lo: hi + 2 * h]

    for d in range(p):
        lo, hi = d * m, (d + 1) * m
        local = data[:, lo:hi]
        vext, wext = ext(v, lo, hi), ext(w, lo, hi)
        y = tsp.dia_spmv_ext(offsets, _t(local), _t(vext))
        _close(y, y_full[lo:hi], scale)
        _close(y, jsp.dia_spmv_ext(offsets, jnp.asarray(local),
                                   jnp.asarray(vext), interpret=True), scale)
        y2, z2 = tsp.dia_spmv2_ext(offsets, _t(local), _t(vext), _t(wext))
        _close(y2, y_full[lo:hi], scale)
        _close(z2, z_full[lo:hi], scale)


def test_window_rule_is_a_function_of_the_offsets():
    assert tsp.halo((-3, 0, 7)) == (3, 7)
    assert tsp.halo((1, 2)) == (0, 2) and tsp.halo((-4,)) == (4, 0)
    assert tsp.stages_window(tuple(range(-31, 32)))
    assert tsp.stages_window((-512, 0, 512))
    assert not tsp.stages_window((-2048, -1, 0, 1, 2048))
    assert not tsp.stages_window((0, tsp.MAX_STAGED_HALO + 1))


def test_cpu_path_does_not_count_launches():
    data = random_dia(512, (-1, 0, 1), seed=0)
    v = np.ones(512)
    before = [fn.launches for fn in tsp.DIA_WRAPPERS]
    tsp.dia_spmv((-1, 0, 1), _t(data), _t(v))
    tsp.dia_spmv2((-1, 0, 1), _t(data), _t(v), _t(v))
    tsp.dia_spmv_ext((-1, 0, 1), _t(data), _t(np.ones(514)))
    assert [fn.launches for fn in tsp.DIA_WRAPPERS] == before


def test_wrapper_rejects_other_devices_and_types():
    data = _t(random_dia(256, (-1, 0, 1), seed=0))
    meta = torch.empty(256, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        tsp.dia_spmv((-1, 0, 1), data, meta)
    # the kernel's own checks: CPU data never reaches the kernel, and
    # float16 is no storage type of a kernel (bf16 is:
    # test_torch_bf16_storage.py)
    with pytest.raises(ValueError, match="CUDA"):
        tsp._launch((-1, 0, 1), data, (), False)
    from test_torch_sym_family import _FakeCudaTensor

    half = _FakeCudaTensor(is_cuda=True, dtype=torch.float16,
                           shape=(3, 256), device=torch.device("cuda", 0))
    with pytest.raises(TypeError, match="float16"):
        tsp._launch((-1, 0, 1), half, (), False)
