"""Port parity: the half-band SpMV's plain version against the JAX package.

The port's ``sym_dia_spmv`` / ``sym_dia_spmv2`` take their plain PyTorch
version on CPU tensors (the CUDA kernel is held against that same version
on the card by ``chip_smoke.py``).  Here it is compared in float64 with the
JAX XLA formulation, the JAX Pallas kernel in interpret mode, and a dense
numpy product.  The sums run in different orders, so agreement is to
rtol 1e-12, not bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops import sym_dia as jsd
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.ops import sym_dia as tsd

RTOL = 1e-12


def _problem(n, k, seed):
    jop, _, _ = jax_banded(n, k=k, kappa=1e4, fmt="symdia")
    top = operator_from_numpy(jop.offsets, np.asarray(jop.data),
                              device="cpu")
    rng = np.random.default_rng(seed)
    v, w = rng.standard_normal(n), rng.standard_normal(n)
    return jop, top, v, w


def _close(got, want, scale):
    # normwise per entry: |A||v| bounds the rounding of each row's sum
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("k", [2, 8, 32])
def test_spmv_plain_matches_jax_kernel_and_xla(k):
    n = 4096
    jop, top, v, w = _problem(n, k, seed=k)
    dense = np.asarray(jop.todense())
    scale = np.abs(dense).sum(axis=1).max() * max(np.abs(v).max(),
                                                  np.abs(w).max())
    y = top.mv(torch.from_numpy(v)).numpy()
    y2, z2 = (t.numpy() for t in top.mv2(torch.from_numpy(v),
                                         torch.from_numpy(w)))
    jv, jw = jnp.asarray(v), jnp.asarray(w)
    y_xla = np.asarray(jop._mv_xla(jv))
    y_ker = np.asarray(jsd.sym_dia_spmv(jop.offsets, jop.data, jv,
                                        tile=1024, interpret=True))
    y2_ker, z2_ker = (np.asarray(a) for a in jsd.sym_dia_spmv2(
        jop.offsets, jop.data, jv, jw, tile=1024, interpret=True))
    for want in (y_xla, y_ker, dense @ v):
        _close(y, want, scale)
    _close(y2, y2_ker, scale)
    _close(z2, z2_ker, scale)
    _close(z2, dense @ w, scale)
    np.testing.assert_array_equal(y2, y)


def test_spmv_plain_ragged_n():
    n, k = 4099, 8
    jop, top, v, _ = _problem(n, k, seed=7)
    dense = np.asarray(jop.todense())
    scale = np.abs(dense).sum(axis=1).max() * np.abs(v).max()
    y = top.mv(torch.from_numpy(v)).numpy()
    _close(y, np.asarray(jop._mv_xla(jnp.asarray(v))), scale)
    _close(y, dense @ v, scale)


def test_host_conversions_match_jax():
    jop, top, _, _ = _problem(300, 5, seed=1)
    offs_j, full_j = jop.todia_host()
    offs_t, full_t = top.todia_host()
    assert offs_t == offs_j
    np.testing.assert_array_equal(full_t, full_j)
    np.testing.assert_array_equal(top.todense(), np.asarray(jop.todense()))
    np.testing.assert_array_equal(top.tocsr().toarray(), top.todense())
    assert top.nnz == jop.nnz


def test_cpu_path_does_not_count_launches():
    _, top, v, w = _problem(1024, 4, seed=2)
    before = (tsd.sym_dia_spmv.launches, tsd.sym_dia_spmv2.launches)
    top.mv(torch.from_numpy(v))
    top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    assert (tsd.sym_dia_spmv.launches, tsd.sym_dia_spmv2.launches) == before


def test_wrapper_rejects_other_devices():
    _, top, _, _ = _problem(256, 3, seed=3)
    meta = torch.empty(256, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        top.mv(meta)
    # the kernel's own checks: a CPU operator never reaches the kernel
    with pytest.raises(ValueError, match="CUDA"):
        tsd.check_kernel_args(top.offsets, top.data, (), 1)


def test_kernel_shared_memory_limits():
    # only the vector windows take shared memory: those of the main path
    # (h = 31) and of the widest band the auto route stores half-band
    # (h = 127) fit in f64; windows of a half-band of 8000 rows do not
    assert tsd.kernel_smem_bytes(31, 2, 8) <= tsd.MAX_SMEM_BYTES
    assert tsd.kernel_smem_bytes(127, 2, 8) <= tsd.MAX_SMEM_BYTES
    assert tsd.kernel_smem_bytes(8000, 2, 8) > tsd.MAX_SMEM_BYTES
    assert tsd.kernel_smem_bytes(31, 2, 8) == (
        (2 * (256 + 62) + 32) * 8 + 4 * 256)
