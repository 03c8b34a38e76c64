"""Port parity: the padded-ELL SpMV (``ops/ell_spmv``, kernel row 12) and
``EllOperator`` against the JAX package.

The plain versions the CPU runs (``_ell_mv_plain``, ``_ell_mv2_plain``) are
held to the JAX package's Pallas kernel in interpret mode (as its own tests
run it) and to its ``EllOperator.mv`` / ``mv2`` (the XLA gather), in float64
at rtol 1e-13 of each row's scale, at dimensions below and not a multiple of
the kernel's 512-row tile.  The CUDA kernel itself runs only on the card
(``chip_smoke.py``: ``check_ell``); here its wrapper's argument rules are
checked as far as a CPU can.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from new_cg_variants_tpu.matio.matrix_market import CooMatrix as JaxCoo
from new_cg_variants_tpu.ops import operators as jo
from new_cg_variants_tpu.ops.ell_pallas import ell_spmv as jax_ell_kernel
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.ops import _kernels
from new_cg_variants_tpu_torch.ops import ell_spmv as es
from new_cg_variants_tpu_torch.ops import operators as to

RTOL = 1e-13


def random_ell(n, lens, seed):
    """JAX-layout ELL arrays ``(val, idx)`` of ``n`` rows whose lengths are
    drawn from ``range(*lens)`` (0 gives a row of padding only), made by both
    packages' ``build_ell`` from the same random COO entries."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(lens[0], lens[1], n)
    row = np.repeat(np.arange(n), counts).astype(np.int64)
    col = rng.integers(0, n, counts.sum()).astype(np.int64)
    val = rng.uniform(-1.0, 1.0, counts.sum())
    jval, jidx, jnnz = jo.build_ell(JaxCoo((n, n), row, col, val))
    tval, tidx, tnnz = to.build_ell(port.CooMatrix((n, n), row, col, val))
    np.testing.assert_array_equal(tval, jval)
    np.testing.assert_array_equal(tidx, jidx)
    return tval, tidx


SHAPES = {"n=1, L=1": (1, (1, 2)), "n=100": (100, (1, 6)),
          "n=511": (511, (2, 9)), "n=1000, L=1": (1000, (1, 2)),
          "ragged n=4099": (4099, (0, 10))}


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_ell_matches_jax_kernel_and_gather(shape):
    n, lens = SHAPES[shape]
    val, idx = random_ell(n, lens, seed=n)
    rng = np.random.default_rng(1)
    v, w = rng.standard_normal((2, n))
    tv, ti = torch.from_numpy(val), torch.from_numpy(idx)
    scale = np.abs(val).sum(axis=1).max() * max(np.abs(v).max(),
                                                 np.abs(w).max()) + 1e-300
    y = es.ell_spmv(tv, ti, torch.from_numpy(v)).numpy()
    kernel = np.asarray(jax_ell_kernel(jnp.asarray(val), jnp.asarray(idx),
                                       jnp.asarray(v), interpret=True))
    _close(y, kernel, scale)
    jop = jo.EllOperator(jnp.asarray(val), jnp.asarray(idx), 0)
    _close(y, np.asarray(jop.mv(jnp.asarray(v))), scale)
    y2, z2 = es.ell_spmv2(tv, ti, torch.from_numpy(v), torch.from_numpy(w))
    jy2, jz2 = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    _close(y2.numpy(), np.asarray(jy2), scale)
    _close(z2.numpy(), np.asarray(jz2), scale)
    _close(y2.numpy(), y, scale)


def test_plain_versions_take_slot_major_views_and_count_no_launch():
    val, idx = random_ell(300, (1, 8), seed=5)
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(300))
    row_major = es.ell_spmv(torch.from_numpy(np.ascontiguousarray(val)),
                            torch.from_numpy(np.ascontiguousarray(idx)), v)
    slot_major = es.ell_spmv(torch.from_numpy(val), torch.from_numpy(idx), v)
    # (torch may sum the slots of the two layouts in another order)
    _close(row_major.numpy(), slot_major.numpy(), 8.0 * float(v.abs().max()))
    before = (es.ell_spmv.launches, es.ell_spmv2.launches)
    es.ell_spmv2(torch.from_numpy(val), torch.from_numpy(idx), v, v)
    assert (es.ell_spmv.launches, es.ell_spmv2.launches) == before


def test_kernel_argument_rules_on_the_cpu():
    """A CPU tensor never reaches the kernel's launch, and a CPU vector with
    arrays elsewhere raises instead of running the plain version."""
    val = torch.zeros(4, 2, dtype=torch.float64)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.check_ell(val, idx)
    with pytest.raises(ValueError, match="CUDA"):
        es._launch(val, idx, [torch.zeros(4, dtype=torch.float64)])
    meta = torch.zeros(4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="ELL arrays on"):
        es.ell_spmv(val, idx, meta)


def permuted_grid(m=20, seed=0):
    """A 2-D 9-point grid operator under a random symmetric permutation."""
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(m, m))
    a = (9.0 * sp.eye(m * m) - sp.kron(t, t)).tocsr()
    p = np.random.default_rng(seed).permutation(m * m)
    return a[p][:, p].tocsr()


@pytest.fixture(scope="module")
def ell_pair():
    a = permuted_grid()
    c = a.tocoo()
    row, col = c.row.astype(np.int64), c.col.astype(np.int64)
    jop = jo.from_coo(JaxCoo(a.shape, row, col, c.data), fmt="ell",
                      dtype=jnp.float64)
    top = to.from_coo(port.CooMatrix(a.shape, row, col, c.data), fmt="ell",
                      device="cpu")
    return a, jop, top


def test_ell_operator_matches_jax(ell_pair):
    a, jop, top = ell_pair
    n = a.shape[0]
    assert (top.n, top.nnz, top.dtype) == (jop.n, jop.nnz, torch.float64)
    assert top.val_t.is_contiguous() and top.idx_t.dtype == torch.int32
    assert top.val.shape == (n, 9) and not top.val.is_contiguous()
    np.testing.assert_array_equal(top.val.numpy(), np.asarray(jop.val))
    np.testing.assert_array_equal(top.idx.numpy(), np.asarray(jop.idx))
    rng = np.random.default_rng(3)
    v, w = rng.standard_normal((2, n))
    scale = 18.0 * max(np.abs(v).max(), np.abs(w).max())
    _close(top.mv(torch.from_numpy(v)).numpy(),
           np.asarray(jop.mv(jnp.asarray(v))), scale)
    y, z = top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    jy, jz = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    _close(y.numpy(), np.asarray(jy), scale)
    _close(z.numpy(), np.asarray(jz), scale)
    np.testing.assert_array_equal(top.diagonal().numpy(),
                                  np.asarray(jop.diagonal()))
    np.testing.assert_array_equal(top.todense(), np.asarray(jop.todense()))
    np.testing.assert_array_equal(top.tocsr().toarray(), a.toarray())
    np.testing.assert_array_equal(top.tocsr().toarray(),
                                  jop.tocsr().toarray())


def test_ell_operator_astype_to_and_convert(ell_pair):
    _, jop, top = ell_pair
    f32 = top.astype(torch.float32)
    assert f32.dtype == torch.float32 and f32.val_t.is_contiguous()
    np.testing.assert_array_equal(
        f32.val.numpy(), np.asarray(jop.astype(jnp.float32).val))
    assert f32.idx_t.data_ptr() == top.idx_t.data_ptr()  # no index copy
    moved = top.to("cpu")
    assert moved.device.type == "cpu" and moved.nnz == top.nnz
    again = operator_from_numpy(kind="ell", val=np.asarray(jop.val),
                                idx=np.asarray(jop.idx), nnz=jop.nnz,
                                device="cpu")
    assert isinstance(again, port.EllOperator) and again.nnz == top.nnz
    np.testing.assert_array_equal(again.val.numpy(), top.val.numpy())
    np.testing.assert_array_equal(again.idx.numpy(), top.idx.numpy())


@pytest.mark.parametrize("bad", [-1, 3])
def test_out_of_range_indices_are_refused(bad):
    """The one index check, which the kernel does not make: ``check_index``
    and every ``EllOperator`` build refuse an index outside ``[0, n)``."""
    idx = torch.zeros(3, 2, dtype=torch.int32)
    idx[1, 1] = bad
    with pytest.raises(ValueError, match="outside"):
        es.check_index(idx, 3)
    with pytest.raises(ValueError, match="outside"):
        port.EllOperator(torch.ones(3, 2), idx, 6)
    es.check_index(idx.clamp(0, 2), 3)


def test_ell_operator_rejects_bad_input():
    with pytest.raises(ValueError, match="outside"):
        port.EllOperator(torch.ones(3, 2), torch.full((3, 2), 3), 6)
    with pytest.raises(ValueError, match="shapes"):
        port.EllOperator(torch.ones(3, 2), torch.zeros(3, 1, dtype=torch.int32))
