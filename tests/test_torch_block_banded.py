"""Port parity: the block-banded operator (``ops/block_banded``) against the
JAX package.

The same scipy matrices (made with numpy from a seed) go through both
packages: the RCM probe, the packed blocks and the permutation agree bit for
bit; the batched products (``torch.matmul`` here, ``jnp.einsum`` there) add
in another order and agree to rtol 1e-13 of the row's scale in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from new_cg_variants_tpu.matio.matrix_market import CooMatrix as JaxCoo
from new_cg_variants_tpu.ops import block_banded as jb
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.ops import block_banded as tb

RTOL = 1e-13


def permuted_laplacian(m=30, seed=3, shift=0.1):
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
    a = (sp.kronsum(t, t) + shift * sp.eye(m * m)).tocsr()
    p = np.random.default_rng(seed).permutation(m * m)
    return a[p][:, p].tocsr()


def natural_band(n=1000, k=20, seed=5):
    """Symmetric band in natural order: RCM cannot beat it."""
    rng = np.random.default_rng(seed)
    offs = list(range(-k, k + 1))
    a = sp.diags([rng.uniform(-1, 1, n - abs(o)) for o in offs], offs,
                 shape=(n, n)).tocsr()
    return (a + a.T + 4 * k * sp.eye(n)).tocsr()


def both(a):
    c = a.tocoo()
    row, col = c.row.astype(np.int64), c.col.astype(np.int64)
    return (JaxCoo(a.shape, row, col, c.data),
            port.CooMatrix(a.shape, row.copy(), col.copy(), c.data.copy()))


MATRICES = {"permuted grid": permuted_laplacian,
            "natural band": natural_band}


@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("reorder", ["auto", "rcm", None])
def test_packing_matches_jax_bit_for_bit(matrix, reorder):
    a = MATRICES[matrix]()
    jc, tc = both(a)
    jop, jperm = jb.block_banded_from_coo(jc, dtype=jnp.float64,
                                          reorder=reorder)
    top, tperm = tb.block_banded_from_coo(tc, dtype=torch.float64,
                                          reorder=reorder, device="cpu")
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    np.testing.assert_array_equal(top.a_blk.numpy(), np.asarray(jop.a_blk))
    assert (top.n, top.n_orig, top.nnz, top.bs) == (jop.n, jop.n_orig,
                                                    jop.nnz, jop.bs)
    assert tb.rcm_band_probe(tc) == jb.rcm_band_probe(jc)
    if matrix == "permuted grid" and reorder == "auto":
        assert top.bs == 128 and top.n > top.n_orig  # padded, unit diagonal
        pad = top.diagonal()[top.n_orig:]
        assert bool((pad == 1.0).all())


def test_rcm_probe_is_memoised_on_the_coo_object():
    _, tc = both(permuted_laplacian())
    first = tb._rcm_probe_full(tc)
    assert tc._rcm_probe_cache is first and tb._rcm_probe_full(tc) is first
    assert first[0] == min(first[1], first[2]) and first[2] <= 60


@pytest.fixture(scope="module")
def permuted_pair():
    a = permuted_laplacian()
    jc, tc = both(a)
    jop, jperm = jb.block_banded_from_coo(jc, dtype=jnp.float64)
    top, tperm = tb.block_banded_from_coo(tc, dtype=torch.float64,
                                          device="cpu")
    return (a, jb.PermutedBlockBandedOperator(jop, jnp.asarray(jperm)),
            tb.PermutedBlockBandedOperator(top, torch.from_numpy(tperm)))


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def test_products_and_diagonal_match_jax(permuted_pair):
    a, jop, top = permuted_pair
    rng = np.random.default_rng(6)
    v, w = rng.standard_normal((2, a.shape[0]))
    scale = 8.2 * max(np.abs(v).max(), np.abs(w).max())
    y = top.mv(torch.from_numpy(v)).numpy()
    _close(y, np.asarray(jop.mv(jnp.asarray(v))), scale)
    _close(y, a @ v, scale)
    y2, z2 = top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    jy2, jz2 = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    _close(y2.numpy(), np.asarray(jy2), scale)
    _close(z2.numpy(), np.asarray(jz2), scale)
    np.testing.assert_array_equal(top.diagonal().numpy(),
                                  np.asarray(jop.diagonal()))
    np.testing.assert_array_equal(top.diagonal().numpy(), a.diagonal())
    inner = top.inner
    vi = rng.standard_normal(inner.n)
    _close(inner.mv(torch.from_numpy(vi)).numpy(),
           np.asarray(jop.inner.mv(jnp.asarray(vi))), scale)
    yi, zi = inner.mv2(torch.from_numpy(vi), torch.from_numpy(2 * vi))
    _close(zi.numpy(), 2 * yi.numpy(), 2 * scale)


def test_tocsr_recovers_the_matrix(permuted_pair):
    a, jop, top = permuted_pair
    np.testing.assert_array_equal(top.tocsr().toarray(), a.toarray())
    np.testing.assert_array_equal(top.todense(), np.asarray(jop.todense()))
    p = top.perm.numpy()
    np.testing.assert_array_equal(top.inner.tocsr().toarray(),
                                  a[p][:, p].toarray())
    np.testing.assert_array_equal(top.inner.todense(),
                                  np.asarray(jop.inner.todense()))


def test_solver_basis_round_trip(permuted_pair):
    a, jop, top = permuted_pair
    inner, to_basis, from_basis = tb.solver_basis(top)
    jinner, jto, jfrom = jb.solver_basis(jop)
    assert inner is top.inner
    v = np.random.default_rng(7).standard_normal(a.shape[0])
    moved = to_basis(torch.from_numpy(v))
    assert moved.shape == (inner.n,) and not moved[a.shape[0]:].any()
    np.testing.assert_array_equal(moved.numpy(), np.asarray(jto(v)))
    np.testing.assert_array_equal(from_basis(moved).numpy(), v)
    two = torch.from_numpy(np.stack([v, 2 * v], axis=1))
    np.testing.assert_array_equal(from_basis(to_basis(two)).numpy(),
                                  two.numpy())
    # A x in the original order is the inner product in the reordered one
    y = from_basis(inner.mv(moved)).numpy()
    _close(y, a @ v, 8.2 * np.abs(v).max())
    other = port.DiaOperator((0,), torch.ones(1, 4, dtype=torch.float64))
    same, ident, ident2 = tb.solver_basis(other)
    t = torch.ones(4)
    assert same is other and ident(t) is t and ident2(t) is t


def test_astype_to_and_convert(permuted_pair):
    a, jop, top = permuted_pair
    f32 = top.astype(torch.float32)
    assert f32.dtype == torch.float32 and torch.equal(f32.perm, top.perm)
    np.testing.assert_array_equal(
        f32.inner.a_blk.numpy(), np.asarray(jop.astype(jnp.float32).inner.a_blk))
    assert top.to("cpu").device.type == "cpu"
    again = operator_from_numpy(kind="block_banded",
                                a_blk=np.asarray(jop.inner.a_blk),
                                n_orig=jop.inner.n_orig, nnz=jop.inner.nnz,
                                perm=np.asarray(jop.perm), device="cpu")
    assert isinstance(again, tb.PermutedBlockBandedOperator)
    np.testing.assert_array_equal(again.tocsr().toarray(), a.toarray())
    bare = operator_from_numpy(kind="block_banded",
                               a_blk=np.asarray(jop.inner.a_blk),
                               n_orig=jop.inner.n_orig, nnz=jop.inner.nnz,
                               device="cpu")
    assert isinstance(bare, tb.BlockBandedOperator)
    with pytest.raises(ValueError, match="blocks"):
        tb.BlockBandedOperator(torch.zeros(2, 4, 4), 8, 0)
