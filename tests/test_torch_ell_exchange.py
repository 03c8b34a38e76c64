"""The ELL exchange plan and the local products of a row shard, on the host.

* The port's ``parallel/ell_exchange.py`` (its own copy of the JAX
  package's numpy module) plans as the JAX package's does, field for field:
  ``shifts``, each ``send_idx``, ``idx_remap`` and ``recv_total``, on seeded
  banded and scattered patterns at p = 2, 4 and 8; ``plan_or_none`` gives
  ``None`` on the JAX package's degenerate pattern
  (``test_distributed.py:test_ell_plan_or_none_degenerate``).
* Row 12's shard entries (``ell_spmv_cache`` / ``ell_spmv2_cache``, their
  plain versions on the CPU) on the first and an interior rank's rows, with
  the cache filled as the plan says, give the whole product's rows bit for
  bit; so does the all-gather case (the cache is the whole vector).
* Row 9's shard entries (``df_dia_spmv_ext`` / ``df_dia_spmv2_ext``, plain
  on the CPU) on a rank's halo-extended words give the JAX package's
  ``DFRowShardContext._mv_ext`` bit for bit, and the whole double-word
  product's rows.
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from new_cg_variants_tpu.parallel import ell_exchange as jax_ex
from new_cg_variants_tpu_torch.ops import df_spmv as ds
from new_cg_variants_tpu_torch.ops import ell_spmv as es
from new_cg_variants_tpu_torch.ops.doublefloat import df_split, df_split3
from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy, from_coo
from new_cg_variants_tpu_torch.parallel import ell_exchange as ex

N = 512
#: (rows, slots, bandwidth, seed) of the seeded patterns
PATTERNS = {"banded 40": (N, 7, 40, 3), "banded 100": (N, 9, 100, 4),
            "scattered": (N, 7, None, 5)}
WORLDS = (2, 4, 8)


def ell_arrays(spec):
    """``(val, idx)`` in the original numbering, ``(n, L)`` float64 /
    int32, of :func:`torch_dist_worker.ell_matrix` through ``from_coo``."""
    op = from_coo(coo_from_scipy(worker.ell_matrix(*spec)), fmt="ell",
                  device="cpu")
    return op.val.contiguous(), op.idx.contiguous()


@pytest.fixture(scope="module")
def arrays():
    return {name: ell_arrays(spec) for name, spec in PATTERNS.items()}


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_plan_equals_the_jax_plan(arrays, pattern, p):
    idx = arrays[pattern][1].numpy()
    got, want = ex.plan_ell_exchange(idx, N, p), jax_ex.plan_ell_exchange(
        idx, N, p)
    assert got.shifts == want.shifts
    assert len(got.send_idx) == len(want.send_idx)
    for a, b in zip(got.send_idx, want.send_idx):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert got.idx_remap.dtype == want.idx_remap.dtype
    np.testing.assert_array_equal(got.idx_remap, want.idx_remap)
    assert got.recv_total == want.recv_total
    for margin in (0.25, 0.5, 1.0):
        mine = ex.plan_or_none(idx, N, p, margin)
        theirs = jax_ex.plan_or_none(idx, N, p, margin)
        assert (mine is None) == (theirs is None)


def test_banded_pattern_plans_neighbour_hops(arrays):
    """A coupling narrower than a shard needs only the ring's neighbours
    (the ``VecScatter`` property), well under the all-gather's volume."""
    idx = arrays["banded 40"][1].numpy()
    for p in (2, 4):
        plan = ex.plan_or_none(idx, N, p)
        assert plan is not None and set(plan.shifts) <= {1, p - 1}
        assert plan.recv_total < (N - N // p) // 2


def test_plan_or_none_declines_the_degenerate_pattern():
    from test_distributed import _random_sparse_ell

    op = _random_sparse_ell(256, 24, seed=2, bandwidth=None)
    idx = np.asarray(op.idx)
    assert ex.plan_or_none(idx, 256, 8) is None
    assert jax_ex.plan_or_none(idx, 256, 8) is None


def test_one_rank_never_plans(arrays):
    idx = arrays["banded 40"][1].numpy()
    assert ex.plan_or_none(idx, N, 1) is None


def cache_of(v, plan, p, rank):
    """Rank ``rank``'s cache ``[own rows | hop payloads]`` as the exchange
    fills it: for each hop s the entries rank ``(rank - s) % p`` sends."""
    m = N // p
    parts = [v[rank * m:(rank + 1) * m]]
    for s, send in zip(plan.shifts, plan.send_idx):
        src = (rank - s) % p
        parts.append(v[src * m:(src + 1) * m][torch.from_numpy(
            send[src]).long()])
    return torch.cat(parts)


def slot_major(t):
    """An ``(m, L)`` view of contiguous slot-major storage, as the shard
    keeps it."""
    return t.T.contiguous().T


@pytest.mark.parametrize("rank", ["first", "interior"])
@pytest.mark.parametrize("p", (2, 4))
@pytest.mark.parametrize("pattern", ["banded 40", "banded 100"])
def test_shard_product_equals_the_whole_products_rows(arrays, pattern, p,
                                                      rank):
    val, idx = arrays[pattern]
    plan = ex.plan_or_none(idx.numpy(), N, p)
    assert plan is not None
    r = 0 if rank == "first" else p // 2
    m = N // p
    rng = np.random.default_rng(p)
    v, w = (torch.from_numpy(rng.standard_normal(N)) for _ in range(2))
    rows = slice(r * m, (r + 1) * m)
    lval = slot_major(val[rows])
    lidx = slot_major(torch.from_numpy(plan.idx_remap[rows]))
    cv, cw = cache_of(v, plan, p, r), cache_of(w, plan, p, r)
    assert cv.shape == (m + plan.recv_total,)
    es.check_index(lidx, cv.shape[0])
    y = es.ell_spmv_cache(lval, lidx, cv)
    y2, z2 = es.ell_spmv2_cache(lval, lidx, cv, cw)
    full = es.ell_spmv(val, idx, v)
    f2, g2 = es.ell_spmv2(val, idx, v, w)
    assert torch.equal(y, full[rows])
    assert torch.equal(y2, f2[rows]) and torch.equal(z2, g2[rows])


@pytest.mark.parametrize("rank", ["first", "interior"])
def test_shard_product_with_the_whole_vector(arrays, rank):
    """The all-gather case: global indices into the whole vector."""
    val, idx = arrays["scattered"]
    p, m = 4, N // 4
    r = 0 if rank == "first" else 2
    rows = slice(r * m, (r + 1) * m)
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(N))
    y = es.ell_spmv_cache(slot_major(val[rows]), slot_major(idx[rows]), v)
    assert torch.equal(y, es.ell_spmv(val, idx, v)[rows])


def test_cache_index_is_held_to_the_cache_length(arrays):
    val, idx = arrays["banded 40"]
    plan = ex.plan_or_none(idx.numpy(), N, 2)
    lidx = torch.from_numpy(plan.idx_remap[:N // 2])
    es.check_index(lidx, N // 2 + plan.recv_total)
    with pytest.raises(ValueError, match="outside"):
        es.check_index(lidx, N // 2)


OFFSETS = (-5, -2, 0, 1, 5)


def df_shard(p, rank, seed=0):
    """A random three-word band, a double-word vector, and rank ``rank``'s
    slices: ``(words, v, local words, extended v words, rows)``."""
    rng = np.random.default_rng(seed)
    h, m = max(abs(o) for o in OFFSETS), N // p
    data = rng.standard_normal((len(OFFSETS), N))
    for d, off in enumerate(OFFSETS):  # explicit zeros outside the matrix
        data[d, max(0, N - off):] = 0.0
        data[d, :max(0, -off)] = 0.0
    words = df_split3(data, device="cpu")
    v = df_split(rng.standard_normal(N), device="cpu")
    rows = slice(rank * m, (rank + 1) * m)
    lo, hi = rank * m - h, (rank + 1) * m + h
    ext = []
    for t in (v.hi, v.lo):
        e = t.new_zeros(m + 2 * h)
        e[max(lo, 0) - lo: min(hi, N) - lo] = t[max(lo, 0): min(hi, N)]
        ext.append(e)
    local = tuple(w[:, rows].contiguous() for w in words)
    return words, v, local, ext, rows


@pytest.mark.parametrize("rank", ["first", "interior", "last"])
def test_df_shard_product_equals_jax_mv_ext(rank):
    import jax.numpy as jnp

    from new_cg_variants_tpu.parallel.contexts import DFRowShardContext

    p = 4
    r = {"first": 0, "interior": 1, "last": p - 1}[rank]
    words, v, local, (vh, vl), rows = df_shard(p, r)
    yh, yl = ds.df_dia_spmv_ext(OFFSETS, *local, (vh, vl))
    jctx = DFRowShardContext(OFFSETS, *(jnp.asarray(w.numpy())
                                        for w in local), "i")
    want = jctx._mv_ext(jnp.asarray(vh.numpy()), jnp.asarray(vl.numpy()))
    np.testing.assert_array_equal(yh.numpy(), np.asarray(want.hi))
    np.testing.assert_array_equal(yl.numpy(), np.asarray(want.lo))
    # and the whole product's rows, the same bits
    fh, fl = ds.df_dia_spmv(OFFSETS, *words, (v.hi, v.lo))
    assert torch.equal(yh, fh[rows]) and torch.equal(yl, fl[rows])
    (y2h, y2l), (z2h, z2l) = ds.df_dia_spmv2_ext(OFFSETS, *local, (vh, vl),
                                                 (vl, vh))
    assert torch.equal(y2h, yh) and torch.equal(y2l, yl)
    zh, zl = ds.df_dia_spmv_ext(OFFSETS, *local, (vl, vh))
    assert torch.equal(z2h, zh) and torch.equal(z2l, zl)


def test_df_ext_wrapper_refuses_mixed_devices():
    _, _, local, (vh, vl), _ = df_shard(2, 0)
    with pytest.raises(ValueError):
        ds.df_dia_spmv_ext(OFFSETS, *local, (vh.to("meta"), vl))
