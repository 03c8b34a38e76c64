"""The ELL row context's shards in a locality order, on the host.

On the all-gather route (the planner's ``None``, and every world of one) a
row shard of an ``EllOperator`` kept in a locality order (``op.perm``, the
RCM order ``from_coo`` keeps) takes its rows in that order and its touched
columns compacted in the same order (``parallel/dist.py:_ell_shard`` /
``_ell_locality_shard``); each product gathers ``cache[cols]`` in and
writes ``y[perm[i]]``.  Held here through the plain versions, with no
process group and no JAX ``dist_run``:

* on a scattered pattern (``test_torch_distributed_formats.py``'s
  ``ELL_SCATTERED``) and a permuted 27-point grid, for p = 1, 2 and 4 and
  every rank, the shard product in the locality order equals the given
  order's shard product bit for bit, in float32, float64 and bf16 storage,
  with 1 and 2 right-hand sides, and the dense product of the shard's rows
  within 1e-12 of each row's scale (float64);
* at world size 1 the shard is the operator's own storage and order;
* an operator without ``perm``, and the planned route, keep the given
  order;
* the wrappers' new arguments (a cache of ``c != m`` entries, the rows'
  and the columns' order) are checked with stand-ins for CUDA tensors.

The card runs the same shards through ``csrc/ell_spmv.cu``
(``chip_smoke.py``: ``check_ell_shards``).
"""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_dist_worker as worker
from new_cg_variants_tpu_torch.ops import _kernels
from new_cg_variants_tpu_torch.ops import ell_spmv as es
from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy, from_coo
from new_cg_variants_tpu_torch.parallel import dist

WORLDS = (1, 2, 4)
DENSE_TOL = 1e-12
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def grid27(g=8, seed=11):
    """The 27-point operator of a g^3 grid under a seeded symmetric
    permutation (SPD), scipy CSR."""
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(g, g))
    a = (27.0 * sp.eye(g ** 3) - sp.kron(sp.kron(t, t), t)).tocsr()
    p = np.random.default_rng(seed).permutation(g ** 3)
    return a[p][:, p].tocsr()


#: pattern -> scipy matrix: the scattered pattern of the distributed tests'
#: all-gather case and a permuted grid
MATRICES = {"scattered": lambda: worker.ell_matrix(512, 7, None, 3),
            "grid27": grid27}


@pytest.fixture(scope="module")
def ops():
    out = {}
    for name, make in MATRICES.items():
        a = make()
        op = from_coo(coo_from_scipy(a), fmt="ell", device="cpu")
        assert op.perm is not None  # RCM narrows both bands
        out[name] = (a, op)
    return out


def given_shard(op, p, rank):
    """The rank's rows in the original numbering: ``(val, idx)`` as ``(m,
    L)`` views of slot-major storage, indices into the whole vector."""
    m = op.n // p
    val_t, idx_t = op._given()
    rows = slice(rank * m, (rank + 1) * m)
    return val_t[:, rows].contiguous().T, idx_t[:, rows].contiguous().T


def vectors(n, dtype, seed):
    rng = np.random.default_rng(seed)
    vdt = torch.float32 if dtype == torch.bfloat16 else dtype
    return [torch.as_tensor(rng.standard_normal(n), dtype=vdt)
            for _ in range(2)]


def shard_cases():
    return [(name, p, rank) for name in MATRICES for p in WORLDS
            for rank in range(p)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,p,rank", shard_cases())
def test_locality_shard_gives_the_given_orders_bits(ops, name, p, rank,
                                                    dtype):
    _, op = ops[name]
    op = op.astype(DTYPES[dtype])
    m = op.n // p
    val, idx, shifts, send, order = dist._ell_shard(op, p, rank, m, "cpu")
    assert shifts is None and send == ()
    perm, cols = order
    assert perm.dtype == cols.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(m))
    # the touched columns, each once, in the operator's order
    gval, gidx = given_shard(op, p, rank)
    assert sorted(cols.tolist()) == sorted(set(gidx.flatten().tolist()))
    inv = torch.empty_like(op.perm.long())
    inv[op.perm.long()] = torch.arange(op.n)
    assert bool((inv[cols.long()].diff() > 0).all())
    assert bool((inv[(perm.long() + rank * m)].diff() > 0).all())
    v, w = vectors(op.n, DTYPES[dtype], seed=p + rank)
    want = es.ell_spmv_cache(gval, gidx, v)
    assert torch.equal(es.ell_spmv_cache(val, idx, v, perm, cols), want)
    want2 = es.ell_spmv2_cache(gval, gidx, v, w)
    got2 = es.ell_spmv2_cache(val, idx, v, w, perm, cols)
    for g, x in zip(got2, want2):
        assert torch.equal(g, x)


@pytest.mark.parametrize("name,p,rank", shard_cases())
def test_locality_shard_matches_the_dense_product(ops, name, p, rank):
    a, op = ops[name]
    m = op.n // p
    val, idx, _, _, order = dist._ell_shard(op, p, rank, m, "cpu")
    v, w = vectors(op.n, torch.float64, seed=7)
    rows = slice(rank * m, (rank + 1) * m)
    dense = a.toarray()[rows]
    y, z = es.ell_spmv2_cache(val, idx, v, w, *order)
    for got, x in ((es.ell_spmv_cache(val, idx, v, *order), v), (y, v),
                   (z, w)):
        want = dense @ x.numpy()
        scale = np.abs(dense) @ np.abs(x.numpy())
        assert np.all(np.abs(got.numpy() - want) <= DENSE_TOL * scale)


@pytest.mark.parametrize("name", list(MATRICES))
def test_one_rank_reuses_the_operators_storage_and_order(ops, name):
    _, op = ops[name]
    val, idx, shifts, _, (perm, cols) = dist._ell_shard(op, 1, 0, op.n,
                                                         "cpu")
    assert shifts is None
    assert val.T.data_ptr() == op.val_t.data_ptr()
    assert idx.T.data_ptr() == op.idx_t.data_ptr()
    assert perm is op.perm and cols is op.perm


@pytest.mark.parametrize("p", [1, 2, 4])
def test_an_operator_without_an_order_keeps_the_given_one(ops, p):
    a, _ = ops["scattered"]
    op = from_coo(coo_from_scipy(a), fmt="ell", device="cpu")
    op = type(op)._stored(*op._given(), op.nnz_stored, None)
    m = op.n // p
    for rank in range(p):
        val, idx, shifts, _, order = dist._ell_shard(op, p, rank, m, "cpu")
        assert shifts is None and order == ()
        gval, gidx = given_shard(op, p, rank)
        assert torch.equal(val, gval) and torch.equal(idx, gidx)


@pytest.mark.parametrize("p", [2, 4])
def test_the_planned_route_keeps_the_given_order(p):
    a = worker.ell_matrix(512, 7, 40, 3)  # banded: the planner plans
    op = from_coo(coo_from_scipy(a), fmt="ell", device="cpu")
    if op.perm is None:  # hold the route, not the order's origin
        op = type(op)._stored(*es.reorder(op.val_t, op.idx_t, torch.arange(
            op.n, dtype=torch.int32)), op.nnz_stored,
            torch.arange(op.n, dtype=torch.int32))
    m = op.n // p
    for rank in range(p):
        val, idx, shifts, send, order = dist._ell_shard(op, p, rank, m,
                                                        "cpu")
        assert shifts is not None and order == ()
        gval, gidx = given_shard(op, p, rank)
        assert torch.equal(val, gval)
        # the plan's cache coordinates: a row's own entries first, in order
        own = (gidx >= rank * m) & (gidx < (rank + 1) * m)
        assert torch.equal(idx[own], gidx[own] - rank * m)


def test_reordered_plain_gathers_through_the_columns_order():
    rng = np.random.default_rng(0)
    m, L, c = 6, 3, 10
    val = torch.as_tensor(rng.standard_normal((m, L)))
    cols = torch.tensor([7, 2, 9, 0, 4], dtype=torch.int32)
    idx = torch.as_tensor(rng.integers(0, len(cols), (m, L)),
                          dtype=torch.int32)
    perm = torch.tensor([3, 0, 5, 1, 4, 2], dtype=torch.int32)
    cache = torch.as_tensor(rng.standard_normal(c))
    got = es.ell_spmv_cache(val, idx, cache, perm, cols)
    want = torch.empty(m, dtype=val.dtype)
    want[perm.long()] = es._ell_mv_plain(val, idx, cache[cols.long()])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the CUDA wrappers' new arguments (no card: stand-ins for CUDA tensors)

_CUDA = torch.device("cuda", 0)


class _Fake(types.SimpleNamespace):
    """Just enough of a CUDA tensor for the wrappers' argument checks."""

    is_cuda = True
    device = _CUDA

    def is_contiguous(self):
        return True


def _vec(n, dtype=torch.float64):
    return _Fake(dtype=dtype, shape=(n,), ndim=1)


def _order(k, dtype=torch.int32, ndim=1):
    return _Fake(dtype=dtype, shape=(k,) if ndim == 1 else (k, 1),
                 ndim=ndim)


def _arrays(m, L, dtype=torch.float64):
    val = _Fake(dtype=dtype, shape=(m, L), ndim=2, T=_Fake())
    idx = _Fake(dtype=torch.int32, shape=(m, L), ndim=2, T=_Fake())
    return val, idx


def test_a_shard_order_takes_a_cache_longer_than_its_rows():
    m, L, c, k = 100, 7, 250, 180
    val, idx = _arrays(m, L)
    assert es.check_launch_args(val, idx, (_vec(c), _vec(c)), _order(m), c,
                                _order(k)) == (m, L, "f64")
    # the given order on a cache, and the operator's own order (c = m)
    assert es.check_launch_args(val, idx, (_vec(c),), None, c) == (
        m, L, "f64")
    assert es.check_launch_args(val, idx, (_vec(m),), _order(m)) == (
        m, L, "f64")
    bval, bidx = _arrays(m, L, torch.bfloat16)
    assert es.check_launch_args(bval, bidx, (_vec(c, torch.float32),),
                                _order(m), c, _order(k)) == (m, L, "bf16")


@pytest.mark.parametrize("bad", [
    "rows' order one short", "rows' order int64", "rows' order 2-D",
    "columns' order int64", "columns' order 2-D", "columns without rows",
    "rows without columns on a longer cache", "cache of the wrong length"])
def test_wrong_order_arguments_are_refused(bad):
    m, L, c, k = 100, 7, 250, 180
    val, idx = _arrays(m, L)
    vecs, perm, cols = (_vec(c),), _order(m), _order(k)
    if bad == "rows' order one short":
        perm = _order(m - 1)
    elif bad == "rows' order int64":
        perm = _order(m, torch.int64)
    elif bad == "rows' order 2-D":
        perm = _order(m, ndim=2)
    elif bad == "columns' order int64":
        cols = _order(k, torch.int64)
    elif bad == "columns' order 2-D":
        cols = _order(k, ndim=2)
    elif bad == "columns without rows":
        perm = None
    elif bad == "rows without columns on a longer cache":
        cols = None
    else:
        vecs = (_vec(c + 1),)
    with pytest.raises(ValueError):
        es.check_launch_args(val, idx, vecs, perm, c, cols)


@pytest.mark.parametrize("bad", ["int64", "2-D", "on another device"])
def test_the_gather_refuses_a_wrong_index_array(bad):
    v = _vec(250)
    perm = {"int64": _order(180, torch.int64), "2-D": _order(180, ndim=2),
            "on another device": _Fake(dtype=torch.int32, shape=(180,),
                                       ndim=1,
                                       device=torch.device("cuda", 1))}[bad]
    with pytest.raises(ValueError):
        es.ell_gather(perm, [v])


def test_the_kernel_launch_passes_the_second_vector_itself():
    """The C entry takes the second gathered vector's pointer from the
    caller (the gather's buffer holds ``len(cols)`` entries a vector, not
    ``m``), so its signature is unchanged and its comment says so."""
    text = (_kernels.CSRC / "ell_spmv.cu").read_text()
    assert "x0 + n" not in text
    assert "const T* x1 = static_cast<const T*>(v1);" in text
