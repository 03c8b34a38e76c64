"""Port parity: the ELL operator in a locality order (kernel row 12's
reordered storage).

An ``EllOperator`` may keep its rows in a locality order ``perm`` (the
storage then holds ``B = P A P^T``; a product gathers in, multiplies and
scatters out).  Held here, on the CPU, through the plain versions:

* the reordered operator against the JAX package's ``EllOperator.mv`` /
  ``mv2`` and its Pallas kernel in interpret mode, in float64 at rtol 1e-13
  of each row's scale, on permuted random patterns (ragged rows, rows of
  padding only, n in {1, 100, 4099});
* the reordered plain version against ``_ell_mv_plain`` / ``_ell_mv2_plain``
  bit for bit, in float32 and float64;
* ``from_coo(fmt="ell")``, the auto route and ``as_operator`` on a permuted
  scipy matrix keep the RCM order; a matrix in natural order keeps its own;
* ``val``, ``idx``, ``diagonal()``, ``todense()``, ``tocsr()``, ``astype()``
  and ``to()`` give the JAX package's arrays in the original numbering;
* ``df_operator`` over a reordered ELL inner gives the f32x2 product of the
  given order bit for bit;
* every variant name on the reordered operator keeps its nu and alpha
  histories within rtol 1e-10 of the JAX package's over 25 iterations.

The CUDA kernels themselves run only on the card (``chip_smoke.py``:
``check_ell``, which also holds the card's reordered product to the card's
product in the given order bit for bit).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import new_cg_variants_tpu as cgt
from new_cg_variants_tpu.matio.matrix_market import CooMatrix as JaxCoo
from new_cg_variants_tpu.ops import operators as jo
from new_cg_variants_tpu.ops.ell_pallas import ell_spmv as jax_ell_kernel
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.ops import doublefloat as tdf
from new_cg_variants_tpu_torch.ops import ell_spmv as es
from new_cg_variants_tpu_torch.ops import operators as to
from new_cg_variants_tpu_torch.ops.block_banded import _rcm_probe_full

RTOL = 1e-13
HIST_RTOL = 1e-10
ITERS = 25


def coo_pair(a):
    c = sp.coo_matrix(a)
    row, col = c.row.astype(np.int64), c.col.astype(np.int64)
    return (JaxCoo(a.shape, row, col, c.data),
            port.CooMatrix(a.shape, row.copy(), col.copy(), c.data.copy()))


def random_pattern(n, lens, seed):
    """Rows of ``range(*lens)`` random entries (0: a row of padding only)
    under a random symmetric permutation, as scipy CSR."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(lens[0], lens[1], n)
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, n, counts.sum())
    a = sp.csr_matrix((rng.uniform(-1.0, 1.0, len(rows)), (rows, cols)),
                      shape=(n, n))
    p = rng.permutation(n)
    return a[p][:, p].tocsr()


def grid9(m=24, seed=0):
    """The 9-point operator of an m x m grid, permuted (SPD)."""
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(m, m))
    a = (9.0 * sp.eye(m * m) - sp.kron(t, t)).tocsr()
    p = np.random.default_rng(seed).permutation(m * m)
    return a[p][:, p].tocsr()


def reordered(a, seed=0):
    """The port's ``EllOperator`` of ``a`` in a random order (RCM may not
    narrow a random pattern's band) and the JAX operator."""
    jc, tc = coo_pair(a)
    val, idx, nnz = to.build_ell(tc)
    perm = np.random.default_rng(seed).permutation(a.shape[0])
    top = to.EllOperator(torch.from_numpy(val), torch.from_numpy(idx), nnz,
                         perm=perm)
    return top, jo.from_coo(jc, fmt="ell", dtype=jnp.float64)


SHAPES = {"n=1": (1, (1, 2)), "n=100": (100, (1, 6)),
          "ragged n=4099": (4099, (0, 10))}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_reordered_operator_matches_jax_kernel_and_gather(shape):
    n, lens = SHAPES[shape]
    top, jop = reordered(random_pattern(n, lens, seed=n), seed=n + 1)
    assert top.perm is not None and top.val_t.is_contiguous()
    v, w = np.random.default_rng(2).standard_normal((2, n))
    val, idx = np.asarray(jop.val), np.asarray(jop.idx)
    scale = np.abs(val).sum(axis=1).max() * max(np.abs(v).max(),
                                                 np.abs(w).max()) + 1e-300
    y = top.mv(torch.from_numpy(v)).numpy()
    kernel = np.asarray(jax_ell_kernel(jnp.asarray(val), jnp.asarray(idx),
                                       jnp.asarray(v), interpret=True))
    np.testing.assert_allclose(y, kernel, rtol=RTOL, atol=RTOL * scale)
    np.testing.assert_allclose(y, np.asarray(jop.mv(jnp.asarray(v))),
                               rtol=RTOL, atol=RTOL * scale)
    y2, z2 = top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    jy2, jz2 = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(z2.numpy(), np.asarray(jz2), rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_reordered_plain_gives_the_given_orders_bits(shape, dtype):
    n, lens = SHAPES[shape]
    a = random_pattern(n, lens, seed=n)
    val, idx, _ = to.build_ell(coo_pair(a)[1])
    val_t = torch.from_numpy(np.ascontiguousarray(val.T)).to(dtype)
    idx_t = torch.from_numpy(np.ascontiguousarray(idx.T))
    perm = es.check_perm(torch.from_numpy(
        np.random.default_rng(n + 1).permutation(n)), n)
    bval_t, bidx_t = es.reorder(val_t, idx_t, perm)
    # padding keeps value 0 and points at its own (reordered) row
    pad = bval_t == 0
    assert bool((bidx_t[pad] == torch.arange(n, dtype=torch.int32)
                 .expand_as(bidx_t)[pad]).all())
    rng = np.random.default_rng(3)
    v, w = (torch.from_numpy(rng.standard_normal(n)).to(dtype)
            for _ in range(2))
    want = es._ell_mv_plain(val_t.T, idx_t.T, v)
    assert torch.equal(es.ell_spmv(bval_t.T, bidx_t.T, v, perm), want)
    got2 = es.ell_spmv2(bval_t.T, bidx_t.T, v, w, perm)
    for g, x in zip(got2, es._ell_mv2_plain(val_t.T, idx_t.T, v, w)):
        assert torch.equal(g, x)
    assert torch.equal(es._ell_gather_plain(perm, [v])[0], v[perm.long()])
    val_r, idx_r = es.restore(bval_t, bidx_t, perm)
    assert torch.equal(val_r, val_t) and torch.equal(idx_r, idx_t)


def test_a_cpu_product_in_a_locality_order_counts_no_launch():
    top, _ = reordered(random_pattern(300, (1, 8), seed=5))
    v = torch.ones(300, dtype=torch.float64)
    before = [fn.launches for fn in es.ELL_WRAPPERS]
    top.mv(v)
    top.mv2(v, v)
    assert [fn.launches for fn in es.ELL_WRAPPERS] == before


@pytest.mark.parametrize("bad", ["short", "repeat", "float", "negative",
                                 "past the end"])
def test_an_order_that_is_no_permutation_is_refused(bad):
    val = torch.ones(4, 2, dtype=torch.float64)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    perm = {"short": [0, 1, 2], "repeat": [0, 1, 1, 3],
            "float": torch.tensor([0.0, 1.0, 2.0, 3.0]),
            "negative": [-1, 1, 2, 3], "past the end": [0, 1, 2, 4]}[bad]
    with pytest.raises(ValueError, match="permutation"):
        to.EllOperator(val, idx, 8, perm=perm)


@pytest.mark.parametrize("entry", ["from_coo", "auto", "as_operator"])
def test_sparse_entry_points_keep_the_rcm_order(entry, monkeypatch):
    """A permuted grid: RCM narrows the band, so the ELL operator keeps the
    probe's RCM order, and the auto route takes it from the memo (one RCM
    per build)."""
    from scipy.sparse import csgraph

    a = grid9()
    _, bw_natural, bw_rcm, want = _rcm_probe_full(coo_pair(a)[1])
    assert bw_rcm < bw_natural
    _, tc = coo_pair(a)
    # the auto route sends the grid to ELL only past the block-banded budget
    monkeypatch.setattr(to.choose_format, "__defaults__", (256, 10, None))
    probes = []
    rcm = csgraph.reverse_cuthill_mckee
    monkeypatch.setattr(csgraph, "reverse_cuthill_mckee",
                        lambda *x, **k: probes.append(1) or rcm(*x, **k))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if entry == "from_coo":
            op = to.from_coo(tc, fmt="ell", device="cpu")
        elif entry == "auto":
            op = to.from_coo(tc, device="cpu")
        else:
            op = to.as_operator(a, device="cpu")
    assert isinstance(op, to.EllOperator) and op.perm is not None
    assert len(probes) == 1
    np.testing.assert_array_equal(op.perm.numpy(), want)


def test_a_matrix_in_natural_order_keeps_its_order():
    """A grid in natural order: RCM does not narrow its band, so the
    operator keeps the given order and no product permutes."""
    m = 24
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(m, m))
    a = (9.0 * sp.eye(m * m) - sp.kron(t, t)).tocsr()
    _, tc = coo_pair(a)
    _, bw_natural, bw_rcm, _ = _rcm_probe_full(tc)
    assert bw_rcm >= bw_natural
    op = to.from_coo(tc, fmt="ell", device="cpu")
    assert op.perm is None and to.ell_order(tc) is None
    assert op.val.data_ptr() == op.val_t.data_ptr()  # views, no copy


@pytest.fixture(scope="module")
def ell_pair():
    a = grid9()
    jc, tc = coo_pair(a)
    top = to.from_coo(tc, fmt="ell", device="cpu")
    jop = jo.from_coo(jc, fmt="ell", dtype=jnp.float64)
    assert top.perm is not None
    return a, jop, top


@pytest.mark.parametrize("what", ["val", "idx", "diagonal", "todense",
                                  "tocsr", "astype", "to"])
def test_surface_is_the_jax_layout_in_the_original_numbering(ell_pair, what):
    a, jop, top = ell_pair
    if what in ("val", "idx"):
        got = getattr(top, what)
        assert got.shape == (top.n, 9) and not got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jop, what)))
    elif what == "diagonal":
        np.testing.assert_array_equal(top.diagonal().numpy(),
                                      np.asarray(jop.diagonal()))
    elif what == "todense":
        np.testing.assert_array_equal(top.todense(), np.asarray(jop.todense()))
    elif what == "tocsr":
        np.testing.assert_array_equal(top.tocsr().toarray(), a.toarray())
        np.testing.assert_array_equal(top.tocsr().toarray(),
                                      jop.tocsr().toarray())
    elif what == "astype":
        f32 = top.astype(torch.float32)
        assert f32.perm is top.perm and f32.idx_t is top.idx_t
        np.testing.assert_array_equal(
            f32.val.numpy(), np.asarray(jop.astype(jnp.float32).val))
        v = torch.from_numpy(np.random.default_rng(4).standard_normal(top.n))
        given = to.EllOperator(top.val.float(), top.idx, top.nnz)
        assert torch.equal(f32.mv(v.float()), given.mv(v.float()))
    else:
        moved = top.to("cpu")
        assert moved.device.type == "cpu" and moved.nnz == top.nnz
        assert torch.equal(moved.perm, top.perm)
        np.testing.assert_array_equal(moved.val.numpy(), np.asarray(jop.val))
        np.testing.assert_array_equal(moved.idx.numpy(), np.asarray(jop.idx))


def test_double_words_over_a_reordered_inner_give_the_given_orders_bits(
        ell_pair):
    a, _, top = ell_pair
    given = to.EllOperator(top.val, top.idx, top.nnz)
    dtop = tdf.df_operator(top, device="cpu")
    dgiven = tdf.df_operator(given, device="cpu")
    v = tdf.df_split(np.random.default_rng(6).standard_normal(top.n),
                     device="cpu")
    w = tdf.df_split(np.random.default_rng(7).standard_normal(top.n),
                     device="cpu")
    for got, want in ((dtop.mv(v), dgiven.mv(v)),
                      *zip(dtop.mv2(v, w), dgiven.mv2(v, w))):
        assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    d, dg = dtop.diagonal(), dgiven.diagonal()
    assert torch.equal(d.hi, dg.hi) and torch.equal(d.lo, dg.lo)
    np.testing.assert_array_equal(dtop.todense(), a.toarray())


@pytest.mark.parametrize("name", list(port.VARIANT_NAMES))
def test_every_name_on_the_reordered_operator_matches_jax(ell_pair, name):
    a, jop, top = ell_pair
    b = a @ np.ones(a.shape[0])
    kw = dict(max_iter=ITERS + 1, probes=("nu", "alpha"),
              preconditioner="jacobi" if name.endswith("pcg") else None)
    want = cgt.run(name, jop, b, dtype=np.float64, **kw)
    got = port.run(name, top, b, device="cpu", dtype=np.float64, **kw)
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(got[p], want[p], rtol=HIST_RTOL)
    assert got["nu"][-1] < 1e-3 * got["nu"][0]
