"""Port parity: the double-word kernels' plain versions (``ops/df_spmv``).

Each plain version — what the wrapper runs on CPU tensors, and what the CUDA
kernel is held to bit for bit on the card — against the JAX package's Pallas
kernel in interpret mode on the same words, with the JAX package's own
tolerances: 1e-13 on vectors and products, 1e-12 on dots.

* DIA product (``df_dia_spmv``, ``df_dia_spmv2``): the high words agree bit for
  bit; the low words within 1e-13 (in interpret mode the kernel body goes
  through XLA, which may contract multiply-adds, as the JAX package's test
  notes), and against the JAX generic formulation bit for bit.
* Dense product: the JAX kernel renormalises every term before its tree and
  the JAX generic formulation does not; the port follows the generic one (bit
  for bit) and is within 1e-13 of the kernel.
* Pipe vector phase: against JAX only at power-of-two tile counts (JAX tile
  4096: n = 5000 gives 2 tiles, n = 16,000 gives 4); JAX's cross-tile combine
  halves the tile count as if it were a power of two, so at 3 tiles it drops
  partials and at 5 it raises (asserted below).  At 3, 5, 6 and 7 tiles the
  port is held to float64.

The kernels' own design (the in-thread tree of ``csrc/df_common.cuh``) is
modelled here in Python and held bit for bit to the plain tree.
"""

import numpy as np
import pytest
import torch

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops import df_spmv as jspmv
from new_cg_variants_tpu.ops import doublefloat as jdf
from new_cg_variants_tpu_torch.ops import compensated as tc
from new_cg_variants_tpu_torch.ops import df_spmv as ts

JAX_TILE = 4096


def t(a):
    return torch.from_numpy(np.array(a))


def words(df):
    return t(df.hi), t(df.lo)


def as64(pair):
    return pair[0].double().numpy() + pair[1].double().numpy()


def jax64(df):
    return np.asarray(df.hi, np.float64) + np.asarray(df.lo, np.float64)


@pytest.fixture(scope="module")
def dia():
    """The JAX test's DF DIA operator (banded_model(5000, k=8)) and its
    float64 CSR."""
    jop, _, _ = jax_banded(5000, k=8)
    dop = jdf.df_operator(jop, fmt="dia")
    return dop, jop.tocsr()


@pytest.fixture(scope="module")
def vw():
    rng = np.random.default_rng(0)
    v64, w64 = rng.standard_normal(5000), rng.standard_normal(5000)
    return (v64, jdf.df_split(v64)), (w64, jdf.df_split(w64))


def band_words(dop):
    return (dop.inner.offsets, t(dop.inner.data), t(dop.lo_data),
            t(dop.lo2_data))


def test_dia_plain_against_the_jax_kernel(dia, vw):
    dop, csr = dia
    (v64, v), (w64, w) = vw
    want = jspmv.df_dia_spmv(dop.inner.offsets, dop.inner.data, dop.lo_data,
                             dop.lo2_data, v, interpret=True)
    y = ts.df_dia_spmv(*band_words(dop), words(v))
    np.testing.assert_array_equal(y[0].numpy(), np.asarray(want.hi))
    y64 = csr @ v64
    assert np.abs(as64(y) - jax64(want)).max() / np.abs(y64).max() < 1e-13
    assert np.abs(as64(y) - y64).max() / np.abs(y64).max() < 1e-13
    want2 = jspmv.df_dia_spmv2(dop.inner.offsets, dop.inner.data, dop.lo_data,
                               dop.lo2_data, v, w, interpret=True)
    y2, z2 = ts.df_dia_spmv2(*band_words(dop), words(v), words(w))
    assert torch.equal(y2[0], y[0]) and torch.equal(y2[1], y[1])
    np.testing.assert_array_equal(z2[0].numpy(), np.asarray(want2[1].hi))
    z64 = csr @ w64
    assert np.abs(as64(z2) - z64).max() / np.abs(z64).max() < 1e-13


def test_dia_plain_is_the_jax_generic_formulation(dia, vw):
    dop, _ = dia
    (_, v), _ = vw
    want = dop._mv_dia(dop.inner, v)
    got = ts.df_dia_spmv(*band_words(dop), words(v))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.hi))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.lo))


@pytest.mark.parametrize("offsets", [(-3, -1, 0, 2, 7), (0,), (-40, 0, 45)])
def test_dia_plain_offsets_not_symmetric_against_float64(offsets):
    n = 300
    rng = np.random.default_rng(len(offsets))
    a = rng.uniform(-1, 1, (len(offsets), n))
    for d, off in enumerate(offsets):  # explicit zeros outside the matrix
        if off > 0:
            a[d, n - off:] = 0.0
        elif off < 0:
            a[d, :-off] = 0.0
    v64 = rng.standard_normal(n)
    hi, lo, lo2 = (t(w) for w in jdf.df_split3(a))
    v = words(jdf.df_split(v64))
    got = as64(ts.df_dia_spmv(offsets, hi, lo, lo2, v))
    vv = as64(v)
    want = np.zeros(n)
    scale = np.zeros(n)
    for d, off in enumerate(offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        want[i] += a[d, i] * vv[i + off]
        scale[i] += np.abs(a[d, i] * vv[i + off])
    assert (np.abs(got - want) / np.maximum(scale, 1e-300)).max() < 1e-13


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((300, 300))
    a = a + a.T
    v64, w64 = rng.standard_normal(300), rng.standard_normal(300)
    return jdf.df_operator(a), a, (v64, jdf.df_split(v64)), (w64,
                                                             jdf.df_split(w64))


def test_dense_plain_against_the_jax_kernel(dense):
    dop, a, (v64, v), (w64, w) = dense
    mats = (t(dop.inner.a), t(dop.lo_data), t(dop.lo2_data))
    want = jspmv.df_dense_spmv(dop.inner.a, dop.lo_data, dop.lo2_data, v,
                               interpret=True)
    y = ts.df_dense_spmv(*mats, words(v))
    y64 = a @ v64
    np.testing.assert_array_equal(y[0].numpy(), np.asarray(want.hi))
    assert np.abs(as64(y) - jax64(want)).max() / np.abs(y64).max() < 1e-13
    assert np.abs(as64(y) - y64).max() / np.abs(y64).max() < 1e-13
    y2, z2 = ts.df_dense_spmv2(*mats, words(v), words(w))
    want2 = jspmv.df_dense_spmv2(dop.inner.a, dop.lo_data, dop.lo2_data, v, w,
                                 interpret=True)
    assert torch.equal(y2[0], y[0]) and torch.equal(y2[1], y[1])
    z64 = a @ w64
    assert np.abs(as64(z2) - jax64(want2[1])).max() / np.abs(z64).max() < 1e-13


def test_dense_plain_is_the_jax_generic_formulation(dense):
    dop, _, (_, v), _ = dense
    want = dop._mv_gathered(dop.inner.a, dop.lo_data, dop.lo2_data, v.hi, v.lo)
    got = ts.df_dense_spmv(t(dop.inner.a), t(dop.lo_data), t(dop.lo2_data),
                           words(v))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.hi))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.lo))


def _phase_inputs(n, seed=3):
    rng = np.random.default_rng(seed)
    vecs = [jdf.df_split(rng.standard_normal(n)) for _ in range(6)]
    a1 = jdf.df_split(np.float64(0.3712345678901234))
    beta = jdf.df_split(np.float64(0.1298765432109876))
    return vecs, a1, beta


def _port_phase(vecs, a1, beta):
    return ts.df_pipe_vector_phase(*[words(v) for v in vecs], words(a1),
                                   words(beta))


@pytest.mark.parametrize("n", [5000, 4 * JAX_TILE - 384])
def test_pipe_phase_against_the_jax_kernel(n):
    """At 2 and 4 JAX tiles, where JAX's combine is right."""
    vecs, a1, beta = _phase_inputs(n)
    want = jspmv.df_pipe_vector_phase(*vecs, a1, beta, interpret=True)
    got = _port_phase(vecs, a1, beta)
    for i in range(5):
        np.testing.assert_allclose(as64(got[i]), jax64(want[i]), rtol=1e-13,
                                   atol=1e-13)
    for i in range(4):
        np.testing.assert_allclose(as64(got[5][i]), jax64(want[5][i]),
                                   rtol=1e-12)


def _float64_phase(vecs, a1, beta):
    x, r, w, u, p, s = (jax64(v) for v in vecs)
    a, b = jax64(a1), jax64(beta)
    x2, r2, w2 = x + a * p, r - a * s, w - a * u
    p2, s2 = r2 + b * p, w2 + b * s
    return (x2, r2, w2, p2, s2), (p2 @ s2, r2 @ s2, s2 @ s2, r2 @ r2)


@pytest.mark.parametrize("tiles", [3, 5, 6, 7])
def test_pipe_phase_against_float64_where_jax_is_wrong(tiles):
    n = tiles * JAX_TILE - 100
    vecs, a1, beta = _phase_inputs(n, seed=tiles)
    got = _port_phase(vecs, a1, beta)
    want_vecs, want_dots = _float64_phase(vecs, a1, beta)
    for g, w in zip(got[:5], want_vecs):
        np.testing.assert_allclose(as64(g), w, rtol=1e-13, atol=1e-13)
    for g, w in zip(got[5], want_dots):
        np.testing.assert_allclose(as64(g), w, rtol=1e-12)


def test_jax_combine_fault_at_tile_counts_not_a_power_of_two():
    """The reference's fault (ROADMAP.md section 3): at 3 tiles the JAX dots
    miss a third of the sum, at 5 the combine raises."""
    vecs, a1, beta = _phase_inputs(3 * JAX_TILE, seed=1)
    jax_dots = jspmv.df_pipe_vector_phase(*vecs, a1, beta, interpret=True)[5]
    _, want = _float64_phase(vecs, a1, beta)
    assert abs(jax64(jax_dots[3]) - want[3]) / want[3] > 0.1
    vecs, a1, beta = _phase_inputs(5 * JAX_TILE, seed=1)
    with pytest.raises(TypeError):
        jspmv.df_pipe_vector_phase(*vecs, a1, beta, interpret=True)


def test_pipe_phase_plain_is_generic_over_double_words():
    """The plain version against JAX's ``generic_pipe_vector_phase`` over
    double words, bit for bit (vectors and dots)."""
    from new_cg_variants_tpu.solvers.context import generic_pipe_vector_phase

    vecs, a1, beta = _phase_inputs(1000)
    ctx = jdf.DoubleFloatContext(None)
    want = generic_pipe_vector_phase(ctx, *vecs, a1, beta)
    got = _port_phase(vecs, a1, beta)
    for g, w in list(zip(got[:5], want[:5])) + list(zip(got[5], want[5])):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w.hi))
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w.lo))


def test_cpu_calls_count_no_launch_and_mixed_devices_raise(dia, vw):
    dop, _ = dia
    (_, v), _ = vw
    before = [fn.launches for fn in ts.DF_WRAPPERS]
    ts.df_dia_spmv(*band_words(dop), words(v))
    _port_phase(*_phase_inputs(300))
    assert [fn.launches for fn in ts.DF_WRAPPERS] == before
    meta = torch.empty(5000, device="meta")
    with pytest.raises(ValueError):
        ts.df_dia_spmv(*band_words(dop), (meta, meta))


def _tree_like_the_kernel(hi, lo, threads):
    """A Python model of csrc/df_common.cuh:tree_sum for one sum: each of
    teff threads (all at once, as tensors over t) walks its columns t + k teff
    in bit-reversed k with one partial per level (a binary counter); then the
    block's halving tree."""
    width = 1
    while width < hi.shape[0]:
        width *= 2
    hi = torch.cat([hi, hi.new_zeros(width - hi.shape[0])])
    lo = torch.cat([lo, lo.new_zeros(width - lo.shape[0])])
    teff = min(width, threads)
    count = width // teff
    depth = count.bit_length() - 1
    cols = torch.arange(teff)
    slot = {}
    for m in range(count):
        k = int(format(m, f"0{depth}b")[::-1], 2) if depth else 0
        carry = (hi[cols + k * teff], lo[cols + k * teff])
        tz = (~m & (m + 1)).bit_length() - 1
        for level in range(tz):
            carry = tc.df_add(*slot.pop(level), *carry)
        slot[tz] = carry
    return tc._df_tree_sum(*slot[depth])


def _warp_tree4_like_the_kernel(v):
    """A Python model of csrc/df_common.cuh:warp_tree_sum4 on (rows, 32)
    word pairs, one per sum: lanes l and l + 16 swap two of the four sums,
    then lanes l and l + 8 one of two, then each sum halves over its eight
    lanes; returns the four sums of each row."""
    lane = torch.arange(32)

    def pick(c, a, b):
        return tuple(torch.where(c, x, y) for x, y in zip(a, b))

    low = lane < 16
    a = []
    for k in range(2):
        keep = pick(low, v[k], v[k + 2])
        got = tuple(w[:, lane ^ 16] for w in pick(low, v[k + 2], v[k]))
        a.append(tc.df_add(*pick(low, keep, got), *pick(low, got, keep)))
    first = (lane & 8) == 0
    keep = pick(first, a[0], a[1])
    got = tuple(w[:, lane ^ 8] for w in pick(first, a[1], a[0]))
    b = tc.df_add(*pick(first, keep, got), *pick(first, got, keep))
    for off in (4, 2, 1):
        up = torch.where(lane + off < 32, lane + off, lane)
        b = tc.df_add(*b, *(w[:, up] for w in b))
    return [(b[0][:, 8 * d], b[1][:, 8 * d]) for d in range(4)]


def _tile_tree_like_the_kernel(terms):
    """A Python model of csrc/df_pipe.cu's tree over each tile of 256 rows
    (rows past the data zero pairs), one warp a tile: lane l holds the rows
    l + 32 j, j < 8, and sums them in the lane (j with j + 4, + 2, + 1: the
    rows 128, 64, 32 apart), then warp_tree_sum4 over the lanes.  ``terms``:
    the four sums' (hi, lo) row terms; returns the tile sums."""
    tiles = -(-terms[0][0].shape[0] // 256)
    v = []
    for hi, lo in terms:
        pad = tiles * 256 - hi.shape[0]
        h, lw = (torch.cat([w, w.new_zeros(pad)]).reshape(tiles, 8, 32)
                 for w in (hi, lo))
        for half in (4, 2, 1):
            h, lw = tc.df_add(h[:, :half], lw[:, :half], h[:, half:2 * half],
                              lw[:, half:2 * half])
        v.append((h[:, 0], lw[:, 0]))
    return _warp_tree4_like_the_kernel(v)


def _dots_like_the_kernel(terms, threads, warp_tiles=1024):
    """Row 11's dots as csrc/df_pipe.cu sums them: the tile trees; from
    ``warp_tiles`` tiles (padded to a power of two, W) block g sums the
    tiles g + w W / 8, w < 8, by the tree's first three levels (w with w + 4,
    + 2, + 1); then the block that draws the last ticket sums the partials by
    tree_sum, ``threads`` wide."""
    dots = []
    for th, tl in _tile_tree_like_the_kernel(terms):
        width = 1
        while width < th.shape[0]:
            width *= 2
        if width >= warp_tiles:
            parts = max(width // 8, 1)
            th, tl = (torch.cat([w, w.new_zeros(8 * parts - w.shape[0])])
                      .reshape(8, parts) for w in (th, tl))
            for half in (4, 2, 1):
                th, tl = tc.df_add(th[:half], tl[:half], th[half:2 * half],
                                   tl[half:2 * half])
            th, tl, width = th[0], tl[0], parts
        dots.append(_tree_like_the_kernel(th, tl, threads))
    return dots


def _dot_terms(vecs):
    """The four dots' row terms as the kernel forms them, from the plain
    phase's r2, p2, s2 (word pairs)."""
    _, r2, _, p2, s2, _ = vecs
    terms = []
    for a, b in ((p2, s2), (r2, s2), (s2, s2), (r2, r2)):
        ph, e = tc.two_prod(a[0], b[0])
        terms.append((ph, e + (a[0] * b[1] + a[1] * b[0] + a[1] * b[1])))
    return terms


@pytest.mark.parametrize("n", [1, 300, 3 * 256, 5 * 256 - 7, 2560 * 256])
def test_kernel_dot_order_is_the_same_at_256_and_1024_threads(n):
    """The dots' order is fixed by the tiles and the tree, not by how many
    threads sum the partials or whether blocks sum eight tiles first;
    chip_smoke.tile_order_dots, which the card's kernel is held to bit for
    bit, is the same order."""
    import chip_smoke

    vecs = _port_phase(*_phase_inputs(n, seed=n % 97))
    terms = _dot_terms(vecs)
    want = chip_smoke.tile_order_dots(torch, vecs[1], vecs[3], vecs[4])
    for threads in (256, 1024):
        for warp_tiles in (1, 1024):
            got = _dots_like_the_kernel(terms, threads, warp_tiles)
            for a, b in zip(got, want):
                assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n", [1, 5, 100, 255, 256])
def test_kernel_dot_order_at_one_tile_is_the_plain_tree(n):
    """Below one tile the kernel's zero rows up to 256 add nothing to
    normalised pairs: the plain tree's bits."""
    rng = np.random.default_rng(n)
    hi = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    lo = torch.from_numpy((rng.standard_normal(n) * 2.0 ** -30)
                          .astype(np.float32))
    hi, lo = tc.fast_two_sum(hi, lo)
    want = tc._df_tree_sum(hi, lo)
    for threads in (256, 1024):
        for got in _dots_like_the_kernel([(hi, lo)] * 4, threads):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


@pytest.mark.parametrize("tiles", [3, 5, 6, 7, 11])
def test_kernel_dot_order_against_float64(tiles):
    """At tile counts that are not powers of two the kernel's order sums
    every partial: the dots within 1e-12 of float64."""
    vecs, a1, beta = _phase_inputs(tiles * 256 - 37, seed=tiles)
    got = _port_phase(vecs, a1, beta)
    _, want = _float64_phase(vecs, a1, beta)
    _, r2, _, p2, s2 = (as64(v) for v in got[:5])
    scale = (np.abs(p2) @ np.abs(s2), np.abs(r2) @ np.abs(s2), s2 @ s2,
             r2 @ r2)
    for d, dot in enumerate(_dots_like_the_kernel(_dot_terms(got), 256)):
        assert abs(as64(dot) - want[d]) <= 1e-12 * scale[d]


@pytest.mark.parametrize("n,threads", [(1, 256), (5, 256), (300, 256),
                                       (1000, 64), (2560, 256), (4096, 16)])
def test_kernel_tree_order_is_the_plain_tree(n, threads):
    rng = np.random.default_rng(n)
    hi = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    lo = torch.from_numpy((rng.standard_normal(n) * 2.0 ** -30)
                          .astype(np.float32))
    got = _tree_like_the_kernel(hi, lo, threads)
    want = tc._df_tree_sum(hi, lo)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = tc._df_sum_axis1(hi[None, :], lo[None, :])
    assert torch.equal(rows[0][0], want[0]) and torch.equal(rows[1][0], want[1])
