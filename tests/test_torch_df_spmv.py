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
    teff threads walks its columns t + k teff in bit-reversed k with one
    partial per level (a binary counter), then the block's halving tree."""
    width = 1
    while width < hi.shape[0]:
        width *= 2
    hi = torch.cat([hi, hi.new_zeros(width - hi.shape[0])])
    lo = torch.cat([lo, lo.new_zeros(width - lo.shape[0])])
    teff = min(width, threads)
    count = width // teff
    depth = count.bit_length() - 1
    totals = []
    for th in range(teff):
        slot = {}
        for m in range(count):
            k = int(format(m, f"0{depth}b")[::-1], 2) if depth else 0
            c = th + k * teff
            carry = (hi[c:c + 1], lo[c:c + 1])
            tz = (~m & (m + 1)).bit_length() - 1
            for level in range(tz):
                carry = tc.df_add(*slot.pop(level), *carry)
            slot[tz] = carry
        totals.append(slot[depth])
    sh = torch.cat([p[0] for p in totals])
    sl = torch.cat([p[1] for p in totals])
    return tc._df_tree_sum(sh, sl)


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
