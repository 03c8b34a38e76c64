"""Double-word (f32x2) products and pipe vector phase: the port of the JAX
package's ``ops/df_spmv.py``.

A double-word value travels as a pair ``(hi, lo)`` of tensors of one floating
type, a matrix as the exact three-word split ``hi + lo + lo2`` of its float64
values (:func:`.doublefloat.df_split3`).  :mod:`.doublefloat` wraps the
pairs into :class:`~.doublefloat.DF` values; this module works on the words.

* :func:`df_dia_spmv` / :func:`df_dia_spmv2` — ``A @ v`` (and ``A @ w`` from
  the same read of the band) for a row-indexed DIA matrix: per diagonal, in
  stored order, an error-free product and a double-word addition.
* :func:`df_dense_spmv` / :func:`df_dense_spmv2` — the same for a dense
  matrix; the terms of a row are summed by the double-word halving tree over
  the columns padded with zero pairs to a power of two.
* :func:`df_pipe_vector_phase` — the unpreconditioned pipe vector phase in
  double words: five AXPYs and the four dots ``(mu, delta, gamma, nu)``.

On CUDA tensors each launches its hand-written kernel (``csrc/df_spmv.cu``,
``csrc/df_pipe.cu``), which takes float32 words only, any band width and any
``n``; on CPU tensors it runs the plain PyTorch version beside it
(``_df_*_plain``: the JAX package's ``DFOperator._mv_dia``, ``_mv_gathered``
and ``generic_pipe_vector_phase`` over double words), which is also what the
kernel is checked against on the card.  The kernels repeat the plain
versions' steps in the same order with roundings that are never contracted,
so products and vectors agree bit for bit; only the four dots of the vector
phase sum in another order (per 256-row tile, then over the tiles).  Each
wrapper counts its launches in ``.launches``; every kernel here is one launch
a call, the vector phase's cross-tile combine included.
"""

from __future__ import annotations

import torch

from ._kernels import KERNEL_TILE, check_band, offsets_array
from ._shift import shift
from .compensated import (
    _df_sum_axis1,
    df_add,
    df_dot_words,
    df_mul,
    fast_two_sum,
    two_prod,
)
from .fused_step import _pointers, _where
from .spmv_dia import stages_window
from .sym_fused import _scalar

__all__ = ["df_dia_spmv", "df_dia_spmv2", "df_dense_spmv", "df_dense_spmv2",
           "df_pipe_vector_phase"]

#: Widest padded row (dense) or count of dot partials (vector phase) that a
#: kernel's in-thread tree takes: 256 threads << csrc/df_common.cuh:
#: kMaxTreeDepth, far beyond what fits on the card.
MAX_TREE_WIDTH = KERNEL_TILE << 10


def _df_dia_mv_plain(offsets, hi, lo, lo2, vh, vl):
    """Plain double-word DIA product: per diagonal an error-free product of
    the shifted vector, then a double-word addition into the sum."""
    acc_h = torch.zeros_like(vh)
    acc_l = torch.zeros_like(vl)
    for d, off in enumerate(offsets):
        svh = shift(vh, off)
        svl = shift(vl, off)
        ph, e = two_prod(hi[d], svh)
        e = e + (hi[d] * svl + lo[d] * svh + lo[d] * svl + lo2[d] * svh)
        ph, pl = fast_two_sum(ph, e)
        acc_h, acc_l = df_add(acc_h, acc_l, ph, pl)
    return acc_h, acc_l


def _df_dense_mv_plain(a, lo, lo2, vh, vl):
    """Plain double-word dense product: every term error-free, the cross
    terms in its error word, the row reduced by the double-word tree."""
    p, e = two_prod(a, vh)
    e = e + (a * vl + lo * vh + lo * vl + lo2 * vh)
    return _df_sum_axis1(p, e)


def _df_pipe_vector_phase_plain(x, r, w, u, p, s, a1, beta):
    """Plain double-word pipe vector phase (every argument a word pair)."""
    x2 = df_add(*x, *df_mul(*a1, *p))
    ph, pl = df_mul(*a1, *s)
    r2 = df_add(*r, -ph, -pl)
    ph, pl = df_mul(*a1, *u)
    w2 = df_add(*w, -ph, -pl)
    p2 = df_add(*r2, *df_mul(*beta, *p))
    s2 = df_add(*w2, *df_mul(*beta, *s))
    dots = tuple(df_dot_words(*a, *b)
                 for a, b in ((p2, s2), (r2, s2), (s2, s2), (r2, r2)))
    return x2, r2, w2, p2, s2, dots


def _check_words(ref, words, shape):
    """Word arrays of the card kernels: float32, ``ref``'s device, contiguous
    and of ``shape``."""
    for t in words:
        if t.dtype != torch.float32:
            raise TypeError(f"the double-word kernels take float32 words, "
                            f"not {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"word array on {t.device}, expected {ref.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"word array must be contiguous {tuple(shape)}, "
                             f"got {tuple(t.shape)}")


def _launch_dia(offsets, hi, lo, lo2, words):
    from ._kernels import library

    offsets = tuple(offsets)
    n, _ = check_band(offsets, hi)
    _check_words(hi, (hi, lo, lo2), hi.shape)
    _check_words(hi, words, (n,))
    ys = [torch.empty_like(v) for v in words]
    rc = library("df_spmv.cu").df_dia_spmv_f32(
        hi.data_ptr(), lo.data_ptr(), lo2.data_ptr(), offsets_array(offsets),
        len(offsets), n, _pointers(words), _pointers(ys), len(words) // 2,
        int(stages_window(offsets)), hi.device.index,
        torch.cuda.current_stream(hi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"df_dia_spmv kernel launch failed: CUDA error {rc}")
    return [tuple(ys[k:k + 2]) for k in range(0, len(ys), 2)]


def _launch_dense(a, lo, lo2, words):
    from ._kernels import library

    if a.ndim != 2 or a.shape[0] != a.shape[1] or a.shape[0] == 0:
        raise ValueError(f"expected a square matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    _check_words(a, (a, lo, lo2), (n, n))
    _check_words(a, words, (n,))
    if n > MAX_TREE_WIDTH:
        raise ValueError(f"dense dimension {n} > {MAX_TREE_WIDTH}")
    ys = [torch.empty_like(v) for v in words]
    rc = library("df_spmv.cu").df_dense_spmv_f32(
        a.data_ptr(), lo.data_ptr(), lo2.data_ptr(), n, _pointers(words),
        _pointers(ys), len(words) // 2, a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"df_dense_spmv kernel launch failed: CUDA error {rc}")
    return [tuple(ys[k:k + 2]) for k in range(0, len(ys), 2)]


def _product(wrapper, plain, launch, head, pairs):
    """The kernel on CUDA words, else the plain version on CPU words."""
    words = [t for pair in pairs for t in pair]
    if _where(list(head[-3:]) + words) == "cpu":
        return [plain(*head, *pair) for pair in pairs]
    ys = launch(*head, words)
    wrapper.launches += 1
    return ys


def df_dia_spmv(offsets, hi, lo, lo2, v):
    """``A @ v`` for the three-word DIA matrix ``(hi, lo, lo2)`` (each
    ``(ndiag, n)``, row-indexed) and the word pair ``v``; returns the pair."""
    (y,) = _product(df_dia_spmv, _df_dia_mv_plain, _launch_dia,
                    (offsets, hi, lo, lo2), (v,))
    return y


def df_dia_spmv2(offsets, hi, lo, lo2, v, w):
    """``(A @ v, A @ w)`` from one read of the band words."""
    y, z = _product(df_dia_spmv2, _df_dia_mv_plain, _launch_dia,
                    (offsets, hi, lo, lo2), (v, w))
    return y, z


def df_dense_spmv(a, lo, lo2, v):
    """``A @ v`` for the three-word dense matrix ``(a, lo, lo2)`` (each
    ``(n, n)``) and the word pair ``v``; returns the pair."""
    (y,) = _product(df_dense_spmv, _df_dense_mv_plain, _launch_dense,
                    (a, lo, lo2), (v,))
    return y


def df_dense_spmv2(a, lo, lo2, v, w):
    """``(A @ v, A @ w)`` from one read of the matrix words."""
    y, z = _product(df_dense_spmv2, _df_dense_mv_plain, _launch_dense,
                    (a, lo, lo2), (v, w))
    return y, z


#: The vector phase's ticket counters, one ``int32`` for each (device,
#: stream), zero between launches (csrc/df_pipe.cu)
_TICKETS: dict = {}


def _tickets(device, stream):
    """The ticket counter of launches on ``stream`` of ``device``, allocated
    zeroed at first use."""
    key = (device, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None:  # zeroed on the current stream, which is ``stream``
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def df_pipe_vector_phase(x, r, w, u, p, s, a1, beta):
    """Double-word pipe vector phase: ``(x2, r2, w2, p2, s2, (mu, delta,
    gamma, nu))`` from the word pairs ``x r w u p s`` and the double-word
    scalars ``a1``, ``beta`` (pairs of 0-d tensors or numbers).

    On the card it is one launch on the current stream: the block that
    finishes last sums the tiles' dot partials, found by a ticket counter
    that the launch leaves at zero (:func:`_tickets`).  Launches on one
    stream run one after the other and share their stream's counter, so
    launches on different streams may run at once."""
    vecs = (x, r, w, u, p, s)
    words = [t for pair in vecs for t in pair]
    if _where(words) == "cpu":
        a1, beta = (tuple(_scalar(c, words[0]) for c in pair)
                    for pair in (a1, beta))
        return _df_pipe_vector_phase_plain(*vecs, a1, beta)
    from ._kernels import library

    ref = words[0]
    if ref.ndim != 1 or ref.shape[0] == 0:
        raise ValueError(f"expected non-empty vectors, got {tuple(ref.shape)}")
    n = ref.shape[0]
    _check_words(ref, words, (n,))
    nblocks = -(-n // KERNEL_TILE)
    if nblocks > MAX_TREE_WIDTH:
        raise ValueError(f"n = {n} gives more than {MAX_TREE_WIDTH} partials")
    scalars = [_scalar(c, ref) for pair in (a1, beta) for c in pair]
    outs = [torch.empty_like(ref) for _ in range(10)]
    partials = torch.empty((8, nblocks), dtype=ref.dtype, device=ref.device)
    dots = torch.empty((4, 2), dtype=ref.dtype, device=ref.device)
    stream = torch.cuda.current_stream(ref.device)
    rc = library("df_pipe.cu").df_pipe_f32(
        n, _pointers(words), len(words), _pointers(scalars), len(scalars),
        _pointers(outs), len(outs), partials.data_ptr(), dots.data_ptr(),
        _tickets(ref.device, stream).data_ptr(), ref.device.index,
        stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"df_pipe_vector_phase kernel launch failed: CUDA error {rc}")
    df_pipe_vector_phase.launches += 1
    pairs = [tuple(outs[k:k + 2]) for k in range(0, 10, 2)]
    return (*pairs, tuple((dots[d, 0], dots[d, 1]) for d in range(4)))


DF_WRAPPERS = (df_dia_spmv, df_dia_spmv2, df_dense_spmv, df_dense_spmv2,
               df_pipe_vector_phase)
for _fn in DF_WRAPPERS:
    _fn.launches = 0
