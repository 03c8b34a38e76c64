"""Error-free transforms and compensated (double-word) arithmetic on words.

The port of the JAX package's ``ops/compensated.py``: Dekker/Knuth error-free
transforms in plain PyTorch, the double-word addition and product built from
them, and the compensated dot product (Ogita-Rump-Oishi "Dot2" with tree
accumulation: forward error O(eps^2 n) instead of O(eps n)).  Everything
here works on the words of a double-word value, ``hi + lo``, as separate
tensors of one floating type; :mod:`.doublefloat` wraps them into values.

Each step is one torch operation, in the order the JAX package writes it, so
every intermediate is rounded where the reference rounds it.  Nothing here
may be fused: ``torch.add(..., alpha=)``, ``addcmul``, ``lerp``, ``addmm`` or
``torch.compile`` would let the CPU's vectorised paths contract a multiply
and an add into one fused multiply-add, and the error word of a transform
would no longer be the exact error.  The CUDA kernels of ``csrc/df_*.cu``
repeat these steps with intrinsics that are never contracted.

Used by :class:`~..solvers.context.Context` with ``compensated=True`` (every
dot product a :func:`comp_dot`) and by the double-word mode.
"""

from __future__ import annotations

import torch

__all__ = ["two_sum", "two_prod", "fast_two_sum", "df_add", "df_mul",
           "df_div", "df_dot_words", "comp_dot", "comp_dot_pair"]


def two_sum(a, b):
    """Knuth 2Sum: ``a + b = s + e`` exactly (no magnitude assumption)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split against the working type's half-precision constant:
    2^12 + 1 for float32, 2^27 + 1 for float64."""
    splitter = 134217729.0 if a.dtype == torch.float64 else 4097.0
    t = splitter * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker 2Prod: ``a * b = p + e`` exactly (barring over/underflow)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def fast_two_sum(a, b):
    """Dekker fast 2Sum; requires ``|a| >= |b|``."""
    s = a + b
    e = b - (s - a)
    return s, e


def df_add(ah, al, bh, bl):
    """Accurate double-word addition (two 2Sums, two renormalisations).

    The "sloppy" form (one 2Sum, the low words added plainly) has an O(eps)
    relative error when the high words cancel, and cancellation is what a CG
    residual update does; this form keeps O(eps^2) for any signs.
    """
    sh, se = two_sum(ah, bh)
    th, te = two_sum(al, bl)
    se = se + th
    sh, se = fast_two_sum(sh, se)
    se = se + te
    return fast_two_sum(sh, se)


def df_mul(ah, al, bh, bl):
    """Double-word product of ``ah + al`` and ``bh + bl``."""
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh + al * bl)
    return fast_two_sum(p, e)


def df_div(ah, al, bh, bl):
    """Double-word quotient: ``q1 = ah / bh`` refined by the double-word
    residual of ``a - q1 b``."""
    q1 = ah / bh
    ph, pl = df_mul(q1, torch.zeros_like(q1), bh, bl)
    rh, rl = df_add(ah, al, -ph, -pl)
    q2 = (rh + rl) / bh
    return fast_two_sum(q1, q2)


def _df_tree_sum(hi, lo):
    """Sum of the double-word values ``hi[j] + lo[j]`` by a halving tree:
    padded with zero pairs to a power of two m, then element j is added to
    element j + m/2 until one is left; returns the pair as 0-d tensors."""
    n = hi.shape[0]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        hi = torch.cat([hi, hi.new_zeros(m - n)])
        lo = torch.cat([lo, lo.new_zeros(m - n)])
    while m > 1:
        half = m // 2
        hi, lo = df_add(hi[:half], lo[:half], hi[half:], lo[half:])
        m = half
    return hi[0], lo[0]


def _df_sum_axis1(hi, lo):
    """Row sums of ``(n, m)`` double-word arrays by the halving tree of
    :func:`_df_tree_sum` over the columns."""
    m = 1
    while m < hi.shape[1]:
        m *= 2
    if m != hi.shape[1]:
        pad = m - hi.shape[1]
        hi = torch.cat([hi, hi.new_zeros(hi.shape[0], pad)], dim=1)
        lo = torch.cat([lo, lo.new_zeros(lo.shape[0], pad)], dim=1)
    while m > 1:
        half = m // 2
        hi, lo = df_add(hi[:, :half], lo[:, :half], hi[:, half:], lo[:, half:])
        m = half
    return hi[:, 0], lo[:, 0]


def df_dot_words(ah, al, bh, bl):
    """Double-word dot product of ``ah + al`` and ``bh + bl``: each product
    of the high words transformed exactly, the cross terms in its error
    word, the pairs summed by the double-word tree."""
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh + al * bl)
    return _df_tree_sum(p.reshape(-1), e.reshape(-1))


def comp_dot_pair(x, y):
    """Compensated dot product as the unevaluated pair ``(value, error)``:
    each product transformed exactly (2Prod), the pairs summed by the
    double-word tree."""
    p, e = two_prod(x.reshape(-1), y.reshape(-1))
    return _df_tree_sum(p, e)


def comp_dot(x, y):
    """Compensated dot product collapsed to a working-precision scalar."""
    s, c = comp_dot_pair(x, y)
    return s + c
