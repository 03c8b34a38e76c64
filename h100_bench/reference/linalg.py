"""Plain products and a plain conjugate gradient, in PyTorch.

The benchmark's reference: nothing here imports the program under test.
Every function takes tensors on any device and computes in their dtype
(float64 for the reference; a lower one for the control), on vectors of
shape ``(n,)`` or blocks of right-hand sides of shape ``(n, m)``.
"""

from __future__ import annotations

import torch

__all__ = ["band_matvec", "stencil27_matvec", "cg"]


def band_matvec(diag, off_value, k, x):
    """``A x`` for the PETSc k-banded model matrix: ``diag`` on the main
    diagonal, ``off_value`` at every ``0 < |i - j| < k``
    (``ex2a.c:86-90``), one shifted slice a side and an off-diagonal."""
    d = diag if x.ndim == 1 else diag[:, None]
    y = d * x
    for s in range(1, k):
        y[:-s] += off_value * x[s:]
        y[s:] += off_value * x[:-s]
    return y


def stencil27_matvec(grid, x):
    """``A x`` for HPCG's operator on a ``grid^3`` box in its natural
    numbering (``index = (i * grid + j) * grid + l``): 26 on the diagonal,
    -1 to each of the up to 26 neighbours, nothing past the boundary
    (``GenerateProblem``).  That is ``27 x`` minus the sum over each
    point's 3x3x3 box, taken as 27 shifted slices of the zero-padded box."""
    m = x.shape[1:] if x.ndim > 1 else ()
    box = x.reshape(grid, grid, grid, *m)
    pad = x.new_zeros(grid + 2, grid + 2, grid + 2, *m)
    pad[1:-1, 1:-1, 1:-1] = box
    total = torch.zeros_like(box)
    for a in range(3):
        for b in range(3):
            for c in range(3):
                total += pad[a:a + grid, b:b + grid, c:c + grid]
    return (27 * box - total).reshape(x.shape)


def cg(matvec, b, max_iter, rtol=None):
    """Plain (Hestenes-Stiefel) CG from ``x0 = 0`` in ``b``'s dtype:
    ``max_iter`` iterations, or fewer once ``||r|| <= rtol ||b||`` (the
    recurrence residual, the natural norm of an unpreconditioned solve).
    Returns ``(x, iterations)``."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    stop = None if rtol is None else float(rtol) ** 2 * float(rr)
    k = 0
    while k < max_iter:
        if stop is not None and float(rr) <= stop:
            break
        q = matvec(p)
        alpha = rr / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        k += 1
    return x, k
