"""Constant-band stencil operator: the port of the JAX package's
``ops/stencil.py``.

The PETSc k-banded model problem has one constant ``off_value`` on every
in-band off-diagonal (``ex2a.c:86-90``).  For such a band

    y_i = d_i v_i + c * (sum_{|i-j|<k, j != i} v_j) = (d_i - c) v_i + c W_i,

where ``W_i`` is the width-(2k-1) moving-window sum of v: O(n) work with
prefix sums and no matrix storage, so a product moves a few vectors instead
of the ``(ndiags, n)`` band.  The window sum takes the JAX package's
two-level scheme (prefix within blocks of 256, then over the block totals),
which bounds the cancellation error of differencing prefix values at
O(B + n/B) units of rounding, and adds in the same order.

The JAX package leaves this to XLA; here it is plain PyTorch
(``torch.cumsum``) on either device, with no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BandedStencilOperator", "window_sum"]

_BLOCK = 256


def window_sum(v: torch.Tensor, k: int) -> torch.Tensor:
    """``W_i = sum_{j: |i-j| < k} v_j`` by two-level prefix sums; positions
    outside ``[0, n)`` contribute zero."""
    if k <= 1:
        return v
    n = v.shape[0]
    h = k - 1
    pad = (-n) % _BLOCK
    blocks = torch.cat([v, v.new_zeros(pad)]).reshape(-1, _BLOCK)
    intra = torch.cumsum(blocks, dim=1)
    totals = intra[:, -1]
    block_prefix = torch.cat([v.new_zeros(1), torch.cumsum(totals, 0)[:-1]])
    incl = (intra + block_prefix[:, None]).reshape(-1)[:n]
    s = torch.cat([v.new_zeros(1), incl])  # s[j] = sum(v[:j])
    upper = torch.cat([s[k:], s[n].expand(min(k, n))])[:n]
    if h >= n:
        return upper
    lower = torch.cat([v.new_zeros(h), s[: n - h]])
    return upper - lower


class BandedStencilOperator:
    """``A = diag(d) + c * (hollow band of ones at |i - j| < k)``.

    ``diag`` is an ``(n,)`` tensor, ``off_value`` a 0-d tensor on its device,
    ``k`` the PETSc model problem's band parameter (as
    :func:`~..matio.problems.banded_model` with ``fmt='stencil'``).
    """

    def __init__(self, diag: torch.Tensor, off_value, k: int):
        self.diag = diag
        self.off_value = torch.as_tensor(off_value, dtype=diag.dtype,
                                         device=diag.device)
        self.k = int(k)

    @property
    def n(self) -> int:
        return self.diag.shape[0]

    @property
    def nnz(self) -> int:
        n, k = self.n, self.k
        return int(n + 2 * sum(max(n - o, 0) for o in range(1, k)))

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def mv(self, v):
        w = window_sum(v, self.k)
        return (self.diag - self.off_value) * v + self.off_value * w

    def mv2(self, v, w):
        return self.mv(v), self.mv(w)

    def diagonal(self):
        return self.diag

    def astype(self, dtype):
        return BandedStencilOperator(self.diag.to(dtype),
                                     self.off_value.to(dtype), self.k)

    def to(self, device):
        return BandedStencilOperator(self.diag.to(device),
                                     self.off_value.to(device), self.k)

    def tocsr(self):
        import scipy.sparse as sp

        n, k = self.n, self.k
        off = float(self.off_value)
        diags = [self.diag.detach().cpu().to(torch.float64).numpy()]
        offsets = [0]
        for o in range(1, min(k, n)):
            band = np.full(n - o, off)
            diags += [band, band]
            offsets += [o, -o]
        return sp.diags(diags, offsets, shape=(n, n), format="csr")

    def todense(self):
        n, k = self.n, self.k
        a = np.zeros((n, n))
        off = float(self.off_value)
        for o in range(1, min(k, n)):
            idx = np.arange(n - o)
            a[idx, idx + o] = off
            a[idx + o, idx] = off
        a[np.arange(n), np.arange(n)] = self.diag.detach().cpu().double().numpy()
        return a
