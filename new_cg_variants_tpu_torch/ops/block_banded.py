"""Block-banded operator: the port of the JAX package's
``ops/block_banded.py``.

A general sparse matrix whose band can be made narrow is restructured:

1. reorder it to a small bandwidth (reverse Cuthill-McKee on the host, or
   the natural order when that is tighter);
2. pack the band into block-tridiagonal form, blocks of ``bs >= bandwidth``
   rows (a multiple of 128), so row block i couples only to blocks i-1, i,
   i+1;
3. a product is then the batched dense product ``(nb, bs, 3bs) @ (nb, 3bs,
   k)``, no gathers.

The packed blocks store ``3 bs n`` values whatever the nonzero count.  The
JAX package leaves the batched product to XLA (``jnp.einsum``, no Pallas
kernel); here it is ``torch.matmul``.  The system held is the reordered one,
``P A P^T``: :func:`solver_basis` moves ``b`` into that basis and ``x`` back,
once per solve (and does the same for an ELL operator in a locality
order).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..utils.profiling import span
from . import ell_spmv
from .operators import EllOperator

__all__ = ["BlockBandedOperator", "PermutedBlockBandedOperator",
           "block_banded_from_coo", "rcm_band_probe", "solver_basis"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class BlockBandedOperator:
    """Block-tridiagonal packed band; a product is one batched matmul.

    ``a_blk[i]`` is the ``(bs, 3 bs)`` dense coupling of row block i to
    ``[x_{i-1} | x_i | x_{i+1}]`` (zero blocks at the ends).  ``n_orig`` is
    the true dimension: rows past it are padding with a unit diagonal, so CG
    iterates on them stay exactly zero.
    """

    def __init__(self, a_blk: torch.Tensor, n_orig: int, nnz_stored: int):
        if a_blk.ndim != 3 or a_blk.shape[2] != 3 * a_blk.shape[1]:
            raise ValueError(f"expected (nb, bs, 3 bs) blocks, got "
                             f"{tuple(a_blk.shape)}")
        self.a_blk = a_blk
        self.n_orig = int(n_orig)
        self.nnz_stored = int(nnz_stored)

    @property
    def bs(self) -> int:
        return self.a_blk.shape[1]

    @property
    def n(self) -> int:
        return self.a_blk.shape[0] * self.a_blk.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnz_stored

    @property
    def dtype(self):
        return self.a_blk.dtype

    @property
    def device(self):
        return self.a_blk.device

    def _windows(self, v):
        """``(nb, 3 bs[, k])`` sliding block windows of v, zero-padded."""
        nb, bs = self.a_blk.shape[0], self.bs
        tail = tuple(v.shape[1:])
        z = v.new_zeros((bs,) + tail)
        vp = torch.cat([z, v, z]).reshape((nb + 2, bs) + tail)
        return torch.cat([vp[:-2], vp[1:-1], vp[2:]], dim=1)

    # Stored in bf16 the blocks are widened to the vectors' float32 at each
    # product, as XLA promotes the JAX package's bf16 x f32 einsum; no
    # float32 copy is kept (it would undo the storage tier).

    def mv(self, v):
        win = self._windows(v)[:, :, None]  # (nb, 3bs, 1)
        return torch.matmul(self.a_blk.to(v.dtype), win).reshape(-1)

    def mv2(self, v, w):
        win = self._windows(torch.stack([v, w], dim=1))  # ONE pass, 2 RHS
        y = torch.matmul(self.a_blk.to(v.dtype), win).reshape(-1, 2)
        return y[:, 0], y[:, 1]

    def diagonal(self):
        bs = self.bs
        d = self.a_blk[:, :, bs: 2 * bs]  # the centre blocks
        return torch.diagonal(d, dim1=1, dim2=2).reshape(-1)

    def astype(self, dtype):
        return BlockBandedOperator(self.a_blk.to(dtype), self.n_orig,
                                   self.nnz_stored)

    def to(self, device):
        return BlockBandedOperator(self.a_blk.to(device), self.n_orig,
                                   self.nnz_stored)

    def tocsr(self):
        """Host float64 CSR of the first ``n_orig`` rows and columns."""
        import scipy.sparse as sp

        nb, bs = self.a_blk.shape[0], self.bs
        blk = self.a_blk.detach().cpu().to(torch.float64).numpy()
        b, r, c = np.nonzero(blk)
        row = b * bs + r
        col = (b - 1) * bs + c  # window column -> global column
        keep = (row < self.n_orig) & (col >= 0) & (col < self.n_orig)
        return sp.csr_matrix((blk[b, r, c][keep], (row[keep], col[keep])),
                             shape=(self.n_orig, self.n_orig))

    def todense(self):
        return self.tocsr().toarray()


class PermutedBlockBandedOperator:
    """A reordered block-banded operator presented in original coordinates.

    ``inner`` holds ``P A P^T`` (padded); ``perm`` is the original ->
    reordered row map (an int64 tensor on the inner operator's device).
    ``mv`` permutes in and out around the inner product, so it takes and
    gives vectors in the original order; the solver entry points take the
    permutation out of the loop (:func:`solver_basis`).
    """

    def __init__(self, inner: BlockBandedOperator, perm: torch.Tensor):
        self.inner = inner
        self.perm = perm

    @property
    def n(self) -> int:
        return self.inner.n_orig

    @property
    def nnz(self) -> int:
        return self.inner.nnz

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    def _permute_in(self, v):
        vp = v.new_zeros((self.inner.n,) + tuple(v.shape[1:]))
        vp[: self.n] = v[self.perm]
        return vp

    def _permute_out(self, w):
        out = w.new_zeros((self.n,) + tuple(w.shape[1:]))
        out[self.perm] = w[: self.n]
        return out

    def mv(self, v):
        return self._permute_out(self.inner.mv(self._permute_in(v)))

    def mv2(self, v, w):
        y, z = self.inner.mv2(self._permute_in(v), self._permute_in(w))
        return self._permute_out(y), self._permute_out(z)

    def diagonal(self):
        return self._permute_out(self.inner.diagonal())

    def astype(self, dtype):
        return PermutedBlockBandedOperator(self.inner.astype(dtype), self.perm)

    def to(self, device):
        return PermutedBlockBandedOperator(self.inner.to(device),
                                           self.perm.to(device))

    def tocsr(self):
        import scipy.sparse as sp

        csr = self.inner.tocsr()
        inv = np.empty(self.n, dtype=np.int64)
        inv[self.perm.cpu().numpy()] = np.arange(self.n)
        # inner = A[perm][:, perm]; invert both axes to recover A
        return sp.csr_matrix(csr[inv][:, inv])

    def todense(self):
        return self.tocsr().toarray()


def solver_basis(op):
    """Take an operator's permutation out of the iteration loop.

    A :class:`PermutedBlockBandedOperator` holds the reordered system
    ``P A P^T`` behind a permute in and out on every product, and an
    :class:`~.operators.EllOperator` with a locality order ``perm`` stores
    ``B = P A P^T`` itself (:func:`.ell_spmv.reorder`).  Returns
    ``(inner_op, to_basis, from_basis)``: solve ``inner_op @ y =
    to_basis(b)`` and recover ``x = from_basis(y)``.  Both act on the first
    axis.  For the ELL operator ``inner_op`` is ``B`` on the same storage
    with no order, so no product gathers in or scatters out;
    ``to_basis(v) = v[perm]`` is row 12's gather in (:func:`.ell_spmv.
    gather_rows`: ``ell_gather`` on a CUDA vector), ``from_basis`` scatters
    ``out[perm] = y`` (:func:`.ell_spmv.scatter_rows`).  Iteration norms do not depend on the order, and
    block-banded pad rows carry a unit diagonal with a zero right-hand
    side, so their iterates stay zero.  Each move of either operator is a
    ``basis`` span with the counter ``basis_moves``
    (:mod:`..utils.profiling`).  For any other operator all three are the
    identity's, and open no span.
    """
    if isinstance(op, EllOperator) and op.perm is not None:
        perm = op.perm
        # the same object on every call, so that a later solve on ``op``
        # replays the graphs an earlier one captured (``graphs.Store``)
        inner = op.__dict__.get("_basis_op")
        if inner is None:
            inner = op._basis_op = EllOperator._stored(
                op.val_t, op.idx_t, op.nnz_stored, None)
        return (inner, _move(lambda v: ell_spmv.gather_rows(perm, v)),
                _move(lambda y: ell_spmv.scatter_rows(perm, y)))
    if not isinstance(op, PermutedBlockBandedOperator):
        def ident(v):
            return v
        return op, ident, ident
    return op.inner, _move(op._permute_in), _move(op._permute_out)


def _move(change):
    """``change`` of basis, each call a ``basis`` span."""
    def move(v):
        with span("basis", "basis_moves"):
            return change(v)
    return move


def rcm_band_probe(coo) -> int:
    """Bandwidth of the matrix in the better of {natural, RCM} order.

    The probe's full result is memoised on the COO object, so that
    :func:`block_banded_from_coo` on the same matrix does not reorder it
    again.
    """
    return _rcm_probe_full(coo)[0]


def _rcm_probe_full(coo):
    """``(min_bw, bw_natural, bw_rcm, rcm_perm)``, memoised on ``coo``;
    computing it is an ``rcm`` span (counter ``rcm``), once a ``coo``."""
    cached = getattr(coo, "_rcm_probe_cache", None)
    if cached is not None:
        return cached
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    with span("rcm", "rcm"):
        csr = coo.tocsr()
        row = np.asarray(coo.row)
        col = np.asarray(coo.col)
        bw = int(np.abs(row - col).max()) if len(row) else 0
        p = np.ascontiguousarray(reverse_cuthill_mckee(csr,
                                                       symmetric_mode=True))
        a2 = csr[p][:, p].tocoo()
        bw_rcm = int(np.abs(a2.row - a2.col).max()) if a2.nnz else 0
    result = (min(bw, bw_rcm), bw, bw_rcm, p)
    if hasattr(coo, "__dict__"):
        coo._rcm_probe_cache = result
    return result


def block_banded_from_coo(coo, dtype=torch.float32, reorder="auto",
                          device=None):
    """Pack a COO matrix into block-banded form; return ``(op, perm)``.

    ``reorder='auto'`` takes whichever of {natural, RCM} order has the
    smaller bandwidth, ``'rcm'`` RCM, ``None`` the natural order.  ``perm``
    (numpy) maps original -> reordered: the operator holds ``A[perm][:,
    perm]`` on ``device`` (default: the CUDA card), in ``dtype``, packed from
    float64 on the host; pad rows carry a unit diagonal.
    """
    dev = resolve_device(device)
    csr = coo.tocsr()
    n = csr.shape[0]
    row0 = np.asarray(coo.row)
    col0 = np.asarray(coo.col)
    bw_nat = int(np.abs(row0 - col0).max()) if len(row0) else 0

    perm = np.arange(n)
    row, col, val = row0, col0, np.asarray(coo.val, dtype=np.float64)
    if reorder in ("auto", "rcm"):
        _, _, bw_rcm, p = _rcm_probe_full(coo)
        if reorder == "rcm" or bw_rcm < bw_nat:
            a2 = csr[p][:, p].tocoo()
            perm, row, col, val = p, a2.row, a2.col, a2.data
            bw_nat = bw_rcm

    bs = _round_up(max(bw_nat, 1), 128)
    n_pad = _round_up(n, bs)
    nb = n_pad // bs

    a_blk = np.zeros((nb, bs, 3 * bs), dtype=np.float64)
    bi = row // bs
    ri = row % bs
    # column within the window [x_{bi-1} | x_bi | x_{bi+1}]
    ci = col - (bi - 1) * bs
    if not ((ci >= 0).all() and (ci < 3 * bs).all()):
        raise AssertionError("bandwidth exceeds bs")
    np.add.at(a_blk, (bi, ri, ci), val)
    # unit diagonal on pad rows: the padded system stays SPD and its pad
    # iterates zero (b is zero there)
    pad = np.arange(n, n_pad)
    a_blk[pad // bs, pad % bs, bs + pad % bs] = 1.0

    op = BlockBandedOperator(
        torch.from_numpy(a_blk).to(device=dev, dtype=dtype), n, int(len(val)))
    return op, perm
