"""Linear operators and the format policy for general sparse input.

* :class:`DenseOperator` — a plain 2-D tensor; ``mv`` is one matrix product
  (``torch.matmul``: the JAX package leaves it to XLA too, no kernel of its
  own), ``mv2`` one product with ``[v | w]``; bf16 storage is widened to the
  vectors' float32 at the product.
* :class:`DiaOperator` — diagonal storage, row-indexed: ``data[d, i] =
  A[i, i + offsets[d]]`` with explicit zeros where the position falls outside
  the matrix.  ``mv`` / ``mv2`` go through :mod:`.spmv_dia`: the hand-written
  kernel on the card, the plain shift formulation on the CPU.
* :class:`EllOperator` — padded ELL for general sparse matrices: ``(n, L)``
  values and int32 column indices, kept slot-major, in a locality order
  where :func:`from_coo` finds one.  ``mv`` / ``mv2`` go through
  :mod:`.ell_spmv` (the kernels on the card, the plain gather on the CPU).
* :class:`~.sym_dia.SymDiaOperator`, :class:`~.stencil.BandedStencilOperator`
  and :class:`~.block_banded.PermutedBlockBandedOperator` (their own
  modules) — symmetric half-band storage, the matrix-free constant band and
  the reordered block-tridiagonal packing.

All expose ``n``, ``nnz``, ``dtype``, ``device``, ``mv(v)``, ``mv2(v, w)``
(one pass over A for both), ``diagonal()``, ``astype(dtype)``,
``to(device)``, ``todense()`` and ``tocsr()`` (host, float64).

:func:`from_coo` builds any of them from a
:class:`~..matio.matrix_market.CooMatrix`; with ``fmt="auto"`` it follows
:func:`choose_format`, the JAX package's policy with its thresholds, so both
packages pick the same format for the same matrix.  :func:`as_operator`
takes operators, arrays, scipy sparse matrices and ``CooMatrix``.  The
``build_*`` functions make the host arrays (float64 values), bit for bit
the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..matio.matrix_market import CooMatrix
from . import ell_spmv, spmv_dia

__all__ = ["DenseOperator", "DiaOperator", "EllOperator", "from_coo",
           "as_operator", "build_dense", "build_dia", "build_sym_dia",
           "build_ell", "choose_format", "coo_from_scipy", "ell_order",
           "torch_dtype"]


def torch_dtype(dtype):
    """A torch dtype for a torch or numpy dtype (``None`` stays ``None``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class DenseOperator:
    """Dense SPD operator; SpMV is a matrix product."""

    def __init__(self, a: torch.Tensor):
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected a square matrix, got {tuple(a.shape)}")
        self.a = a

    @property
    def n(self) -> int:
        return self.a.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.a.shape[0] * self.a.shape[1])

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    # Stored in bf16 the matrix is widened to the vectors' float32 at each
    # product, as XLA promotes a bf16 x f32 product; no float32 copy is kept
    # (it would undo the storage tier).

    def mv(self, v):
        return self.a.to(v.dtype) @ v

    def mv2(self, v, w):
        out = self.a.to(v.dtype) @ torch.stack([v, w], dim=1)
        return out[:, 0], out[:, 1]

    def diagonal(self):
        return torch.diagonal(self.a)

    def astype(self, dtype):
        return DenseOperator(self.a.to(dtype))

    def to(self, device):
        return DenseOperator(self.a.to(device))

    def todense(self):
        return self.a.detach().cpu().to(torch.float64).numpy()

    def tocsr(self):
        import scipy.sparse as sp

        return sp.csr_matrix(self.todense())


class DiaOperator:
    """Diagonal-storage operator, row-indexed.

    ``offsets`` is a tuple of any distinct integers (negative ones are the
    lower diagonals); ``data`` is a ``(ndiags, n)`` torch tensor and
    ``mv``/``mv2`` run on its device.
    """

    def __init__(self, offsets, data: torch.Tensor):
        offsets = tuple(int(o) for o in offsets)
        if len(set(offsets)) != len(offsets):
            raise ValueError(f"repeated offsets in {offsets}")
        if data.ndim != 2 or data.shape[0] != len(offsets):
            raise ValueError(f"data shape {tuple(data.shape)} does not match "
                             f"{len(offsets)} offsets")
        self.offsets = offsets
        self.data = data

    @property
    def n(self) -> int:
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        n = self.n
        return int(sum(n - abs(o) for o in self.offsets))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def mv(self, v):
        return spmv_dia.dia_spmv(self.offsets, self.data, v)

    def mv2(self, v, w):
        return spmv_dia.dia_spmv2(self.offsets, self.data, v, w)

    def diagonal(self):
        return self.data[self.offsets.index(0)]

    def astype(self, dtype):
        return DiaOperator(self.offsets, self.data.to(dtype))

    def to(self, device):
        return DiaOperator(self.offsets, self.data.to(device).contiguous())

    def tocsr(self):
        import scipy.sparse as sp

        n = self.n
        data = self.data.detach().cpu().to(torch.float64).numpy()
        rows, cols, vals = [], [], []
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(data[d, i])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n))

    def todense(self):
        return self.tocsr().toarray()


class EllOperator:
    """Padded-ELL operator for general sparse matrices.

    ``val[i, l]`` / ``idx[i, l]`` are the l-th stored entry of row i; padding
    slots hold value 0 and index i (so every gather stays in bounds), and a
    duplicate ``(row, col)`` takes a slot of its own.  ``nnz_stored`` counts
    the stored entries, padding excluded.

    The operator keeps one slot-major copy, ``val_t`` / ``idx_t`` of shape
    ``(L, n)``, contiguous (int32 indices).  On the card slot l of
    neighbouring rows is then one coalesced read (``csrc/ell_spmv.cu``).
    With ``perm`` (a permutation of ``range(n)``) that copy holds the rows in
    this locality order instead, ``B = P A P^T`` (:func:`.ell_spmv.reorder`),
    and every product gathers in and scatters out through ``perm``: the same
    terms in the same order, so the same bits as the given order.
    :func:`from_coo` passes the reverse Cuthill-McKee order when it narrows
    the band.  ``val`` / ``idx`` are the JAX package's ``(n, L)`` layout in
    the original numbering: views of the copy in the given order, rebuilt
    from it on each call in a locality order (for host-side uses:
    ``todense``, ``tocsr``, the double-word split).
    """

    def __init__(self, val: torch.Tensor, idx: torch.Tensor,
                 nnz_stored: int = 0, perm=None):
        if val.ndim != 2 or idx.shape != val.shape:
            raise ValueError(f"ELL arrays of shapes {tuple(val.shape)} and "
                             f"{tuple(idx.shape)}, expected one (n, L)")
        if idx.device != val.device:
            raise ValueError(f"indices on {idx.device}, values on "
                             f"{val.device}")
        ell_spmv.check_index(idx, val.shape[0])
        self.val_t = val.T.contiguous()
        self.idx_t = idx.T.to(torch.int32).contiguous()
        self.nnz_stored = int(nnz_stored)
        self.perm = None
        if perm is not None:
            self.perm = ell_spmv.check_perm(
                torch.as_tensor(perm).to(val.device), val.shape[0])
            self.val_t, self.idx_t = ell_spmv.reorder(self.val_t, self.idx_t,
                                                      self.perm)

    @classmethod
    def _stored(cls, val_t, idx_t, nnz_stored, perm):
        """An operator on storage already in the order ``perm``."""
        op = cls.__new__(cls)
        op.val_t, op.idx_t, op.nnz_stored, op.perm = (val_t, idx_t,
                                                      nnz_stored, perm)
        return op

    def _given(self):
        """Slot-major ``(L, n)`` arrays in the original numbering."""
        if self.perm is None:
            return self.val_t, self.idx_t
        return ell_spmv.restore(self.val_t, self.idx_t, self.perm)

    @property
    def val(self):
        return self._given()[0].T

    @property
    def idx(self):
        return self._given()[1].T

    @property
    def n(self) -> int:
        return self.val_t.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnz_stored

    @property
    def dtype(self):
        return self.val_t.dtype

    @property
    def device(self):
        return self.val_t.device

    def mv(self, v):
        return ell_spmv.ell_spmv(self.val_t.T, self.idx_t.T, v, self.perm)

    def mv2(self, v, w):
        return ell_spmv.ell_spmv2(self.val_t.T, self.idx_t.T, v, w, self.perm)

    def diagonal(self):
        rows = torch.arange(self.n, device=self.device)[:, None]
        hit = self.idx_t.T == rows
        d = torch.where(hit, self.val_t.T, 0.0).sum(1)
        if self.perm is None:
            return d
        out = torch.empty_like(d)
        out[self.perm.long()] = d
        return out

    def astype(self, dtype):
        return EllOperator._stored(self.val_t.to(dtype), self.idx_t,
                                   self.nnz_stored, self.perm)

    def to(self, device):
        return EllOperator._stored(
            self.val_t.to(device), self.idx_t.to(device), self.nnz_stored,
            None if self.perm is None else self.perm.to(device))

    def _host(self):
        val_t, idx_t = self._given()
        return (val_t.T.detach().cpu().to(torch.float64).numpy(),
                idx_t.T.detach().cpu().numpy())

    def todense(self):
        val, idx = self._host()
        n, L = val.shape
        a = np.zeros((n, n))
        for slot in range(L):
            np.add.at(a, (np.arange(n), idx[:, slot]), val[:, slot])
        return a

    def tocsr(self):
        import scipy.sparse as sp

        val, idx = self._host()
        n, L = val.shape
        # padding slots hold 0 at (i, i): summed duplicates change nothing
        # and no stored entry is dropped, so the structure stays exact
        return sp.csr_matrix(
            (val.ravel(), (np.repeat(np.arange(n), L), idx.ravel())),
            shape=(n, n))


def build_dense(coo) -> np.ndarray:
    """Host float64 dense array from COO (duplicates summed)."""
    n = coo.shape[0]
    a = np.zeros((n, n), dtype=np.float64)
    np.add.at(a, (np.asarray(coo.row), np.asarray(coo.col)),
              np.asarray(coo.val, dtype=np.float64))
    return a


def _diagonal_index(offs, offsets):
    """Position of each entry's offset in the sorted tuple ``offsets``."""
    return np.searchsorted(np.asarray(offsets, dtype=np.int64), offs)


def build_dia(coo) -> tuple:
    """Host float64 DIA layout ``(offsets, data)`` from COO: every occupied
    diagonal in increasing order, duplicates summed."""
    n = coo.shape[0]
    row = np.asarray(coo.row)
    col = np.asarray(coo.col)
    val = np.asarray(coo.val, dtype=np.float64)
    offs = col - row
    offsets = tuple(int(o) for o in np.unique(offs))
    data = np.zeros((len(offsets), n), dtype=np.float64)
    np.add.at(data, (_diagonal_index(offs, offsets), row), val)
    return offsets, data


def build_sym_dia(coo) -> tuple:
    """Host float64 symmetric half-band layout ``(offsets, data)``: the main
    and upper diagonals (offset 0 first), ``data[d, i] = A[i, i +
    offsets[d]]``, explicit zeros past the matrix edge.

    The lower triangle is DROPPED, which is lossless only for symmetric
    input: :func:`from_coo` checks symmetry before it calls this.
    """
    n = coo.shape[0]
    row = np.asarray(coo.row)
    col = np.asarray(coo.col)
    val = np.asarray(coo.val, dtype=np.float64)
    upper = col >= row
    offs = (col - row)[upper]
    offsets = (0,) + tuple(int(o) for o in np.unique(offs) if o != 0)
    data = np.zeros((len(offsets), n), dtype=np.float64)
    d_idx = np.where(offs == 0, 0, _diagonal_index(offs, offsets[1:]) + 1)
    np.add.at(data, (d_idx, row[upper]), val[upper])
    return offsets, data


def _ell_entries(coo):
    """``(n, L, counts, row, col, val)``: the entries in the stable
    ``np.lexsort((col, row))`` order, as one stable sort of a single int64
    key (linear on entries already in order, as a CSR's are), with the
    entries per row and ``L = max(1, longest row)``."""
    n = coo.shape[0]
    row = np.asarray(coo.row).astype(np.int64, copy=False)
    col = np.asarray(coo.col)
    val = np.asarray(coo.val, dtype=np.float64)
    counts = np.bincount(row, minlength=n)
    L = max(1, int(counts.max()) if counts.size else 0)
    order = np.argsort(row * coo.shape[1] + col, kind="stable")
    return n, L, counts, row[order], col[order], val[order]


def build_ell(coo) -> tuple:
    """Host padded-ELL layout ``(val, idx, nnz)`` from COO.

    ``val`` (float64) and ``idx`` (int32) are ``(n, L)`` views of slot-major
    ``(L, n)`` arrays; ``L = max(1, longest row)``.  Entries take their
    row's slots in ``(row, col)`` order (stable); a duplicate takes a slot
    of its own; padding holds value 0 and index i.  ``nnz`` counts every
    entry given.  The values are those of the JAX package's loop, which adds
    each into a zero slot (so ``-0.0`` is stored as ``0.0`` there too).

    The sorted entries are packed by the native ``pack_ell``
    (:mod:`..matio._native`), which measured faster than the numpy packing
    (:func:`_build_ell_numpy`, the reference the tests hold it to) on
    HPCG's 29.8M entries on the chip machine's host (PERF.md, PR 11).
    """
    from ..matio import _native

    n, L, _, row, col, val = _ell_entries(coo)
    val_n, idx_n = _native.pack_ell(row, col, val, n, L)
    return val_n, idx_n, int(len(val))


def _build_ell_numpy(coo) -> tuple:
    """:func:`build_ell`'s arrays by vectorised numpy (its packing before
    the native one): each sorted entry's slot is its place within its
    row."""
    n, L, counts, r, col, val = _ell_entries(coo)
    start = np.cumsum(counts) - counts  # first sorted position of each row
    slot = np.arange(len(r)) - start[r]
    val_t = np.zeros((L, n), dtype=np.float64)
    idx_t = np.tile(np.arange(n, dtype=np.int32), (L, 1))
    val_t[slot, r] = 0.0 + val
    idx_t[slot, r] = col
    return val_t.T, idx_t.T, int(len(val))


#: Block-banded admission of the auto policy: padded values stored (3 bs
#: n_pad), in float32 values, scaled by the stored type's size.  The JAX
#: package's number (512M float32 values, 2 GB), kept so that both packages
#: pick the same format; it was set for a TPU's memory, not measured here.
_BLOCK_BANDED_MAX_PADDED = 512_000_000

#: Largest half-band the symmetric half-band route takes: the JAX package's
#: TPU kernel limit, kept for the same reason (the CUDA kernels take any).
_SYMDIA_MAX_HALF_BAND = 128


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def _is_symmetric(coo) -> bool:
    """Exact (bitwise) symmetry, O(nnz) on the host: CG takes SPD systems,
    and a symmetric ``.mtx`` file expands both triangles from the same
    values, so no tolerance (none routes near-symmetric input wrongly)."""
    c = coo.tocsr()
    c.sum_duplicates()
    d = c - c.T.tocsr()
    return d.nnz == 0 or float(np.abs(d.data).max()) == 0.0


def _stencil_probe(coo):
    """``(diag, off_value, k)`` when the matrix is a diagonal plus one
    constant, full, hollow band at ``|i - j| < k`` (the PETSc model problem,
    ``ex2a.c:86-90``), else ``None``.  Exact equality per diagonal."""
    n = coo.shape[0]
    row = np.asarray(coo.row)
    col = np.asarray(coo.col)
    val = np.asarray(coo.val, dtype=np.float64)
    offs = col - row
    uoffs = np.unique(offs)
    nonzero_offs = uoffs[uoffs != 0]
    if len(nonzero_offs) == 0:
        return None  # a diagonal alone: DIA is one stream already
    k = int(nonzero_offs.max()) + 1
    want = np.concatenate([np.arange(-(k - 1), 0), np.arange(1, k)])
    if len(nonzero_offs) != len(want) or not np.array_equal(
            np.sort(nonzero_offs), want):
        return None
    off_mask = offs != 0
    off_vals = val[off_mask]
    c = off_vals[0]
    if not (off_vals == c).all() or c == 0.0:
        return None
    # every off-diagonal FULL (a missing entry is an implicit zero)
    counts = np.bincount(np.abs(offs[off_mask]), minlength=k)
    expected = 2 * (n - np.arange(k))
    if not np.array_equal(counts[1:k], expected[1:k]):
        return None
    if 0 not in uoffs:
        return None
    diag = np.zeros(n, dtype=np.float64)
    np.add.at(diag, row[~off_mask], val[~off_mask])
    return diag, float(c), k


def choose_format(coo, dia_max_diags: int = 256,
                  max_padded_values: int = _BLOCK_BANDED_MAX_PADDED,
                  dtype=None) -> str:
    """The auto policy of the JAX package, with its thresholds.

    ``"dense"`` for n <= 512; for at most ``dia_max_diags`` occupied
    diagonals ``"stencil"`` (symmetric, half-band < 128, one constant
    off-band), ``"symdia"`` (symmetric, half-band < 128) or ``"dia"``; else
    the bandwidth after RCM decides: ``"block_banded"`` when its packing
    (``3 bs n_pad`` values of ``dtype``, float32 if ``None``) fits
    ``max_padded_values`` float32 values, else ``"ell"`` with a warning.
    The admission is computed in Python integers.
    """
    n = int(coo.shape[0])
    if n <= 512:
        return "dense"
    diags = np.unique(np.asarray(coo.col) - np.asarray(coo.row))
    if len(diags) <= dia_max_diags:
        half_band = int(np.abs(diags).max()) if len(diags) else 0
        if 0 < half_band < _SYMDIA_MAX_HALF_BAND and _is_symmetric(coo):
            if _stencil_probe(coo) is not None:
                return "stencil"
            return "symdia"
        return "dia"
    from .block_banded import rcm_band_probe

    bw = int(rcm_band_probe(coo))
    bs = max(128, -(-max(bw, 1) // 128) * 128)
    n_pad = -(-n // bs) * bs
    itemsize = _itemsize(dtype) if dtype is not None else 4
    if 3 * bs * n_pad * itemsize <= int(max_padded_values) * 4:
        return "block_banded"
    import warnings

    warnings.warn(
        f"matrix (n={n}, nnz={len(coo.val)}) is not bandwidth-reducible "
        f"(RCM band {bw}); falling back to the gather-ELL formulation. "
        "Expect lower SpMV throughput than the block-banded/DIA paths; "
        "consider a coarser partitioning or fmt='ell' with small row "
        "counts per dispatch.",
        stacklevel=3,
    )
    return "ell"


def from_coo(coo, fmt: str = "auto", dtype=torch.float64,
             dia_max_diags: int = 256, device=None):
    """An operator on ``device`` (default: the CUDA card) in ``dtype``
    (default float64, as the JAX package) from a
    :class:`~..matio.matrix_market.CooMatrix`.

    ``fmt``: ``'dense' | 'dia' | 'symdia' | 'stencil' | 'ell' |
    'block_banded' | 'auto'``; ``'auto'`` follows :func:`choose_format`,
    whose block-banded admission scales by ``dtype``, the type stored.
    ``'symdia'`` raises ``ValueError`` on input that is not exactly
    symmetric (its lower triangle would be dropped), ``'stencil'`` on input
    that is no constant band.  ``'block_banded'`` returns a
    :class:`~.block_banded.PermutedBlockBandedOperator` (original
    coordinates outside, the reordered band inside); ``'ell'`` an
    :class:`EllOperator` that keeps its rows in :func:`ell_order`.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    if fmt == "auto":
        fmt = choose_format(coo, dia_max_diags, dtype=dtype)

    def tensor(a):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    if fmt == "symdia":
        from .sym_dia import SymDiaOperator

        if not _is_symmetric(coo):
            raise ValueError("fmt='symdia' needs an exactly symmetric "
                             "matrix: its lower triangle is not stored")
        offsets, data = build_sym_dia(coo)
        return SymDiaOperator(offsets, tensor(data))
    if fmt == "stencil":
        from .stencil import BandedStencilOperator

        probe = _stencil_probe(coo)
        if probe is None:
            raise ValueError("matrix is not diag + constant hollow band; "
                             "fmt='stencil' does not apply")
        diag, off_value, k = probe
        return BandedStencilOperator(tensor(diag), tensor(off_value), k)
    if fmt == "block_banded":
        from .block_banded import (
            PermutedBlockBandedOperator,
            block_banded_from_coo,
        )

        op, perm = block_banded_from_coo(coo, dtype=dtype, device=dev)
        return PermutedBlockBandedOperator(
            op, torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(dev))
    if fmt == "dense":
        return DenseOperator(tensor(build_dense(coo)))
    if fmt == "dia":
        offsets, data = build_dia(coo)
        return DiaOperator(offsets, tensor(data))
    if fmt == "ell":
        val, idx, nnz = build_ell(coo)
        return EllOperator(tensor(val.T).T,
                           torch.from_numpy(idx.T).to(dev).T, nnz,
                           perm=ell_order(coo))
    raise ValueError(f"unknown format {fmt!r}")


def ell_order(coo):
    """The locality order an ELL operator keeps: the reverse Cuthill-McKee
    order of the format policy's probe (memoised on ``coo``, so the auto
    route computed it already) when it narrows the band, as
    :func:`~.block_banded.block_banded_from_coo` takes it; else ``None``,
    the given order."""
    from .block_banded import _rcm_probe_full

    _, bw_natural, bw_rcm, perm = _rcm_probe_full(coo)
    return perm if bw_rcm < bw_natural else None


def coo_from_scipy(a) -> CooMatrix:
    """A scipy sparse matrix (any format) as a
    :class:`~..matio.matrix_market.CooMatrix` (int64 indices, float64
    values)."""
    c = a.tocoo()
    return CooMatrix(shape=tuple(c.shape),
                     row=np.asarray(c.row, dtype=np.int64),
                     col=np.asarray(c.col, dtype=np.int64),
                     val=np.asarray(c.data, dtype=np.float64))


def as_operator(a, dtype=None, device=None):
    """Coerce an operator, a scipy sparse matrix, a
    :class:`~..matio.matrix_market.CooMatrix`, a numpy array or a tensor
    into an operator on ``device`` (default: the CUDA card).

    Anything exposing the operator protocol (``mv`` / ``diagonal``) passes
    through, moved and cast as asked.  A scipy sparse matrix (the reference
    solvers' own input, ``cg_variants/hs_cg.py:9``) or a ``CooMatrix`` goes
    through :func:`from_coo` with ``fmt="auto"`` in ``dtype`` (default
    float64); an array becomes a :class:`DenseOperator` in ``dtype``
    (default its own).
    """
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    # (a tensor has ``mv`` and ``diagonal`` too, and is an array here)
    if (hasattr(a, "mv") and hasattr(a, "diagonal")
            and not isinstance(a, torch.Tensor)):
        op = a if a.device == dev else a.to(dev)
        return op if dtype is None or dtype == op.dtype else op.astype(dtype)
    if hasattr(a, "tocoo") and not isinstance(a, np.ndarray):
        a = coo_from_scipy(a)
    if isinstance(a, CooMatrix):
        return from_coo(a, dtype=dtype or torch.float64, device=dev)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return DenseOperator(t.to(device=dev, dtype=dtype))
