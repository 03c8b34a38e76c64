"""Symmetric DIA storage: main + upper diagonals, half the matrix traffic.

With ``data[d, i] = A[i, i + offsets[d]]`` for ``offsets[d] >= 0`` (explicit
zeros past the matrix edge),

    y[i] = sum_d data[d, i] * v[i + off_d]                    (upper + main)
         + sum_{d: off_d > 0} data[d, i - off_d] * v[i - off_d]   (mirror)

On a CUDA tensor :func:`sym_dia_spmv` / :func:`sym_dia_spmv2` launch the
hand-written kernel of ``csrc/sym_dia.cu``; on a CPU tensor they run the
plain two-shift formulation :func:`_mv_plain`, which is also what the kernel
is checked against on the card.  The band may be stored in float32,
float64 or bf16; bf16 data goes with float32 vectors (a storage-only tier:
the kernel widens each band value to float32, the plain version's products
promote to float32) and gives float32 results.
"""

from __future__ import annotations

import numpy as np
import torch

from ._kernels import (
    KERNEL_TILE,
    MAX_DIAGS,
    RING_STAGES,
    RING_VALUES,
    check_band,
    check_vectors,
    compute_dtype,
    offsets_array,
)
from ._shift import shift

__all__ = ["SymDiaOperator", "sym_dia_spmv", "sym_dia_spmv2"]

#: shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448


def _mv_plain(offsets, data, v):
    """Plain PyTorch half-band SpMV (two shift directions per diagonal)."""
    y = data[0] * v
    for d in range(1, len(offsets)):
        off = offsets[d]
        y = y + data[d] * shift(v, off)
        # mirror: data[d, i-off] * v[i-off] == shift(data[d]*v, -off)
        y = y + shift(data[d] * v, -off)
    return y


def ring_bytes(h, tile=KERNEL_TILE):
    """Shared memory of the ring through which a block of ``tile`` rows
    stages a bf16 band (csrc/sym_common.cuh:ring_bytes): RING_STAGES stages
    of RING_VALUES // tile diagonals' segments, each ``tile`` rows and a
    lead of ``h`` rounded up to 16 bytes, 2 bytes a value.  Independent of
    the number of diagonals."""
    lead = -(-h // 8) * 8
    return RING_STAGES * (RING_VALUES // tile) * (tile + lead) * 2


def kernel_smem_bytes(h, nvec_buffers, itemsize, tile=KERNEL_TILE,
                      ring=False):
    """Shared memory of one block of ``tile`` rows: ``nvec_buffers`` vector
    windows of ``tile + 2 h`` values of ``itemsize`` bytes (the vectors'
    element size, not the band's), the fused step's reduction scratch (32
    values per 256 rows; an upper bound for the SpMV, which has none) and
    the staged offsets.  A band in float32 or float64 is read from device
    memory and takes none; ``ring``: the band is stored in bf16 and staged
    through the ring (:func:`ring_bytes`, on a 16-byte boundary behind the
    windows)."""
    windows = ((nvec_buffers * (tile + 2 * h) + 32 * (tile // KERNEL_TILE))
               * itemsize)
    if ring:
        windows = -(-windows // 16) * 16 + ring_bytes(h, tile)
    return windows + 4 * MAX_DIAGS


def check_kernel_args(offsets, data, vecs, nvec_buffers,
                      entry="sym_dia_spmv", tile=KERNEL_TILE):
    """Validate what a half-band CUDA kernel takes; return ``(n, h, suffix)``.

    ``nvec_buffers`` is the number of vector windows the kernel stages in
    shared memory (one per right-hand side, or the one or two SpMV inputs of
    a fused entry) for a block of ``tile`` rows; a bf16 band adds its ring.
    Raises on a wrong device, dtype, shape or contiguity, and on a half-band
    whose windows (and ring) do not fit in one block's shared memory; that
    error names ``entry``, the entry point.
    """
    n, sfx = check_band(offsets, data)
    if offsets[0] != 0 or min(offsets) < 0:
        raise ValueError(f"bad stored offsets {offsets} for half-band storage")
    check_vectors(data, vecs, n)
    h = max(offsets)
    ring = data.dtype == torch.bfloat16
    smem = kernel_smem_bytes(h, nvec_buffers,
                             compute_dtype(data.dtype).itemsize, tile, ring)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{entry}: half-band {h} with {nvec_buffers} vector windows"
            f"{' and a bf16 band ring' if ring else ''} needs {smem} bytes "
            f"of shared memory per block (> {MAX_SMEM_BYTES}): unsupported")
    return n, h, sfx


def _launch(offsets, data, vecs):
    from ._kernels import library

    n, h, sfx = check_kernel_args(offsets, data, vecs, len(vecs))
    ys = [torch.empty_like(v) for v in vecs]
    fn = getattr(library("sym_dia.cu"), f"sym_dia_spmv_{sfx}")
    v1 = vecs[1].data_ptr() if len(vecs) == 2 else None
    y1 = ys[1].data_ptr() if len(vecs) == 2 else None
    rc = fn(data.data_ptr(), offsets_array(tuple(offsets)), len(offsets), h,
            n, vecs[0].data_ptr(), v1, ys[0].data_ptr(), y1, len(vecs),
            data.device.index, torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sym_dia_spmv kernel launch failed: CUDA error {rc}")
    return ys


def _plain_or_launch(offsets, data, vecs, counter):
    if all(v.is_cuda for v in vecs):
        ys = _launch(offsets, data, vecs)
        counter.launches += 1
        return ys
    if all(v.device.type == "cpu" for v in vecs) and data.device.type == "cpu":
        return [_mv_plain(offsets, data, v) for v in vecs]
    raise ValueError(
        f"vectors on {[str(v.device) for v in vecs]} with data on {data.device}")


def sym_dia_spmv(offsets, data, v):
    """``y = A @ v`` for symmetric A stored as main+upper diagonals."""
    (y,) = _plain_or_launch(offsets, data, (v,), sym_dia_spmv)
    return y


def sym_dia_spmv2(offsets, data, v, w):
    """``(A @ v, A @ w)`` from one read of the half-band."""
    y, z = _plain_or_launch(offsets, data, (v, w), sym_dia_spmv2)
    return y, z


sym_dia_spmv.launches = 0
sym_dia_spmv2.launches = 0


class SymDiaOperator:
    """Symmetric banded operator: main + upper diagonals only.

    ``offsets`` are the stored non-negative offsets (0 first);
    ``data[d, i] = A[i, i + offsets[d]]`` with explicit zeros where
    ``i + offsets[d] >= n``.  ``data`` is a torch tensor; ``mv``/``mv2`` run
    on its device.
    """

    def __init__(self, offsets, data: torch.Tensor):
        offsets = tuple(int(o) for o in offsets)
        if offsets[0] != 0 or any(o < 0 for o in offsets):
            raise ValueError(f"stored offsets must start at 0 and be >= 0: "
                             f"{offsets}")
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
        return int(sum((n - o) * (1 if o == 0 else 2) for o in self.offsets))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def mv(self, v):
        return sym_dia_spmv(self.offsets, self.data, v)

    def mv2(self, v, w):
        return sym_dia_spmv2(self.offsets, self.data, v, w)

    def diagonal(self):
        return self.data[0]

    def astype(self, dtype):
        return SymDiaOperator(self.offsets, self.data.to(dtype))

    def to(self, device):
        return SymDiaOperator(self.offsets, self.data.to(device).contiguous())

    def todia_host(self):
        """Full (two-triangle) band as host ``(offsets, np.float64 data)``."""
        n = self.n
        data = self.data.detach().cpu().to(torch.float64).numpy()
        offs = list(self.offsets)
        full_offs = sorted(set([-o for o in offs if o] + offs))
        full = np.zeros((len(full_offs), n), np.float64)
        for j, off in enumerate(full_offs):
            if off >= 0:
                full[j] = data[offs.index(off)]
            else:
                d = offs.index(-off)
                # A[i, i+off] = A[i+off, i] = data[d, i+off] (row-indexed)
                full[j, -off:] = data[d, : n + off]
        return tuple(full_offs), full

    def tocsr(self):
        import scipy.sparse as sp

        n = self.n
        full_offs, full = self.todia_host()
        rows, cols, vals = [], [], []
        for j, off in enumerate(full_offs):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(full[j, i])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n))

    def todense(self):
        return self.tocsr().toarray()
