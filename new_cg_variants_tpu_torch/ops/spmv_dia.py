"""Full-DIA (banded / diagonal storage) SpMV, 1 or 2 right-hand sides.

The port of the JAX package's ``ops/spmv_pallas.py`` (same entry points, same
layout contract): with ``data[d, i] = A[i, i + offsets[d]]`` for any static
offsets, negative ones too, and explicit zeros outside the matrix,

    y[i] = sum_d data[d, i] * v[i + offsets[d]]        (v zero outside [0, n))

* :func:`dia_spmv` / :func:`dia_spmv2` — ``A @ v`` and ``(A @ v, A @ w)`` from
  one read of ``data``.
* :func:`dia_spmv_ext` / :func:`dia_spmv2_ext` — the local product of a row
  shard whose vector arrives as ``[left h | v | right h]`` with ``h =
  max|offset|``: the halo slots take the place of the zeros.

On a CUDA tensor each launches the hand-written kernel of
``csrc/dia_spmv.cu``; on a CPU tensor it runs the plain shift formulation
(:func:`_dia_mv_plain`, :func:`_dia_mv_ext_plain`), which is also what the
kernel is checked against on the card.  bf16 data goes with float32 vectors
and results (a storage-only tier, as in :mod:`.sym_dia`).  Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from ._kernels import (
    check_band,
    check_vectors,
    compute_dtype,
    offsets_array,
)
from ._shift import shift

__all__ = ["dia_spmv", "dia_spmv2", "dia_spmv_ext", "dia_spmv2_ext",
           "stages_window"]

#: Largest combined halo ``max(-off) + max(off)`` whose vector window
#: ``v[i0 - h_lo : i0 + 256 + h_hi)`` a block stages in shared memory
#: (csrc/dia_spmv.cu:kMaxWindow).  A wider band reads ``v`` through the
#: read-only cache: its window would be many times the values read from it.
MAX_STAGED_HALO = 1024


def halo(offsets):
    """``(h_lo, h_hi)``: how far a row's products reach before and after it."""
    return max(0, -min(offsets)), max(0, max(offsets))


def stages_window(offsets) -> bool:
    """Whether the kernel stages the vector window in shared memory."""
    return sum(halo(offsets)) <= MAX_STAGED_HALO


def _dia_mv_plain(offsets, data, v):
    """Plain PyTorch DIA SpMV: one shifted multiply per diagonal."""
    y = data[0] * shift(v, offsets[0])
    for d in range(1, len(offsets)):
        y = y + data[d] * shift(v, offsets[d])
    return y


def _dia_mv_ext_plain(offsets, data, vext):
    """Plain PyTorch DIA SpMV on a halo-extended vector ``[h | m | h]``."""
    m = data.shape[1]
    h = max(abs(o) for o in offsets)
    y = data[0] * vext[h + offsets[0]: h + offsets[0] + m]
    for d in range(1, len(offsets)):
        s = h + offsets[d]
        y = y + data[d] * vext[s: s + m]
    return y


def _launch(offsets, data, vecs, ext, staged=None):
    """Launch the kernel; ``staged`` overrides the rule of
    :func:`stages_window` (a timing study's switch: both forms give the same
    bits)."""
    from ._kernels import library

    offsets = tuple(offsets)
    n, sfx = check_band(offsets, data)
    h = max(abs(o) for o in offsets) if ext else 0
    check_vectors(data, vecs, n + 2 * h)
    ys = [torch.empty(n, dtype=compute_dtype(data.dtype), device=data.device)
          for _ in vecs]
    fn = getattr(library("dia_spmv.cu"), f"dia_spmv_{sfx}")
    v1 = vecs[1].data_ptr() if len(vecs) == 2 else None
    y1 = ys[1].data_ptr() if len(vecs) == 2 else None
    rc = fn(data.data_ptr(), offsets_array(offsets), len(offsets), n,
            vecs[0].data_ptr(), v1, h, n + 2 * h, ys[0].data_ptr(), y1,
            len(vecs),
            int(stages_window(offsets) if staged is None else staged),
            data.device.index,
            torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {rc}")
    return ys


def _plain_or_launch(wrapper, offsets, data, vecs, ext=False):
    if all(v.is_cuda for v in vecs):
        ys = _launch(offsets, data, vecs, ext)
        wrapper.launches += 1
        return ys
    if all(v.device.type == "cpu" for v in vecs) and data.device.type == "cpu":
        plain = _dia_mv_ext_plain if ext else _dia_mv_plain
        return [plain(offsets, data, v) for v in vecs]
    raise ValueError(
        f"vectors on {[str(v.device) for v in vecs]} with data on {data.device}")


def dia_spmv(offsets, data, v):
    """``y = A @ v`` for a row-indexed DIA operator, one pass over data."""
    (y,) = _plain_or_launch(dia_spmv, offsets, data, (v,))
    return y


def dia_spmv2(offsets, data, v, w):
    """``(A @ v, A @ w)`` from one read of the diagonals."""
    y, z = _plain_or_launch(dia_spmv2, offsets, data, (v, w))
    return y, z


def dia_spmv_ext(offsets, data, vext):
    """Local-shard SpMV: ``vext`` (length ``m + 2h``) carries the halo rows."""
    (y,) = _plain_or_launch(dia_spmv_ext, offsets, data, (vext,), ext=True)
    return y


def dia_spmv2_ext(offsets, data, vext, wext):
    """2-RHS local-shard SpMV on halo-extended vectors."""
    y, z = _plain_or_launch(dia_spmv2_ext, offsets, data, (vext, wext),
                            ext=True)
    return y, z


DIA_WRAPPERS = (dia_spmv, dia_spmv2, dia_spmv_ext, dia_spmv2_ext)
for _fn in DIA_WRAPPERS:
    _fn.launches = 0
