"""Whole-iteration fused pipe-P / pipe-PR step on half-band storage.

One call runs the pipe family's five elementwise updates, the half-band SpMV
of the updated vector(s) and the iteration's four dot products:

    r2 = r - a1 s;  w2 = w - a1 u;  s2 = w2 + beta s;  p2 = r2 + beta p;
    x2 = x + a1 p;  u2 = A s2;  w_out = A r2 (recompute) or w2;
    dots = (p2.s2, r2.s2, s2.s2, r2.r2) = (mu, delta, gamma, nu)

in the update order of the JAX package's ``_pipe_update`` /
``_pipe_update_norec``.  On CUDA tensors it launches the hand-written kernel
of ``csrc/sym_fused.cu`` (one pass over device memory; the band is streamed
once for both SpMVs) and sums its per-block dot partials; on CPU tensors it
runs :func:`_pipe_step_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .sym_dia import (
    KERNEL_TILE,
    _mv_plain,
    _offsets_array,
    check_kernel_args,
)

__all__ = ["fused_sym_pipe_full_step"]


def _pipe_step_plain(offsets, data, x, r, w, u, p, s, a1, beta, recompute):
    """Plain PyTorch version of the fused step (same update order)."""
    r2 = r - a1 * s
    w2 = w - a1 * u
    s2 = w2 + beta * s
    p2 = r2 + beta * p
    x2 = x + a1 * p
    u2 = _mv_plain(offsets, data, s2)
    w_out = _mv_plain(offsets, data, r2) if recompute else w2
    dots = (torch.dot(p2, s2), torch.dot(r2, s2), torch.dot(s2, s2),
            torch.dot(r2, r2))
    return x2, r2, w_out, p2, s2, u2, dots


def _scalar(v, like):
    """A device scalar of ``like``'s dtype for the kernel to read."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(()).contiguous()


def _launch(offsets, data, vecs, a1, beta, recompute):
    from ._kernels import library

    n, h, sfx = check_kernel_args(offsets, data, vecs, 2)
    a1 = _scalar(a1, data)
    beta = _scalar(beta, data)
    outs = [torch.empty_like(v) for v in vecs]
    nblocks = -(-n // KERNEL_TILE)
    partials = torch.empty((nblocks, 4), dtype=data.dtype, device=data.device)
    ins = (ctypes.c_void_p * 6)(*[v.data_ptr() for v in vecs])
    outp = (ctypes.c_void_p * 6)(*[o.data_ptr() for o in outs])
    fn = getattr(library("sym_fused.cu"), f"sym_pipe_step_{sfx}")
    rc = fn(data.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), h,
            n, ins, a1.data_ptr(), beta.data_ptr(), outp, partials.data_ptr(),
            int(bool(recompute)), data.device.index,
            torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_sym_pipe_full_step kernel launch failed: CUDA error {rc}")
    x2, r2, w_out, p2, s2, u2 = outs
    dots = tuple(partials.sum(dim=0).unbind(0))
    return x2, r2, w_out, p2, s2, u2, dots


def fused_sym_pipe_full_step(offsets, data, x, r, w, u, p, s, a1, beta, *,
                             recompute=True):
    """One fused unpreconditioned pipe-P/PR iteration body, half-band A.

    Returns ``(x2, r2, w_out, p2, s2, u2, (mu, delta, gamma, nu))`` with the
    dots as 0-d tensors on the vectors' device.  Outputs never alias inputs.
    """
    vecs = (x, r, w, u, p, s)
    if all(v.is_cuda for v in vecs):
        out = _launch(offsets, data, vecs, a1, beta, recompute)
        fused_sym_pipe_full_step.launches += 1
        return out
    if all(v.device.type == "cpu" for v in vecs) and data.device.type == "cpu":
        return _pipe_step_plain(offsets, data, x, r, w, u, p, s, a1, beta,
                                recompute)
    raise ValueError(
        f"vectors on {[str(v.device) for v in vecs]} with data on {data.device}")


fused_sym_pipe_full_step.launches = 0
