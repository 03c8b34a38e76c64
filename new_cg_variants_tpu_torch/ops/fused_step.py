"""Fused phases of the pipelined predict(-and-recompute) CG iteration on
full-DIA storage: the port of the JAX package's ``ops/fused_step.py``.

* :func:`fused_pipe_vector_phase` — the unpreconditioned vector phase in one
  pass (``csrc/pipe_vector.cu``):

      x2 = x + a1 p;  r2 = r - a1 s;  w2 = w - a1 u;
      p2 = r2 + beta p;  s2 = w2 + beta s;
      dots = (p2.s2, r2.s2, s2.s2, r2.r2) = (mu, delta, gamma, nu)

* :func:`fused_pipe_vector_phase_prec` — its preconditioned twin, which
  carries the tilde vectors (``rt2 = rt - a1 st; wt2 = wt - a1 ut; p2 = rt2 +
  beta p; st2 = wt2 + beta st``; dots ``p2.s2, r2.st2, st2.s2, rt2.r2``).  The
  PCApply stays outside (it applies to the products that follow), so any
  preconditioner qualifies.
* :func:`fused_pipe_full_step` — the whole unpreconditioned iteration on a
  :class:`~.operators.DiaOperator`'s data: the vector phase, then ``u2 = A
  s2`` and ``w_out = A r2`` (``recompute``) or ``w2``, in one pass
  (``csrc/dia_family.cu``), for bands that :func:`supports_full_step` admits.
* :func:`fused_pipe_full_step_prec` — its Jacobi twin: the preconditioned
  vector phase, ``u2 = A st2``, ``ut2 = d u2`` and, with ``recompute``,
  ``w_out = A rt2``, ``wt_out = d w_out``, in one pass (a further entry of
  the same kernel; the other families' entries are in :mod:`.fused_family`).

On CUDA tensors an entry point launches its hand-written kernel (scalars are
read through device pointers, so no step waits for the host) and sums the
kernel's per-block dot partials.  On CPU tensors it runs the plain PyTorch
version beside it (``_*_plain``), which is also what the kernel is checked
against on the card.  Outputs never alias inputs.  Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._kernels import (
    KERNEL_DTYPES,
    KERNEL_TILE,
    check_band,
    check_vectors,
    offsets_array,
)
from .spmv_dia import _dia_mv_plain, halo
from .sym_fused import (
    _FAMILY_ENTRIES,
    _entry,
    _pipe_step_plain,
    _pipe_step_prec_plain,
    _scalar,
)

__all__ = ["fused_pipe_vector_phase", "fused_pipe_vector_phase_prec",
           "fused_pipe_full_step", "fused_pipe_full_step_prec",
           "supports_full_step"]

#: Largest combined halo ``max(-off) + max(off)`` the full-DIA family kernel
#: takes (csrc/dia_family.cu:kMaxHalo).  Each 256-row block recomputes the
#: updates of that many halo rows, so at 512 the vector phase is done three
#: times over; wider bands take the split formulation (vector-phase kernel,
#: then the SpMV kernel), which does it once.
MAX_FULL_STEP_HALO = 512


def supports_full_step(offsets) -> bool:
    """Whether the full-DIA family kernel (:func:`fused_pipe_full_step`, its
    Jacobi twin and the entries of :mod:`.fused_family`) takes a band with
    these offsets (any ``n``): a function of the offsets alone."""
    return sum(halo(offsets)) <= MAX_FULL_STEP_HALO


def _pipe_vector_phase_plain(x, r, w, u, p, s, a1, beta):
    x2 = x + a1 * p
    r2 = r - a1 * s
    w2 = w - a1 * u
    p2 = r2 + beta * p
    s2 = w2 + beta * s
    dots = (torch.dot(p2, s2), torch.dot(r2, s2), torch.dot(s2, s2),
            torch.dot(r2, r2))
    return x2, r2, w2, p2, s2, dots


def _pipe_vector_phase_prec_plain(x, r, w, u, p, s, rt, st, wt, ut, a1, beta):
    x2 = x + a1 * p
    r2 = r - a1 * s
    w2 = w - a1 * u
    rt2 = rt - a1 * st
    wt2 = wt - a1 * ut
    p2 = rt2 + beta * p
    s2 = w2 + beta * s
    st2 = wt2 + beta * st
    dots = (torch.dot(p2, s2), torch.dot(r2, st2), torch.dot(st2, s2),
            torch.dot(rt2, r2))
    return x2, r2, w2, rt2, wt2, p2, s2, st2, dots


_dia_pipe_full_step_plain = functools.partial(_pipe_step_plain,
                                              mv=_dia_mv_plain)
_dia_pipe_full_step_prec_plain = functools.partial(_pipe_step_prec_plain,
                                                   mv=_dia_mv_plain)


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(source, entry, head, sfx, ref, n, vecs, scalars, nout, ndots=4):
    """Launch ``entry`` of ``source``, the C entry point of suffix ``sfx``,
    with the leading arguments ``head``; ``ref`` is the band (or the first
    vector), whose dtype sets the vectors' (float32 on bf16 data).  Returns
    ``(vector outputs, the dots)``."""
    from ._kernels import library

    check_vectors(ref, vecs, n)
    like = vecs[0]
    scalars = [_scalar(v, like) for v in scalars]
    outs = [torch.empty(n, dtype=like.dtype, device=ref.device)
            for _ in range(nout)]
    partials = torch.empty((-(-n // KERNEL_TILE), ndots), dtype=like.dtype,
                           device=ref.device)
    fn = getattr(library(source), f"{source[:-3]}_{sfx}")
    rc = fn(*head, n, _pointers(vecs), len(vecs), _pointers(scalars),
            len(scalars), _pointers(outs), nout, partials.data_ptr(),
            ref.device.index, torch.cuda.current_stream(ref.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return outs, tuple(partials.sum(dim=0).unbind(0))


def _where(tensors):
    """``"cuda"`` / ``"cpu"`` when all tensors lie there, else an error."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"} or kinds == {"cpu"}:
        return kinds.pop()
    raise ValueError(f"tensors on {[str(t.device) for t in tensors]}: the "
                     "fused phases take all-CUDA or all-CPU arguments")


def _vector_phase(wrapper, plain, vecs, a1, beta, nout):
    if _where(vecs) == "cpu":
        return plain(*vecs, a1, beta)
    x = vecs[0]
    if x.ndim != 1 or x.shape[0] == 0:
        raise ValueError(f"expected non-empty vectors, got {tuple(x.shape)}")
    sfx = KERNEL_DTYPES.get(x.dtype)
    if sfx is None:
        raise TypeError(f"{wrapper.__name__} takes float32 or float64, not "
                        f"{x.dtype}")
    outs, dots = _launch("pipe_vector.cu", wrapper.__name__,
                         (int(nout == 8),), sfx, x, x.shape[0], vecs,
                         (a1, beta), nout)
    wrapper.launches += 1
    return (*outs, dots)


def fused_pipe_vector_phase(x, r, w, u, p, s, a1, beta):
    """Unpreconditioned pipe-P/PR vector phase, one pass.

    Returns ``(x2, r2, w2, p2, s2, (mu, delta, gamma, nu))`` with the dots as
    0-d tensors on the vectors' device.
    """
    return _vector_phase(fused_pipe_vector_phase, _pipe_vector_phase_plain,
                         (x, r, w, u, p, s), a1, beta, 5)


def fused_pipe_vector_phase_prec(x, r, w, u, p, s, rt, st, wt, ut, a1, beta):
    """Preconditioned pipe-P/PR vector phase, one pass.

    Returns ``(x2, r2, w2, rt2, wt2, p2, s2, st2, (mu, delta, gamma, nu))``.
    """
    return _vector_phase(
        fused_pipe_vector_phase_prec, _pipe_vector_phase_prec_plain,
        (x, r, w, u, p, s, rt, st, wt, ut), a1, beta, 8)


def dia_family_entry(wrapper, entry, plain, offsets, data, vecs, scalars,
                     *plain_args):
    """One entry of the full-DIA family kernel (``csrc/dia_family.cu``; the
    entry numbers and counts are those of the half-band kernel,
    ``sym_fused._FAMILY_ENTRIES``) on CUDA tensors, counted on ``wrapper``;
    its plain version on CPU tensors."""
    offsets = tuple(offsets)
    if _where(tuple(vecs) + (data,)) == "cpu":
        return plain(offsets, data, *vecs, *scalars, *plain_args)
    if not supports_full_step(offsets):
        raise ValueError(
            f"{entry}: offsets reach {halo(offsets)} rows before and after a "
            f"row, more than {MAX_FULL_STEP_HALO} together")
    n, sfx = check_band(offsets, data)
    index, nout, ndots, _ = _FAMILY_ENTRIES[
        entry.replace("fused_", "fused_sym_", 1)]
    outs, dots = _launch(
        "dia_family.cu", entry,
        (index, data.data_ptr(), offsets_array(offsets), len(offsets)),
        sfx, data, n, vecs, scalars, nout, ndots)
    wrapper.launches += 1
    return (*outs, dots)


def fused_pipe_full_step(offsets, data, x, r, w, u, p, s, a1, beta, *,
                         recompute=True):
    """One whole unpreconditioned pipe-P/PR iteration on full-DIA storage.

    Returns ``(x2, r2, w_out, p2, s2, u2, (mu, delta, gamma, nu))``: the
    semantics of :func:`fused_pipe_vector_phase` followed by ``mv2(s2, r2)``
    (``recompute``) or ``mv(s2)``.
    """
    return dia_family_entry(
        fused_pipe_full_step, _entry("fused_pipe_full_step", recompute),
        _dia_pipe_full_step_plain, offsets, data, (x, r, w, u, p, s),
        (a1, beta), bool(recompute))


def fused_pipe_full_step_prec(offsets, data, inv_diag, x, r, w, u, p, s, rt,
                              st, wt, ut, a1, beta, *, recompute=True):
    """One whole Jacobi-preconditioned pipe-P/PR iteration on full-DIA
    storage.

    Returns ``(x2, r2, w_out, p2, s2, u2, rt2, st2, wt_out, ut2, (mu, delta,
    gamma, nu))``; with ``recompute`` ``w_out = A rt2`` and ``wt_out = d
    w_out`` from the same read of the band as ``u2 = A st2``.
    """
    return dia_family_entry(
        fused_pipe_full_step_prec,
        _entry("fused_pipe_full_step_prec", recompute),
        _dia_pipe_full_step_prec_plain, offsets, data,
        (inv_diag, x, r, w, u, p, s, rt, st, wt, ut), (a1, beta),
        bool(recompute))


FUSED_STEP_WRAPPERS = (fused_pipe_vector_phase, fused_pipe_vector_phase_prec,
                       fused_pipe_full_step, fused_pipe_full_step_prec)
for _fn in FUSED_STEP_WRAPPERS:
    _fn.launches = 0
