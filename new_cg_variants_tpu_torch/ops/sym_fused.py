"""Fused CG phases on half-band storage: one kernel pass per iteration.

Each entry point runs a family's elementwise updates, the half-band SpMV of
the updated vector(s), for the Jacobi twins the PCApply ``d * (A v)`` and the
phase's dot products.  They are the entry points of the JAX package's
``ops/sym_fused.py``, with the same argument and return orders (the families
unpack them positionally) and the update order of its specs:

* :func:`fused_sym_pipe_full_step` — the whole unpreconditioned pipe-P/PR
  iteration:

      r2 = r - a1 s;  w2 = w - a1 u;  s2 = w2 + beta s;  p2 = r2 + beta p;
      x2 = x + a1 p;  u2 = A s2;  w_out = A r2 (recompute) or w2;
      dots = (p2.s2, r2.s2, s2.s2, r2.r2) = (mu, delta, gamma, nu)

* :func:`fused_sym_hs_matvec_phase`, :func:`fused_sym_pr_full_step`,
  :func:`fused_sym_cgcg_matvec_phase`, :func:`fused_sym_gv_matvec_phase`,
  their ``*_prec`` twins and :func:`fused_sym_pipe_full_step_prec`.

All are entries of one kernel template over a family spec
(``csrc/sym_family.cu``), with the band stored in float32, float64 or bf16
(then with float32 vectors and scalars, as :mod:`.sym_dia`).

On CUDA tensors an entry point launches its hand-written kernel (one pass
over device memory; scalars are read through device pointers, so no step
waits for the host) and sums the kernel's per-block dot partials.  On CPU
tensors it runs the plain PyTorch version beside it (``_*_plain``), which is
also what the kernel is checked against on the card.  Outputs never alias
inputs.  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ._kernels import KERNEL_TILE, SYM_FAMILY_TILE, offsets_array
from .sym_dia import _mv_plain, check_kernel_args

__all__ = [
    "fused_sym_pipe_full_step",
    "fused_sym_hs_matvec_phase",
    "fused_sym_pr_full_step",
    "fused_sym_cgcg_matvec_phase",
    "fused_sym_gv_matvec_phase",
    "fused_sym_pr_full_step_prec",
    "fused_sym_cgcg_matvec_phase_prec",
    "fused_sym_gv_matvec_phase_prec",
    "fused_sym_pipe_full_step_prec",
]


# The plain PyTorch version of each entry, in the entry's update order.  ``mv``
# is the plain product of the band's storage: the half-band one here, the
# full-DIA one for the same entries on full-DIA storage (ops/fused_step.py,
# ops/fused_family.py).


def _pipe_step_plain(offsets, data, x, r, w, u, p, s, a1, beta, recompute,
                     mv=_mv_plain):
    r2 = r - a1 * s
    w2 = w - a1 * u
    s2 = w2 + beta * s
    p2 = r2 + beta * p
    x2 = x + a1 * p
    u2 = mv(offsets, data, s2)
    w_out = mv(offsets, data, r2) if recompute else w2
    dots = (torch.dot(p2, s2), torch.dot(r2, s2), torch.dot(s2, s2),
            torch.dot(r2, r2))
    return x2, r2, w_out, p2, s2, u2, dots


def _scalar(v, like):
    """A device scalar of ``like``'s dtype for the kernel to read."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(()).contiguous()


def _hs_phase_plain(offsets, data, r, p, beta, mv=_mv_plain):
    p2 = r + beta * p
    s2 = mv(offsets, data, p2)
    return p2, s2, (torch.dot(p2, s2),)


def _pr_step_plain(offsets, data, x, r, p, s, a1, beta, mv=_mv_plain):
    x2 = x + a1 * p
    r2 = r - a1 * s
    p2 = r2 + beta * p
    s2 = mv(offsets, data, p2)
    dots = (torch.dot(p2, s2), torch.dot(r2, s2), torch.dot(s2, s2),
            torch.dot(r2, r2))
    return x2, r2, p2, s2, dots


def _cgcg_phase_plain(offsets, data, x, r, p, s, a1, mv=_mv_plain):
    x2 = x + a1 * p
    r2 = r - a1 * s
    w2 = mv(offsets, data, r2)
    return x2, r2, w2, (torch.dot(r2, r2), torch.dot(w2, r2))


def _gv_phase_plain(offsets, data, x, r, w, u, p, s, a1, mv=_mv_plain):
    x2 = x + a1 * p
    r2 = r - a1 * s
    w2 = w - a1 * u
    t = mv(offsets, data, w2)
    return x2, r2, w2, t, (torch.dot(r2, r2), torch.dot(w2, r2))


def _pr_step_prec_plain(offsets, data, d, x, r, p, s, rt, st, a1, beta,
                        mv=_mv_plain):
    x2 = x + a1 * p
    r2 = r - a1 * s
    rt2 = rt - a1 * st
    p2 = rt2 + beta * p
    s2 = mv(offsets, data, p2)
    st2 = d * s2
    dots = (torch.dot(p2, s2), torch.dot(r2, st2), torch.dot(st2, s2),
            torch.dot(rt2, r2))
    return x2, r2, rt2, p2, s2, st2, dots


def _cgcg_phase_prec_plain(offsets, data, d, x, r, p, s, a1, mv=_mv_plain):
    x2 = x + a1 * p
    r2 = r - a1 * s
    rt2 = d * r2
    w2 = mv(offsets, data, rt2)
    return x2, r2, rt2, w2, (torch.dot(r2, rt2), torch.dot(w2, rt2))


def _gv_phase_prec_plain(offsets, data, d, x, r, w, u, p, s, rt, st, a1,
                         mv=_mv_plain):
    x2 = x + a1 * p
    r2 = r - a1 * s
    rt2 = rt - a1 * st
    w2 = w - a1 * u
    wt2 = d * w2
    t = mv(offsets, data, wt2)
    return x2, r2, rt2, w2, wt2, t, (torch.dot(r2, rt2), torch.dot(w2, rt2))


def _pipe_step_prec_plain(offsets, data, d, x, r, w, u, p, s, rt, st, wt, ut,
                          a1, beta, recompute, mv=_mv_plain):
    r2 = r - a1 * s
    w2 = w - a1 * u
    rt2 = rt - a1 * st
    wt2 = wt - a1 * ut
    p2 = rt2 + beta * p
    s2 = w2 + beta * s
    st2 = wt2 + beta * st
    x2 = x + a1 * p
    u2 = mv(offsets, data, st2)
    ut2 = d * u2
    if recompute:
        w_out = mv(offsets, data, rt2)
        wt_out = d * w_out
    else:
        w_out, wt_out = w2, wt2
    dots = (torch.dot(p2, s2), torch.dot(r2, st2), torch.dot(st2, s2),
            torch.dot(rt2, r2))
    return x2, r2, w_out, p2, s2, u2, rt2, st2, wt_out, ut2, dots


#: kernel entry -> (index in csrc/sym_family.cu:launch_sym_family, vector
#: outputs, dot products, SpMV inputs staged in shared memory); the kernel
#: leaves one partial of the dots per KERNEL_TILE rows, two per block of
#: SYM_FAMILY_TILE
_FAMILY_ENTRIES = {
    "fused_sym_hs_matvec_phase": (0, 2, 1, 1),
    "fused_sym_pr_full_step": (1, 4, 4, 1),
    "fused_sym_cgcg_matvec_phase": (2, 3, 2, 1),
    "fused_sym_gv_matvec_phase": (3, 4, 2, 1),
    "fused_sym_pr_full_step_prec": (4, 6, 4, 1),
    "fused_sym_cgcg_matvec_phase_prec": (5, 4, 2, 1),
    "fused_sym_gv_matvec_phase_prec": (6, 6, 2, 1),
    "fused_sym_pipe_full_step_prec": (7, 10, 4, 2),
    "fused_sym_pipe_full_step_prec/no recompute": (8, 10, 4, 1),
    "fused_sym_pipe_full_step": (9, 6, 4, 2),
    "fused_sym_pipe_full_step/no recompute": (10, 6, 4, 1),
}


def _entry(name, recompute):
    return name if recompute else name + "/no recompute"


def partials_shape(n, ndots):
    """The family kernel's dot partials: one row of ``ndots`` per
    KERNEL_TILE rows of the operator (two per block of SYM_FAMILY_TILE)."""
    return -(-n // KERNEL_TILE), ndots


def _launch_family(entry, offsets, data, vecs, scalars):
    """Launch one family entry; returns ``(vector outputs, dots)``."""
    from ._kernels import library

    index, nout, ndots, nmv = _FAMILY_ENTRIES[entry]
    n, h, sfx = check_kernel_args(offsets, data, vecs, nmv, entry=entry,
                                  tile=SYM_FAMILY_TILE)
    # vectors, scalars and partials in the vectors' dtype (float32 on bf16
    # data)
    scalars = [_scalar(v, vecs[0]) for v in scalars]
    outs = [torch.empty_like(vecs[0]) for _ in range(nout)]
    partials = torch.empty(partials_shape(n, ndots), dtype=vecs[0].dtype,
                           device=data.device)
    ins = (ctypes.c_void_p * len(vecs))(*[v.data_ptr() for v in vecs])
    scp = (ctypes.c_void_p * len(scalars))(*[v.data_ptr() for v in scalars])
    outp = (ctypes.c_void_p * nout)(*[o.data_ptr() for o in outs])
    fn = getattr(library("sym_family.cu"), f"sym_family_{sfx}")
    rc = fn(index, data.data_ptr(), offsets_array(tuple(offsets)),
            len(offsets), h, n, ins, len(vecs), scp, len(scalars), outp, nout,
            partials.data_ptr(), data.device.index,
            torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return outs, tuple(partials.sum(dim=0).unbind(0))


def _kernel_or_plain(wrapper, entry, plain, offsets, data, vecs, scalars,
                     *plain_args):
    """The kernel for CUDA tensors (counted), the plain version for CPU
    tensors, an error for anything mixed."""
    if all(v.is_cuda for v in vecs):
        outs, dots = _launch_family(entry, offsets, data, vecs, scalars)
        wrapper.launches += 1
        return (*outs, dots)
    if all(v.device.type == "cpu" for v in vecs) and data.device.type == "cpu":
        return plain(offsets, data, *vecs, *scalars, *plain_args)
    raise ValueError(
        f"vectors on {[str(v.device) for v in vecs]} with data on {data.device}")


def fused_sym_pipe_full_step(offsets, data, x, r, w, u, p, s, a1, beta, *,
                             recompute=True):
    """One whole unpreconditioned pipe-P/PR iteration.

    Returns ``(x2, r2, w_out, p2, s2, u2, (mu, delta, gamma, nu))`` with the
    dots as 0-d tensors on the vectors' device.
    """
    return _kernel_or_plain(
        fused_sym_pipe_full_step,
        _entry("fused_sym_pipe_full_step", recompute), _pipe_step_plain,
        offsets, data, (x, r, w, u, p, s), (a1, beta), bool(recompute))


def fused_sym_hs_matvec_phase(offsets, data, r, p, beta):
    """Hestenes-Stiefel second phase: ``p2 = r + beta p; s2 = A p2``.

    ``r`` is the (preconditioned) residual: the phase never touches M.
    Returns ``(p2, s2, (p2.s2,))``.
    """
    return _kernel_or_plain(
        fused_sym_hs_matvec_phase, "fused_sym_hs_matvec_phase",
        _hs_phase_plain, offsets, data, (r, p), (beta,))


def fused_sym_pr_full_step(offsets, data, x, r, p, s, a1, beta):
    """One whole unpreconditioned PR / Meurant iteration.

    Returns ``(x2, r2, p2, s2, (mu, delta, gamma, nu))``.
    """
    return _kernel_or_plain(
        fused_sym_pr_full_step, "fused_sym_pr_full_step", _pr_step_plain,
        offsets, data, (x, r, p, s), (a1, beta))


def fused_sym_cgcg_matvec_phase(offsets, data, x, r, p, s, a1):
    """Chronopoulos-Gear phase: x, r updates, ``w2 = A r2``.

    Returns ``(x2, r2, w2, (nu, eta))``.
    """
    return _kernel_or_plain(
        fused_sym_cgcg_matvec_phase, "fused_sym_cgcg_matvec_phase",
        _cgcg_phase_plain, offsets, data, (x, r, p, s), (a1,))


def fused_sym_gv_matvec_phase(offsets, data, x, r, w, u, p, s, a1):
    """Ghysels-Vanroose phase: x, r, w updates, ``t = A w2``.

    Returns ``(x2, r2, w2, t, (nu, eta))``.
    """
    return _kernel_or_plain(
        fused_sym_gv_matvec_phase, "fused_sym_gv_matvec_phase",
        _gv_phase_plain, offsets, data, (x, r, w, u, p, s), (a1,))


def fused_sym_pr_full_step_prec(offsets, data, inv_diag, x, r, p, s, rt, st,
                                a1, beta):
    """One whole Jacobi-preconditioned PR / Meurant iteration.

    Returns ``(x2, r2, rt2, p2, s2, st2, (mu, delta, gamma, nu))``.
    """
    return _kernel_or_plain(
        fused_sym_pr_full_step_prec, "fused_sym_pr_full_step_prec",
        _pr_step_prec_plain, offsets, data, (inv_diag, x, r, p, s, rt, st),
        (a1, beta))


def fused_sym_cgcg_matvec_phase_prec(offsets, data, inv_diag, x, r, p, s, a1):
    """Jacobi-preconditioned Chronopoulos-Gear phase (PCApply in the pass).

    Returns ``(x2, r2, rt2, w2, (nu, eta))``.
    """
    return _kernel_or_plain(
        fused_sym_cgcg_matvec_phase_prec, "fused_sym_cgcg_matvec_phase_prec",
        _cgcg_phase_prec_plain, offsets, data, (inv_diag, x, r, p, s), (a1,))


def fused_sym_gv_matvec_phase_prec(offsets, data, inv_diag, x, r, w, u, p, s,
                                   rt, st, a1):
    """Jacobi-preconditioned Ghysels-Vanroose phase (PCApply in the pass).

    Returns ``(x2, r2, rt2, w2, wt2, t, (nu, eta))``.
    """
    return _kernel_or_plain(
        fused_sym_gv_matvec_phase_prec, "fused_sym_gv_matvec_phase_prec",
        _gv_phase_prec_plain, offsets, data,
        (inv_diag, x, r, w, u, p, s, rt, st), (a1,))


def fused_sym_pipe_full_step_prec(offsets, data, inv_diag, x, r, w, u, p, s,
                                  rt, st, wt, ut, a1, beta, *, recompute=True):
    """One whole Jacobi-preconditioned pipe-P/PR iteration.

    Returns ``(x2, r2, w_out, p2, s2, u2, rt2, st2, wt_out, ut2, (mu, delta,
    gamma, nu))``; with ``recompute`` ``w_out = A rt2`` and ``wt_out = d
    w_out`` from the same read of the band as ``u2 = A st2``.
    """
    return _kernel_or_plain(
        fused_sym_pipe_full_step_prec,
        _entry("fused_sym_pipe_full_step_prec", recompute),
        _pipe_step_prec_plain, offsets, data,
        (inv_diag, x, r, w, u, p, s, rt, st, wt, ut), (a1, beta),
        bool(recompute))


FAMILY_WRAPPERS = (
    fused_sym_pipe_full_step, fused_sym_hs_matvec_phase, fused_sym_pr_full_step,
    fused_sym_cgcg_matvec_phase, fused_sym_gv_matvec_phase,
    fused_sym_pr_full_step_prec, fused_sym_cgcg_matvec_phase_prec,
    fused_sym_gv_matvec_phase_prec, fused_sym_pipe_full_step_prec,
)
for _fn in FAMILY_WRAPPERS:
    _fn.launches = 0
