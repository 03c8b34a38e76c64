"""Fused CG phases on full-DIA storage for the families beside pipe-P/PR:
the port of the JAX package's ``ops/fused_family.py`` (same entry points,
argument and return orders).

* :func:`fused_hs_matvec_phase` — ``p2 = r + beta p; s2 = A p2``; ``p2.s2``
* :func:`fused_pr_full_step` — the whole PR / Meurant iteration
* :func:`fused_cgcg_matvec_phase` — x, r updates, ``w2 = A r2``
* :func:`fused_gv_matvec_phase` — x, r, w updates, ``t = A w2``
* :func:`fused_pr_full_step_prec`, :func:`fused_cgcg_matvec_phase_prec`,
  :func:`fused_gv_matvec_phase_prec` — their Jacobi twins, the PCApply
  ``d * v`` in the same pass.

Each is an entry of the full-DIA family kernel (``csrc/dia_family.cu``, whose
update programs ``csrc/family_specs.cuh`` shares with the half-band kernel):
the kernel on CUDA tensors, for bands that
:func:`~.fused_step.supports_full_step` admits; on CPU tensors the plain
PyTorch version (the program of :mod:`.sym_fused`'s plain version over the
full-DIA product), which is also what the kernel is checked against on the
card.  Outputs never alias inputs.  Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import functools

from . import sym_fused
from .fused_step import dia_family_entry, supports_full_step
from .spmv_dia import _dia_mv_plain

__all__ = [
    "fused_hs_matvec_phase",
    "fused_pr_full_step",
    "fused_cgcg_matvec_phase",
    "fused_gv_matvec_phase",
    "fused_pr_full_step_prec",
    "fused_cgcg_matvec_phase_prec",
    "fused_gv_matvec_phase_prec",
    "supports_full_step",
]


def _over_dia(plain):
    return functools.partial(plain, mv=_dia_mv_plain)


_hs_phase_plain = _over_dia(sym_fused._hs_phase_plain)
_pr_step_plain = _over_dia(sym_fused._pr_step_plain)
_cgcg_phase_plain = _over_dia(sym_fused._cgcg_phase_plain)
_gv_phase_plain = _over_dia(sym_fused._gv_phase_plain)
_pr_step_prec_plain = _over_dia(sym_fused._pr_step_prec_plain)
_cgcg_phase_prec_plain = _over_dia(sym_fused._cgcg_phase_prec_plain)
_gv_phase_prec_plain = _over_dia(sym_fused._gv_phase_prec_plain)


def fused_hs_matvec_phase(offsets, data, r, p, beta):
    """Hestenes-Stiefel second phase: ``p2 = r + beta p; s2 = A p2``.

    ``r`` is the (preconditioned) residual: the phase never touches M.
    Returns ``(p2, s2, (p2.s2,))``.
    """
    return dia_family_entry(
        fused_hs_matvec_phase, "fused_hs_matvec_phase", _hs_phase_plain,
        offsets, data, (r, p), (beta,))


def fused_pr_full_step(offsets, data, x, r, p, s, a1, beta):
    """One whole unpreconditioned PR / Meurant iteration.

    Returns ``(x2, r2, p2, s2, (mu, delta, gamma, nu))``.
    """
    return dia_family_entry(
        fused_pr_full_step, "fused_pr_full_step", _pr_step_plain, offsets,
        data, (x, r, p, s), (a1, beta))


def fused_cgcg_matvec_phase(offsets, data, x, r, p, s, a1):
    """Chronopoulos-Gear phase: x, r updates, ``w2 = A r2``.

    Returns ``(x2, r2, w2, (nu, eta))``.
    """
    return dia_family_entry(
        fused_cgcg_matvec_phase, "fused_cgcg_matvec_phase",
        _cgcg_phase_plain, offsets, data, (x, r, p, s), (a1,))


def fused_gv_matvec_phase(offsets, data, x, r, w, u, p, s, a1):
    """Ghysels-Vanroose phase: x, r, w updates, ``t = A w2``.

    Returns ``(x2, r2, w2, t, (nu, eta))``.
    """
    return dia_family_entry(
        fused_gv_matvec_phase, "fused_gv_matvec_phase", _gv_phase_plain,
        offsets, data, (x, r, w, u, p, s), (a1,))


def fused_pr_full_step_prec(offsets, data, inv_diag, x, r, p, s, rt, st, a1,
                            beta):
    """One whole Jacobi-preconditioned PR / Meurant iteration.

    Returns ``(x2, r2, rt2, p2, s2, st2, (mu, delta, gamma, nu))``.
    """
    return dia_family_entry(
        fused_pr_full_step_prec, "fused_pr_full_step_prec",
        _pr_step_prec_plain, offsets, data, (inv_diag, x, r, p, s, rt, st),
        (a1, beta))


def fused_cgcg_matvec_phase_prec(offsets, data, inv_diag, x, r, p, s, a1):
    """Jacobi-preconditioned Chronopoulos-Gear phase (PCApply in the pass).

    Returns ``(x2, r2, rt2, w2, (nu, eta))``.
    """
    return dia_family_entry(
        fused_cgcg_matvec_phase_prec, "fused_cgcg_matvec_phase_prec",
        _cgcg_phase_prec_plain, offsets, data, (inv_diag, x, r, p, s), (a1,))


def fused_gv_matvec_phase_prec(offsets, data, inv_diag, x, r, w, u, p, s, rt,
                               st, a1):
    """Jacobi-preconditioned Ghysels-Vanroose phase (PCApply in the pass).

    Returns ``(x2, r2, rt2, w2, wt2, t, (nu, eta))``.
    """
    return dia_family_entry(
        fused_gv_matvec_phase_prec, "fused_gv_matvec_phase_prec",
        _gv_phase_prec_plain, offsets, data,
        (inv_diag, x, r, w, u, p, s, rt, st), (a1,))


FUSED_FAMILY_WRAPPERS = (
    fused_hs_matvec_phase, fused_pr_full_step, fused_cgcg_matvec_phase,
    fused_gv_matvec_phase, fused_pr_full_step_prec,
    fused_cgcg_matvec_phase_prec, fused_gv_matvec_phase_prec,
)
for _fn in FUSED_FAMILY_WRAPPERS:
    _fn.launches = 0
