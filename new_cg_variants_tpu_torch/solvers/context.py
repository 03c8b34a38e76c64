"""Execution context: how a solver step touches the operator.

The algorithm is written once against this small interface (``mv``,
``mv2``, ``prec``, ``dots``, ...); the context decides how each piece runs.
Step functions call ``dots`` once per synchronization phase with all the
inner products of that phase, which keeps each variant's sync structure
explicit (one phase per pipe iteration).
"""

from __future__ import annotations

import torch

from ..ops import sym_fused
from .precond import JacobiPreconditioner

__all__ = ["Context", "generic_pipe_vector_phase", "split_pipe_full_step"]


class Context:
    """Single-device execution context.

    ``compensated=True`` (error-free-transform dots) is not ported yet.

    The fused-phase hooks (``hs_matvec_phase`` ... ``pipe_full_step_prec``)
    each run one family's whole phase through one kernel of
    :mod:`..ops.sym_fused`.  The unpreconditioned hooks always apply.  A
    preconditioned hook returns ``None``, and the family then takes its
    generic body (``mv`` / ``mv2`` / ``prec`` / ``dots``), unless the
    preconditioner is a :class:`~.precond.JacobiPreconditioner` (whose
    ``inv_diag`` the kernel applies) and no extra norm rides the dot batch
    (:attr:`extra_norm`, set by :func:`~.engine.tolerance_loop`).  That
    choice reads the configuration only: it is the same on the CPU and on
    the card.
    """

    def __init__(self, op, precond=None, compensated=False):
        if compensated:
            raise NotImplementedError(
                "compensated dots are not ported yet (ROADMAP.md, 'Modules "
                "to port', item 'Compensated dots and f32x2')")
        self.op = op
        self.precond = precond
        self.compensated = compensated
        #: ``"r"`` or ``"rt"`` when a preconditioned tolerance solve needs
        #: ``r.r`` or ``rt.rt`` in each iteration's dot batch, else ``None``
        self.extra_norm = None

    @property
    def has_prec(self) -> bool:
        return self.precond is not None

    def mv(self, v):
        return self.op.mv(v)

    def mv2(self, v, w):
        return self.op.mv2(v, w)

    def prec(self, v):
        return self.precond.apply(v) if self.precond is not None else v

    def dots(self, *pairs):
        """Batch of inner products: one synchronization phase.

        Returns one 0-d tensor per ``(a, b)`` pair; nothing is read back to
        the host.
        """
        return tuple(torch.dot(a, b) for (a, b) in pairs)

    def norm(self, v):
        (sq,) = self.dots((v, v))
        return torch.sqrt(sq)

    def mv_dots(self, v, pairs):
        """``(A v, dots(pairs))`` as one synchronization phase."""
        d = self.dots(*pairs)
        return self.mv(v), d

    def mv2_dots(self, v, w, pairs):
        """``(A v, A w, dots(pairs))`` as one synchronization phase."""
        d = self.dots(*pairs)
        y, z = self.mv2(v, w)
        return y, z, d

    def pipe_vector_phase(self, x, r, w, u, p, s, a1, beta):
        """Unpreconditioned pipe vector phase + its 4-dot batch."""
        return generic_pipe_vector_phase(self, x, r, w, u, p, s, a1, beta)

    def pipe_full_step(self, s_, a1, beta, recompute):
        """Whole unpreconditioned pipe-P/PR iteration: vector phase, dots
        and SpMV(s).  Returns ``(x2, r2, w_out, p2, s2, u2, (mu, delta,
        gamma, nu))``.
        """
        return sym_fused.fused_sym_pipe_full_step(
            self.op.offsets, self.op.data,
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
            a1, beta, recompute=recompute,
        )

    def pr_full_step(self, s_, a1, beta):
        """Whole unpreconditioned PR/Meurant iteration (beta is predicted,
        so x, r, p updates, ``s = A p`` and the 4 dots are one pass)."""
        return sym_fused.fused_sym_pr_full_step(
            self.op.offsets, self.op.data,
            s_["x"], s_["r"], s_["p"], s_["s"], a1, beta,
        )

    def cgcg_matvec_phase(self, s_, a1):
        """Chronopoulos-Gear phase: x, r updates + ``w = A r`` + nu, eta."""
        return sym_fused.fused_sym_cgcg_matvec_phase(
            self.op.offsets, self.op.data,
            s_["x"], s_["r"], s_["p"], s_["s"], a1,
        )

    def gv_matvec_phase(self, s_, a1):
        """GV phase: x, r, w updates + ``t = A w`` + nu, eta."""
        return sym_fused.fused_sym_gv_matvec_phase(
            self.op.offsets, self.op.data,
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"], a1,
        )

    def hs_matvec_phase(self, rt, p, beta):
        """HS second sync phase: p update + ``s = A p`` + mu.

        Takes the (preconditioned) residual directly, so it serves hs_cg
        (rt = r) and hs_pcg with ANY preconditioner: HS's second phase
        never touches M.
        """
        return sym_fused.fused_sym_hs_matvec_phase(
            self.op.offsets, self.op.data, rt, p, beta)

    def _jacobi_fused(self) -> bool:
        return (isinstance(self.precond, JacobiPreconditioner)
                and self.extra_norm is None)

    def pr_full_step_prec(self, s_, a1, beta):
        """Whole Jacobi-preconditioned PR/M iteration, PCApply included."""
        if not self._jacobi_fused():
            return None
        return sym_fused.fused_sym_pr_full_step_prec(
            self.op.offsets, self.op.data, self.precond.inv_diag,
            s_["x"], s_["r"], s_["p"], s_["s"], s_["rt"], s_["st"], a1, beta,
        )

    def cgcg_matvec_phase_prec(self, s_, a1):
        """Jacobi-preconditioned CG matvec phase (PCApply in the pass)."""
        if not self._jacobi_fused():
            return None
        return sym_fused.fused_sym_cgcg_matvec_phase_prec(
            self.op.offsets, self.op.data, self.precond.inv_diag,
            s_["x"], s_["r"], s_["p"], s_["s"], a1,
        )

    def gv_matvec_phase_prec(self, s_, a1):
        """Jacobi-preconditioned GV matvec phase (PCApply in the pass)."""
        if not self._jacobi_fused():
            return None
        return sym_fused.fused_sym_gv_matvec_phase_prec(
            self.op.offsets, self.op.data, self.precond.inv_diag,
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
            s_["rt"], s_["st"], a1,
        )

    def pipe_full_step_prec(self, s_, a1, beta, recompute):
        """Whole Jacobi-preconditioned pipe-P/PR iteration: vector phase,
        dots, both SpMVs and both PCApplies in one pass."""
        if not self._jacobi_fused():
            return None
        return sym_fused.fused_sym_pipe_full_step_prec(
            self.op.offsets, self.op.data, self.precond.inv_diag,
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
            s_["rt"], s_["st"], s_["wt"], s_["ut"],
            a1, beta, recompute=recompute,
        )


def generic_pipe_vector_phase(ctx, x, r, w, u, p, s, a1, beta):
    """Reference formulation of the pipe vector phase over any context."""
    x2 = x + a1 * p
    r2 = r - a1 * s
    w2 = w - a1 * u
    p2 = r2 + beta * p
    s2 = w2 + beta * s
    dots = ctx.dots((p2, s2), (r2, s2), (s2, s2), (r2, r2))
    return x2, r2, w2, p2, s2, dots


def split_pipe_full_step(ctx, s_, a1, beta, recompute):
    """The pipe iteration as vector phase + ``mv2`` (or ``mv``): the split
    formulation, with the fused step's return order.  No entry point takes
    it; it is the reference the fused step is tested against."""
    x, r, w, p, s, dots = ctx.pipe_vector_phase(
        s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"], a1, beta,
    )
    if recompute:
        u, w = ctx.mv2(s, r)
    else:
        u = ctx.mv(s)
    return x, r, w, p, s, u, dots
