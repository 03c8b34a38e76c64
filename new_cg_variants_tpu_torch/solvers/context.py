"""Execution context: how a solver step touches the operator.

The algorithm is written once against this small interface (``mv``,
``mv2``, ``prec``, ``dots``, ...); the context decides how each piece runs.
Step functions call ``dots`` once per synchronization phase with all the
inner products of that phase, which keeps each variant's sync structure
explicit (one phase per pipe iteration).
"""

from __future__ import annotations

import torch

from ..ops.sym_fused import fused_sym_pipe_full_step

__all__ = ["Context", "generic_pipe_vector_phase", "split_pipe_full_step"]


class Context:
    """Single-device execution context.

    ``compensated=True`` (error-free-transform dots) is not ported yet.
    """

    def __init__(self, op, precond=None, compensated=False):
        if compensated:
            raise NotImplementedError(
                "compensated dots are not ported yet (ROADMAP.md, 'Modules "
                "to port', item 'Compensated dots and f32x2')")
        self.op = op
        self.precond = precond
        self.compensated = compensated

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
        """Whole pipe-P/PR iteration: vector phase, dots and SpMV(s).

        Always the fused one-pass kernel
        (:func:`..ops.sym_fused.fused_sym_pipe_full_step`) on the half-band
        operator, the only operator ported.  Returns ``(x2, r2, w_out, p2,
        s2, u2, (mu, delta, gamma, nu))``.
        """
        return fused_sym_pipe_full_step(
            self.op.offsets, self.op.data,
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
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
