"""Public variant entry points of this slice.

``pipe_p_cg``, ``pipe_pr_cg``, ``pipe_p_m_cg`` and ``pipe_pr_m_cg``, with
the reference's signature shape ``variant(A, b, x0, max_iter, probes=...,
preconditioner=..., ...)`` plus ``device``.
"""

from __future__ import annotations

from .api import run

__all__ = ["pipe_p_cg", "pipe_pr_cg", "pipe_p_m_cg", "pipe_pr_m_cg"]


def _make_variant(name):
    def variant(
        A,
        b,
        x0=None,
        max_iter=100,
        probes=("updated_residual_2_norm",),
        preconditioner=None,
        x_true=None,
        dtype=None,
        device=None,
    ):
        return run(name, A, b, x0=x0, max_iter=max_iter, probes=probes,
                   preconditioner=preconditioner, x_true=x_true, dtype=dtype,
                   device=device)

    variant.__name__ = name
    variant.__qualname__ = name
    variant.__doc__ = f"{name} on the PyTorch/CUDA port (see solvers.families)."
    return variant


pipe_p_cg = _make_variant("pipe_p_cg")
pipe_pr_cg = _make_variant("pipe_pr_cg")
pipe_p_m_cg = _make_variant("pipe_p_m_cg")
pipe_pr_m_cg = _make_variant("pipe_pr_m_cg")
