"""The step's scalar formulas, one for every operator and context.

The families form alpha and beta with them in torch; the half-band kernel's
scalar epilogue (:func:`.sym_fused.fused_sym_pipe_full_step_scalars`) keeps
their operation order, and its plain version calls them.
"""

from __future__ import annotations

import torch

__all__ = ["predict_nu", "safe_div"]


def predict_nu(nu, delta, gamma, a1, meurant):
    """The predicted nu_k from the iteration-(k-1) scalars, in this
    operation order:

    PR:      nu1 - 2*a1*delta1 + a1^2*gamma1
    Meurant: -nu1 + a1^2*gamma1
    (cf. cg_variants/pr_cg.py:62-63)
    """
    if meurant:
        return -nu + a1 * a1 * gamma
    return nu - 2.0 * a1 * delta + a1 * a1 * gamma


def safe_div(num, den):
    """``num / den``, but 0 when ``den`` is exactly 0 — the
    post-convergence stagnation guard.

    A long fixed-iteration f32 solve underflows ``nu`` to exact zero; the
    next ``beta = 0/0`` would poison the state with NaN.  With every
    alpha/beta formed here an exact zero denominator yields 0 and the
    iterate freezes, finite.  For nonzero denominators the quotient is the
    plain division, bit for bit.  Double-word values take
    :func:`.doublefloat.df_safe_div`.
    """
    # imported here: doublefloat imports the kernels that import this module
    from .doublefloat import DF, df_safe_div

    if isinstance(num, DF) or isinstance(den, DF):
        return df_safe_div(num, den)
    return torch.where(den != 0, num / den, 0.0)
