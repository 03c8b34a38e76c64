"""Pipelined predict(-and-recompute) CG family: init and step bodies.

``pipe_init(ctx, b, x0) -> state`` and ``step(ctx, state) -> state`` over a
dict state, as in the JAX package (Chen & Carson, arXiv:1905.01549; the
PETSc KSPPIPEPRCG hot loop, ``cg_impls/pipeprcg.c:109-178``).  Update order
is part of the result: beta comes from the PREDICTED nu, alpha from the
recomputed one (``cg_variants/pipe_pr_cg.py:63-76``).

Scalars (alpha, beta, nu, ...) stay 0-d tensors on the vectors' device:
nothing in a step reads a value back to the host, so the card never waits
for the Python loop.  The iteration counter ``k`` is a Python int.

Only the unpreconditioned pipe variants are ported in this slice; the other
families (hs, cgcg, gv, pr, m) and the Jacobi twins raise.
"""

from __future__ import annotations

import torch

__all__ = ["FAMILIES", "family_of", "make_pipe_step", "pipe_init"]

# every family key of the JAX package; FAMILIES holds the ported ones
_ALL_FAMILY_KEYS = ("hs", "cgcg", "gv", "pr", "m",
                    "pipe_p", "pipe_pr", "pipe_p_m", "pipe_pr_m")


def _safe_div(num, den):
    """``num / den``, but 0 when ``den`` is exactly 0 — the
    post-convergence stagnation guard.

    A long fixed-iteration f32 solve underflows ``nu`` to exact zero; the
    next ``beta = 0/0`` would poison the state with NaN.  With every
    alpha/beta formed here an exact zero denominator yields 0 and the
    iterate freezes, finite.  For nonzero denominators the quotient is the
    plain division, bit for bit.
    """
    return torch.where(den != 0, num / den, 0.0)


def _common_scalars(nu, mu):
    zero = torch.zeros_like(nu)
    return dict(nu=nu, mu=mu, a=_safe_div(nu, mu), a1=zero, a2=zero, b=zero,
                b1=zero, k=0)


def _rotate(s, new):
    """Shift the alpha/beta index window by one iteration."""
    new["a2"] = s["a1"]
    new["a1"] = s["a"]
    new["b1"] = s["b"]
    new["k"] = s["k"] + 1
    return new


def _predict_nu(meurant: bool, s_):
    """Predicted nu_k from iteration-(k-1) scalars.

    PR:      nu = nu1 - 2*a1*delta1 + a1^2*gamma1
    Meurant: nu = -nu1 + a1^2*gamma1
    (cf. cg_variants/pr_cg.py:62-63)
    """
    a1 = s_["a"]
    if meurant:
        return -s_["nu"] + a1 * a1 * s_["gamma"]
    return s_["nu"] - 2.0 * a1 * s_["delta"] + a1 * a1 * s_["gamma"]


def _no_prec(ctx):
    if ctx.has_prec:
        raise NotImplementedError(
            "preconditioned pipe variants are not ported yet (ROADMAP.md, "
            "'Modules to port')")


def pipe_init(ctx, b, x0):
    _no_prec(ctx)
    x = x0
    r = b - ctx.mv(x)
    p = r
    s = ctx.mv(p)
    w = s
    u = ctx.mv(s)
    nu, mu, delta, gamma = ctx.dots((r, r), (p, s), (r, s), (s, s))
    return dict(x=x, r=r, p=p, s=s, w=w, u=u, delta=delta, gamma=gamma,
                **_common_scalars(nu, mu))


def make_pipe_step(meurant: bool, recompute: bool):
    def pipe_step(ctx, s_):
        _no_prec(ctx)
        a1 = s_["a"]
        nu_pred = _predict_nu(meurant, s_)
        beta = _safe_div(nu_pred, s_["nu"])
        # the whole iteration: vector phase + dot batch + SpMV(s) in one
        # kernel pass for half-band storage (Context.pipe_full_step)
        x, r, w, p, s, u, (mu, delta, gamma, nu) = ctx.pipe_full_step(
            s_, a1, beta, recompute)
        new = dict(x=x, r=r, p=p, s=s, w=w, u=u, nu=nu, mu=mu, delta=delta,
                   gamma=gamma, a=_safe_div(nu, mu), b=beta)
        return _rotate(s_, new)

    return pipe_step


FAMILIES = {
    "pipe_p": (pipe_init, make_pipe_step(meurant=False, recompute=False)),
    "pipe_pr": (pipe_init, make_pipe_step(meurant=False, recompute=True)),
    "pipe_p_m": (pipe_init, make_pipe_step(meurant=True, recompute=False)),
    "pipe_pr_m": (pipe_init, make_pipe_step(meurant=True, recompute=True)),
}


def family_of(variant: str) -> tuple:
    """Map a public variant name (e.g. ``'pipe_pr_pcg'``) to its family.

    Returns ``(family_key, preconditioned)``; raises ``KeyError`` for a name
    the JAX package does not know either.  The key may name a family that is
    not ported yet (not in :data:`FAMILIES`).
    """
    prec = variant.endswith("pcg")
    base = variant[: -len("_pcg")] if prec else variant[: -len("_cg")]
    key = {"hs": "hs", "cg": "cgcg", "gv": "gv", "pr": "pr", "m": "m"}.get(
        base, base)
    if key not in _ALL_FAMILY_KEYS:
        raise KeyError(f"unknown variant {variant!r}")
    return key, prec
