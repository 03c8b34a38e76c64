"""CG variant families: init/step bodies.

Five families cover the variant surface of the reference (18 names; its
other two, the extended-precision oracle's, are not in this module):

========  ==========================================================
family    variants
========  ==========================================================
hs        hs_cg, hs_pcg                       (2 syncs/iter)
cgcg      cg_cg, cg_pcg                       (1 fused 2-dot sync)
gv        gv_cg, gv_pcg                       (1 sync, SpMV overlap)
pr        pr_cg, m_cg, pr_pcg, m_pcg          (1 fused 4-dot sync)
pipe      pipe_{p,pr,p_m,pr_m}_{cg,pcg}       (1 sync; SpMVs overlap)
========  ==========================================================

Each family is a pair of functions ``init(ctx, b, x0) -> state`` and
``step(ctx, state) -> state`` over a dict state, written against the
:class:`~.context.Context` interface, as in the JAX package.  Math follows
Chen & Carson (arXiv:1905.01549); update *order* is part of the result (beta
from the PREDICTED nu, alpha from the recomputed one,
``cg_variants/pipe_pr_cg.py:63-76``), so each step keeps it exactly.

Every step first asks the context for its fused phase (one kernel pass,
:mod:`..ops.sym_fused` or :mod:`..ops.fused_step`) and takes the generic body
(``mv`` / ``prec`` / ``dots``) when the context declines: an operator kind
without that kernel, a preconditioner other than Jacobi, a norm riding the
dot batch (``ctx.extra_norm``), or gv's replacement hook.

Scalar state keys: ``a`` (alpha_k), ``a1`` (alpha_{k-1}), ``b`` (beta_k),
``b1``, ``nu``; families add their own (``mu``, ``eta``, ``delta``,
``gamma``).  In the double-word mode (``dtype="f32x2"``) every vector and
scalar is a :class:`~..ops.doublefloat.DF` and the same bodies run on its
overloads.  Preconditioned runs carry the tilde vectors (``rt``, ``st``,
...); unpreconditioned runs omit them.  Scalars stay 0-d tensors on the
vectors' device: nothing in a step reads a value back to the host, so the
card never waits for the Python loop.  The iteration counter ``k`` is a
Python int.
"""

from __future__ import annotations

import functools

import torch

from ..ops.doublefloat import DF, df_where
from ..ops.scalars import predict_nu, safe_div
from ..utils.profiling import count
from .context import split_pipe_full_step, with_torch_scalars

__all__ = ["FAMILIES", "family_of", "make_gv_step", "make_pipe_step",
           "make_pr_step"]


def _select(cond, a, b):
    """``torch.where`` for plain or double-word vectors."""
    if isinstance(a, DF):
        return df_where(cond, a, b)
    return torch.where(cond, a, b)


def _common_scalars(nu, mu):
    # zeros built like nu, a tensor or a double-word value
    zero = (DF(torch.zeros_like(nu.hi), torch.zeros_like(nu.lo))
            if isinstance(nu, DF) else torch.zeros_like(nu))
    return dict(nu=nu, mu=mu, a=safe_div(nu, mu), a1=zero, a2=zero, b=zero,
                b1=zero, k=0)


def _rotate(s, new):
    """Shift the alpha/beta index window by one iteration."""
    new["a2"] = s["a1"]
    new["a1"] = s["a"]
    new["b1"] = s["b"]
    new["k"] = s["k"] + 1
    return new


def _norm_pair(ctx, r, rt):
    """Optional extra pair for the sync batch: the convergence norm.

    ``ctx.extra_norm`` is set by :func:`~.engine.tolerance_loop` for
    preconditioned solves with ``norm_type='unpreconditioned'`` (needs
    ``r.r``) or ``'preconditioned'`` (needs ``rt.rt``): the extra scalar
    rides the family's EXISTING dot batch, so norm-checked solves keep one
    sync phase per iteration like PETSc (``cg_impls/pipeprcg.c:112-136``).
    Unpreconditioned runs never need it: there ``nu = r.r`` already.
    """
    if ctx.extra_norm is None:
        return ()
    v = r if ctx.extra_norm == "r" else rt
    return ((v, v),)


# ---------------------------------------------------------------------------
# Hestenes-Stiefel (classic) CG — cf. cg_variants/hs_cg.py
# ---------------------------------------------------------------------------


def hs_init(ctx, b, x0):
    x = x0
    r = b - ctx.mv(x)
    rt = ctx.prec(r)
    p = rt
    (nu,) = ctx.dots((r, rt))
    s = ctx.mv(p)
    (mu,) = ctx.dots((p, s))
    st = dict(x=x, r=r, p=p, s=s, **_common_scalars(nu, mu))
    if ctx.has_prec:
        st["rt"] = rt
    return st


def hs_step(ctx, s_):
    a1 = s_["a"]
    x = s_["x"] + a1 * s_["p"]
    r = s_["r"] - a1 * s_["s"]
    rt = ctx.prec(r)
    extra = _norm_pair(ctx, r, rt)
    out = ctx.dots((r, rt), *extra)  # sync 1
    nu = out[0]
    beta = safe_div(nu, s_["nu"])
    # second sync phase fused: p update + SpMV + mu in one pass.  The phase
    # never touches M, so it serves hs_pcg (rt input) too.
    fused = None if extra else ctx.hs_matvec_phase(rt, s_["p"], beta)
    if fused is not None:
        p, s, (mu,) = fused
    else:
        p = rt + beta * s_["p"]
        s = ctx.mv(p)
        (mu,) = ctx.dots((p, s))  # sync 2
    new = dict(x=x, r=r, p=p, s=s, nu=nu, mu=mu, a=safe_div(nu, mu), b=beta)
    if extra:
        new["rho"] = out[-1]
    if ctx.has_prec:
        new["rt"] = rt
    return _rotate(s_, new)


# ---------------------------------------------------------------------------
# Chronopoulos-Gear two-term-recurrence CG — cf. cg_variants/cg_cg.py
# ---------------------------------------------------------------------------


def cgcg_init(ctx, b, x0):
    x = x0
    r = b - ctx.mv(x)
    rt = ctx.prec(r)
    w = ctx.mv(rt)
    p = rt
    nu, eta = ctx.dots((r, rt), (w, rt))
    s = ctx.mv(p)
    (mu,) = ctx.dots((p, s))
    st = dict(x=x, r=r, w=w, p=p, s=s, eta=eta, **_common_scalars(nu, mu))
    if ctx.has_prec:
        st["rt"] = rt
    return st


def cgcg_step(ctx, s_):
    a1 = s_["a"]
    if ctx.extra_norm is None:
        # fused phase: x, r updates + (PCApply +) w = A rt + the single
        # sync's nu, eta in one pass; only the p, s AXPYs (need beta) stay
        # outside.  Update order identical to the generic body.
        fused = (ctx.cgcg_matvec_phase_prec(s_, a1) if ctx.has_prec
                 else ctx.cgcg_matvec_phase(s_, a1))
        if fused is None:
            pass  # the context has no such kernel: the generic body below
        elif not ctx.has_prec:
            x, r, w, (nu, eta) = fused
            beta = safe_div(nu, s_["nu"])
            p = r + beta * s_["p"]  # rt = r (unpreconditioned)
            s = w + beta * s_["s"]
            mu = eta - safe_div(beta, a1) * nu
            new = dict(x=x, r=r, w=w, p=p, s=s, nu=nu, eta=eta, mu=mu,
                       a=safe_div(nu, mu), b=beta)
            return _rotate(s_, new)
        else:
            x, r, rt, w, (nu, eta) = fused
            beta = safe_div(nu, s_["nu"])
            p = rt + beta * s_["p"]
            s = w + beta * s_["s"]
            mu = eta - safe_div(beta, a1) * nu
            new = dict(x=x, r=r, w=w, p=p, s=s, nu=nu, eta=eta, mu=mu,
                       a=safe_div(nu, mu), b=beta, rt=rt)
            return _rotate(s_, new)
    x = s_["x"] + a1 * s_["p"]
    r = s_["r"] - a1 * s_["s"]
    rt = ctx.prec(r)
    w = ctx.mv(rt)
    extra = _norm_pair(ctx, r, rt)
    out = ctx.dots((r, rt), (w, rt), *extra)  # the single fused sync
    nu, eta = out[0], out[1]
    beta = safe_div(nu, s_["nu"])
    p = rt + beta * s_["p"]
    s = w + beta * s_["s"]
    mu = eta - safe_div(beta, a1) * nu  # scalar recurrence replaces the mu dot
    new = dict(x=x, r=r, w=w, p=p, s=s, nu=nu, eta=eta, mu=mu,
               a=safe_div(nu, mu), b=beta)
    if extra:
        new["rho"] = out[-1]
    if ctx.has_prec:
        new["rt"] = rt
    return _rotate(s_, new)


# ---------------------------------------------------------------------------
# Ghysels-Vanroose pipelined CG — cf. cg_variants/gv_cg.py
# ---------------------------------------------------------------------------


def gv_init(ctx, b, x0):
    x = x0
    r = b - ctx.mv(x)
    rt = ctx.prec(r)
    w = ctx.mv(rt)
    wt = ctx.prec(w)
    p = rt
    s = w
    st_ = wt
    u = ctx.mv(wt)
    nu, eta = ctx.dots((r, rt), (w, rt))
    (mu,) = ctx.dots((p, s))
    state = dict(x=x, r=r, w=w, p=p, s=s, u=u, eta=eta,
                 **_common_scalars(nu, mu))
    if ctx.has_prec:
        state.update(rt=rt, wt=wt, st=st_)
    return state


def make_gv_step(w_replace=None, stateful=False):
    """GV step factory with optional residual-replacement hook.

    ``w_replace(k, state_view) -> bool`` forces ``w = A rt`` at iterations
    where it answers true — the reference's ``w_replace`` /
    ``wk_replace_flags`` mechanism (``gv_cg.py:69-72``).  (The reference's
    preconditioned twin replaces with ``A r``; this uses the mathematically
    consistent ``A rt``, identical when M = I.)  With a hook set the step
    takes the generic body, never the fused phase.

    ``k`` is a Python int, so a schedule such as ``k % 10 == 0`` answers
    with a Python bool: the step branches on it in Python and the product
    is formed only at the replacing iterations, with no host sync.  A policy
    that looks at the vectors answers with a 0-d bool tensor; branching on
    that would make the host wait for the card every iteration, so for a
    tensor answer the step always forms ``A rt`` and selects with
    ``torch.where`` — one more SpMV per iteration, still no sync.

    With ``stateful=True`` the hook threads its own state across
    iterations — ``w_replace(k, state_view, rep_state) -> (bool,
    new_rep_state)`` — carried as the ``wrep`` entry of the solver state
    (the reference's mutable ``wk_replace_flags`` dict, ``gv_cg.py:40``).
    """

    def gv_step(ctx, s_):
        a1 = s_["a"]
        if w_replace is None and ctx.extra_norm is None:
            # fused phase: x, r, w updates + (PCApply +) t = A wt + nu, eta
            # in one pass; the p, s, u(, st) AXPYs (need beta) stay outside.
            fused = (ctx.gv_matvec_phase_prec(s_, a1) if ctx.has_prec
                     else ctx.gv_matvec_phase(s_, a1))
            if fused is None:
                pass  # no such kernel: the generic body below
            elif not ctx.has_prec:
                x, r, w, t, (nu, eta) = fused
                beta = safe_div(nu, s_["nu"])
                p = r + beta * s_["p"]  # rt = r (unpreconditioned)
                s = w + beta * s_["s"]
                u = t + beta * s_["u"]
                mu = eta - safe_div(beta, a1) * nu
                new = dict(x=x, r=r, w=w, p=p, s=s, u=u, nu=nu, eta=eta,
                           mu=mu, a=safe_div(nu, mu), b=beta)
                return _rotate(s_, new)
            else:
                x, r, rt, w, wt, t, (nu, eta) = fused
                beta = safe_div(nu, s_["nu"])
                p = rt + beta * s_["p"]
                s = w + beta * s_["s"]
                u = t + beta * s_["u"]
                st = wt + beta * s_["st"]
                mu = eta - safe_div(beta, a1) * nu
                new = dict(x=x, r=r, w=w, p=p, s=s, u=u, nu=nu, eta=eta,
                           mu=mu, a=safe_div(nu, mu), b=beta, rt=rt, wt=wt,
                           st=st)
                return _rotate(s_, new)
        x = s_["x"] + a1 * s_["p"]
        r = s_["r"] - a1 * s_["s"]
        if ctx.has_prec:
            rt = s_["rt"] - a1 * s_["st"]
        else:
            rt = r
        w = s_["w"] - a1 * s_["u"]
        new_wrep = None
        if w_replace is not None:
            view = dict(k=s_["k"] + 1, x=x, r=r, w=w, u=s_["u"], s=s_["s"],
                        p=s_["p"])
            if stateful:
                do_rep, new_wrep = w_replace(s_["k"] + 1, view, s_["wrep"])
            else:
                do_rep = w_replace(s_["k"] + 1, view)
            if isinstance(do_rep, torch.Tensor):
                w = _select(do_rep, ctx.mv(rt), w)
            elif do_rep:
                w = ctx.mv(rt)
        wt = ctx.prec(w) if ctx.has_prec else w
        # ONE sync phase: dots issued before the matvec
        extra = _norm_pair(ctx, r, rt)
        t, out = ctx.mv_dots(wt, ((r, rt), (w, rt)) + extra)
        nu, eta = out[0], out[1]
        beta = safe_div(nu, s_["nu"])
        p = rt + beta * s_["p"]
        s = w + beta * s_["s"]
        u = t + beta * s_["u"]
        mu = eta - safe_div(beta, a1) * nu
        new = dict(x=x, r=r, w=w, p=p, s=s, u=u, nu=nu, eta=eta, mu=mu,
                   a=safe_div(nu, mu), b=beta)
        if new_wrep is not None:
            new["wrep"] = new_wrep
        if extra:
            new["rho"] = out[-1]
        if ctx.has_prec:
            new["rt"] = rt
            new["wt"] = wt
            new["st"] = wt + beta * s_["st"]
        return _rotate(s_, new)

    return gv_step


# ---------------------------------------------------------------------------
# Predict-and-recompute (PR) / Meurant (M) CG — cf. cg_variants/pr_cg.py
# ---------------------------------------------------------------------------


def _predict_nu(meurant: bool, s_):
    """Predicted nu_k from iteration-(k-1) scalars
    (:func:`~..ops.scalars.predict_nu`)."""
    return predict_nu(s_["nu"], s_["delta"], s_["gamma"], s_["a"], meurant)


def pr_init(ctx, b, x0):
    x = x0
    r = b - ctx.mv(x)
    rt = ctx.prec(r)
    p = rt
    s = ctx.mv(p)
    st_ = ctx.prec(s)
    nu, mu, delta, gamma = ctx.dots((rt, r), (p, s), (r, st_), (st_, s))
    state = dict(x=x, r=r, p=p, s=s, delta=delta, gamma=gamma,
                 **_common_scalars(nu, mu))
    if ctx.has_prec:
        state.update(rt=rt, st=st_)
    return state


def make_pr_step(meurant: bool):
    def pr_step(ctx, s_):
        a1 = s_["a"]
        nu_pred = _predict_nu(meurant, s_)
        beta_pred = safe_div(nu_pred, s_["nu"])
        if ctx.extra_norm is None:
            # beta is PREDICTED (known at entry), so the whole iteration is
            # one pass: x, r(, rt) updates + p update + s = A p (+ st =
            # M^-1 s) + all 4 dots (cg_impls/prcg.c:122-137).  Update order
            # identical to the generic body below.
            fused = (ctx.pr_full_step_prec(s_, a1, beta_pred) if ctx.has_prec
                     else ctx.pr_full_step(s_, a1, beta_pred))
            if fused is None:
                pass  # no such kernel: the generic body below
            elif not ctx.has_prec:
                x, r, p, s, (mu, delta, gamma, nu) = fused
                new = dict(x=x, r=r, p=p, s=s, nu=nu, mu=mu, delta=delta,
                           gamma=gamma, a=safe_div(nu, mu), b=beta_pred)
                return _rotate(s_, new)
            else:
                x, r, rt, p, s, st_, (mu, delta, gamma, nu) = fused
                new = dict(x=x, r=r, p=p, s=s, nu=nu, mu=mu, delta=delta,
                           gamma=gamma, a=safe_div(nu, mu), b=beta_pred,
                           rt=rt, st=st_)
                return _rotate(s_, new)
        x = s_["x"] + a1 * s_["p"]
        r = s_["r"] - a1 * s_["s"]
        if ctx.has_prec:
            rt = s_["rt"] - a1 * s_["st"]
        else:
            rt = r
        beta = beta_pred
        p = rt + beta * s_["p"]
        s = ctx.mv(p)
        st_ = ctx.prec(s) if ctx.has_prec else s
        # one fused 4-dot sync; nu is RECOMPUTED here (used for alpha),
        # while beta above used the predicted value
        extra = _norm_pair(ctx, r, rt)
        out = ctx.dots((p, s), (r, st_), (st_, s), (rt, r), *extra)
        mu, delta, gamma, nu = out[:4]
        new = dict(x=x, r=r, p=p, s=s, nu=nu, mu=mu, delta=delta,
                   gamma=gamma, a=safe_div(nu, mu), b=beta)
        if extra:
            new["rho"] = out[-1]
        if ctx.has_prec:
            new["rt"] = rt
            new["st"] = st_
        return _rotate(s_, new)

    return pr_step


# ---------------------------------------------------------------------------
# Pipelined predict(-and-recompute) (Meurant) CG — cf. cg_variants/
# pipe_pr_cg.py and the PETSc KSPPIPEPRCG hot loop (pipeprcg.c:109-178)
# ---------------------------------------------------------------------------


def pipe_init(ctx, b, x0):
    x = x0
    r = b - ctx.mv(x)
    rt = ctx.prec(r)
    p = rt
    s = ctx.mv(p)
    st_ = ctx.prec(s)
    w = s
    wt = st_
    u = ctx.mv(st_)
    ut = ctx.prec(u)
    nu, mu, delta, gamma = ctx.dots((rt, r), (p, s), (r, st_), (st_, s))
    state = dict(x=x, r=r, p=p, s=s, w=w, u=u, delta=delta, gamma=gamma,
                 **_common_scalars(nu, mu))
    if ctx.has_prec:
        state.update(rt=rt, st=st_, wt=wt, ut=ut)
    return state


def make_pipe_step(meurant: bool, recompute: bool):
    def pipe_step(ctx, s_):
        if not ctx.has_prec:
            # the whole iteration with its scalars (beta from the predicted
            # nu before it, alpha after it): in one kernel pass when the
            # context has one (Context.pipe_full_step), else the split
            # formulation between torch's scalars; identical update order
            # either way
            fused = ctx.pipe_full_step(s_, meurant, recompute)
            if fused is None:
                fused = with_torch_scalars(
                    functools.partial(split_pipe_full_step, ctx), s_,
                    meurant, recompute)
            x, r, w, p, s, u, (mu, delta, gamma, nu), a, beta = fused
            new = dict(x=x, r=r, p=p, s=s, w=w, u=u, nu=nu, mu=mu,
                       delta=delta, gamma=gamma, a=a, b=beta)
            return _rotate(s_, new)
        count("scalar_epilogues.torch")
        a1 = s_["a"]
        nu_pred = _predict_nu(meurant, s_)
        beta = safe_div(nu_pred, s_["nu"])
        # Preconditioned: the whole iteration with both PCApplies in one
        # pass when the context qualifies (the PETSc overlapped
        # MatMult + PCApply region, pipeprcg.c:162-170), then the fused
        # vector phase followed by the products and PCApplies, then the
        # generic formulation; identical update order in all three.
        fused = ctx.pipe_full_step_prec(s_, a1, beta, recompute)
        if fused is not None:
            x, r, w, p, s, u, rt, st_, wt, ut, (mu, delta, gamma, nu) = fused
            new = dict(x=x, r=r, p=p, s=s, w=w, u=u, nu=nu, mu=mu,
                       delta=delta, gamma=gamma, a=safe_div(nu, mu), b=beta,
                       rt=rt, st=st_, wt=wt, ut=ut)
            return _rotate(s_, new)
        vec = ctx.pipe_vector_phase_prec(s_, a1, beta)
        if vec is not None:
            x, r, w, rt, wt, p, s, st_, (mu, delta, gamma, nu) = vec
            if recompute:
                u, w = ctx.mv2(st_, rt)  # 2-RHS matvec
                wt = ctx.prec(w)
            else:
                u = ctx.mv(st_)
            ut = ctx.prec(u)
            new = dict(x=x, r=r, p=p, s=s, w=w, u=u, nu=nu, mu=mu,
                       delta=delta, gamma=gamma, a=safe_div(nu, mu), b=beta,
                       rt=rt, st=st_, wt=wt, ut=ut)
            return _rotate(s_, new)
        x = s_["x"] + a1 * s_["p"]
        r = s_["r"] - a1 * s_["s"]
        w = s_["w"] - a1 * s_["u"]
        rt = s_["rt"] - a1 * s_["st"]
        wt = s_["wt"] - a1 * s_["ut"]
        p = rt + beta * s_["p"]
        s = w + beta * s_["s"]
        st_ = wt + beta * s_["st"]
        # the single sync phase: dots issued before both matvecs
        # (VecDotBegin ... MatMult ... VecDotEnd in pipeprcg.c)
        extra = _norm_pair(ctx, r, rt)
        pairs = ((p, s), (r, st_), (st_, s), (rt, r)) + extra
        if recompute:
            # 2-RHS matvec: u = A st, w = A rt
            u, w, out = ctx.mv2_dots(st_, rt, pairs)
        else:
            u, out = ctx.mv_dots(st_, pairs)
        mu, delta, gamma, nu = out[:4]
        ut = ctx.prec(u)
        if recompute:
            wt = ctx.prec(w)
        new = dict(x=x, r=r, p=p, s=s, w=w, u=u, nu=nu, mu=mu, delta=delta,
                   gamma=gamma, a=safe_div(nu, mu), b=beta, rt=rt, st=st_,
                   wt=wt, ut=ut)
        if extra:
            new["rho"] = out[-1]
        return _rotate(s_, new)

    return pipe_step


FAMILIES = {
    "hs": (hs_init, hs_step),
    "cgcg": (cgcg_init, cgcg_step),
    "gv": (gv_init, make_gv_step()),
    "pr": (pr_init, make_pr_step(meurant=False)),
    "m": (pr_init, make_pr_step(meurant=True)),
    "pipe_p": (pipe_init, make_pipe_step(meurant=False, recompute=False)),
    "pipe_pr": (pipe_init, make_pipe_step(meurant=False, recompute=True)),
    "pipe_p_m": (pipe_init, make_pipe_step(meurant=True, recompute=False)),
    "pipe_pr_m": (pipe_init, make_pipe_step(meurant=True, recompute=True)),
}


def family_of(variant: str) -> tuple:
    """Map a public variant name (e.g. ``'pipe_pr_pcg'``) to its family.

    Returns ``(family_key, preconditioned)``; raises ``KeyError`` for an
    unknown name.
    """
    prec = variant.endswith("pcg")
    base = variant[: -len("_pcg")] if prec else variant[: -len("_cg")]
    key = {"hs": "hs", "cg": "cgcg", "gv": "gv", "pr": "pr", "m": "m"}.get(
        base, base)
    if key not in FAMILIES:
        raise KeyError(f"unknown variant {variant!r}")
    return key, prec
