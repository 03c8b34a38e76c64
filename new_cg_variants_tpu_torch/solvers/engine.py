"""Solver loops: fixed-length history runs and tolerance solves.

:func:`history_scan` — ``length`` states (row 0 = initial state, rows 1..
after each step) with probe rows captured as device tensors; nothing is read
back to the host until the loop has ended.

:func:`tolerance_loop` — iterate until the norm falls below the tolerance or
``max_iter`` is reached.  It reads the norm back once per iteration (one host
sync), so it stops at exactly the iteration the JAX ``while_loop`` stops at;
``norm_type='none'`` runs ``max_iter`` steps with no sync at all.
"""

from __future__ import annotations

import torch

from ..ops.doublefloat import collapse

__all__ = ["history_scan", "tolerance_loop"]


def history_scan(ctx, init_fn, step_fn, probe_fns, b, x0, length, aux,
                 print_every=0):
    """Run ``length`` states (init + length-1 steps), stacking probe rows.

    ``print_every=K`` prints a progress line every K iterations (the
    reference's ``print_k`` callback).  Each line reads nu back from the
    device, one host sync per K iterations; it is off by default.

    Returns ``(final_state, {name: stacked tensor})``.
    """
    state = init_fn(ctx, b, x0)

    def probe_row(s):
        return {name: fn(ctx, s, aux) for name, fn in probe_fns.items()}

    rows = [probe_row(state)]
    for _ in range(length - 1):
        state = step_fn(ctx, state)
        if print_every and state["k"] % print_every == 0:
            print(f"iter {state['k']}: sqrt(nu) = "
                  f"{float(torch.sqrt(torch.abs(collapse(state['nu']))))}")
        rows.append(probe_row(state))
    hist = {name: torch.stack([row[name] for row in rows])
            for name in probe_fns}
    return state, hist


def tolerance_loop(ctx, init_fn, step_fn, b, x0, max_iter, rtol, atol,
                   norm_type):
    """Iterate until the chosen norm falls below tol or max_iter hits.

    For unpreconditioned runs all three norm types coincide with
    ``sqrt(nu)`` (there ``nu = r.r``).  For preconditioned runs ``natural``
    is ``sqrt(nu)`` too, and the inner product that ``unpreconditioned``
    (``r.r``) or ``preconditioned`` (``rt.rt``) needs rides the family's
    existing dot batch through ``ctx.extra_norm`` (state key ``rho``), as
    PETSc derives its norms from the same reduction
    (``cg_impls/pipeprcg.c:112-136``).  The tolerance is ``max(rtol * |b|,
    atol)`` with ``|b|`` in the same norm flavour (PETSc
    KSPConvergedDefault): natural -> ``sqrt(b.M^-1 b)``, preconditioned ->
    ``||M^-1 b||``, unpreconditioned -> ``||b||``.

    Returns ``(state, iterations, norm, tol)`` with ``norm`` and ``tol`` as
    0-d tensors (single-word in the double-word mode: every norm, tolerance
    and progress line reads a collapsed value).
    """
    if norm_type not in ("natural", "unpreconditioned", "preconditioned",
                         "none"):
        raise ValueError(f"unknown norm_type {norm_type!r}")

    in_batch = (norm_type in ("unpreconditioned", "preconditioned")
                and ctx.has_prec)
    if in_batch:
        ctx.extra_norm = "r" if norm_type == "unpreconditioned" else "rt"

    def iter_norm(s):
        if norm_type == "none":
            return torch.zeros((), dtype=s["nu"].dtype, device=s["nu"].device)
        return torch.sqrt(torch.abs(collapse(s["rho"] if in_batch
                                             else s["nu"])))

    state = init_fn(ctx, b, x0)
    if in_batch:
        # initial rho: one extra dot outside the loop
        v = (state["rt"] if ctx.extra_norm == "rt" and "rt" in state
             else state["r"])
        (state["rho"],) = ctx.dots((v, v))
    if norm_type == "natural":
        (bb,) = ctx.dots((b, ctx.prec(b)))
    elif norm_type == "preconditioned":
        bt = ctx.prec(b)
        (bb,) = ctx.dots((bt, bt))
    else:
        (bb,) = ctx.dots((b, b))
    tol = torch.clamp(rtol * torch.sqrt(torch.abs(collapse(bb))),
                      min=atol).to(b.dtype)
    if norm_type == "none":
        for _ in range(max_iter):
            state = step_fn(ctx, state)
        return state, max(max_iter, 0), iter_norm(state), tol
    k = 0
    nrm = iter_norm(state)
    tol_host = float(tol)
    while k < max_iter and float(nrm) > tol_host:
        state = step_fn(ctx, state)
        k += 1
        nrm = iter_norm(state)
    return state, k, nrm, tol
