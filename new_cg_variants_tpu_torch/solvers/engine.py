"""Solver loops: fixed-length history runs and tolerance solves.

:func:`history_scan` — ``length`` states (row 0 = initial state, rows 1..
after each step) with probe rows captured as device tensors; nothing is read
back to the host until the loop has ended.

:func:`tolerance_loop` — iterate until the norm falls below the tolerance or
``max_iter`` is reached, stopping at exactly the iteration the JAX
``while_loop`` stops at; ``norm_type='none'`` runs ``max_iter`` steps with no
sync at all.

Each runs eagerly (``runner=None``: every step's kernels launched from the
host; the tolerance loop reads the norm back once per iteration) or, given a
:class:`~.graphs.Runner` (``use_jit=True`` on the card), by replays of
captured chunks of steps: the first step eagerly, then whole chunks, the
rest one step a replay.  The history's rows are copied out of each chunk on
the device; the tolerance loop reads each chunk's norms back at once, and
where the tolerance fell within a chunk it takes the chunk's starting
state back and replays that many single steps.  Both give the eager loop's
iterations and bits.  The tolerance loop names its rows by the norm type,
so that a later solve of the same operator and shapes replays the graphs
an earlier one captured (:class:`~.graphs.Store`); the history's probe
rows read ``aux``, which is the call's own, and it captures its own.

Each loop counts in ``solves``, and each read back to the host in
``host_syncs`` under a ``readback`` span (:func:`host_value`,
:mod:`..utils.profiling`).
"""

from __future__ import annotations

import torch

from ..ops.doublefloat import collapse
from ..utils.profiling import count, span

__all__ = ["history_scan", "tolerance_loop", "host_value"]


def host_value(t, convert=float):
    """``convert(t)``: ``t`` read back to the host, a read that waits for
    the card, counted in ``host_syncs``."""
    with span("readback", "host_syncs"):
        return convert(t)


def _progress(s):
    """The progress line's value: sqrt(|nu|), single-word."""
    return torch.sqrt(torch.abs(collapse(s["nu"])))


def _print_progress(k, value):
    print(f"iter {k}: sqrt(nu) = {value}")


def history_scan(ctx, init_fn, step_fn, probe_fns, b, x0, length, aux,
                 print_every=0, runner=None):
    """Run ``length`` states (init + length-1 steps), stacking probe rows.

    ``print_every=K`` prints a progress line every K iterations (the
    reference's ``print_k`` callback).  Eagerly each line reads nu back
    from the device, one host sync per K iterations; under a ``runner``
    each chunk's values are read back once after its replay.  It is off by
    default.

    Returns ``(final_state, {name: stacked tensor})``.
    """
    count("solves")
    state = init_fn(ctx, b, x0)

    def probe_row(s):
        return {name: fn(ctx, s, aux) for name, fn in probe_fns.items()}

    if runner is not None:
        return _history_replayed(ctx, step_fn, probe_fns, state, length, aux,
                                 print_every, runner, probe_row(state))
    rows = [probe_row(state)]
    for _ in range(length - 1):
        state = step_fn(ctx, state)
        if print_every and state["k"] % print_every == 0:
            _print_progress(state["k"], host_value(_progress(state)))
        rows.append(probe_row(state))
    hist = {name: torch.stack([row[name] for row in rows])
            for name in probe_fns}
    return state, hist


def _history_replayed(ctx, step_fn, probe_fns, state, length, aux,
                      print_every, runner, row0):
    """:func:`history_scan` by replays: rows into ``(length, ...)`` device
    tensors, copied out of each chunk's row buffers after its replay."""
    hist = {name: r.new_empty((max(length, 1), *r.shape))
            for name, r in row0.items()}
    for name, r in row0.items():
        hist[name][0].copy_(r)
    steps = length - 1
    if steps < 1:
        return state, hist
    def row(fn):
        return lambda c, s: fn(c, s, aux)

    rows = {name: row(fn) for name, fn in probe_fns.items()}
    if print_every:
        rows["_progress"] = lambda c, s: _progress(s)
    k0 = state["k"]

    def sink(k, buf, m):
        for name in probe_fns:
            hist[name][k + 1 - k0:k + 1 - k0 + m].copy_(buf[name][:m])
        if print_every:
            values = host_value(buf["_progress"][:m],
                                torch.Tensor.tolist)  # one read a replay
            for i in range(m):
                if (k + 1 + i) % print_every == 0:
                    _print_progress(k + 1 + i, values[i])

    loop = runner.start(ctx, step_fn, state, rows, horizon=steps - 1)
    sink(k0, {name: r[None] for name, r in loop.first_rows.items()}, 1)
    loop.advance(steps - 1, sink)
    return loop.state(), hist


def tolerance_loop(ctx, init_fn, step_fn, b, x0, max_iter, rtol, atol,
                   norm_type, runner=None):
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
    count("solves")

    in_batch = (norm_type in ("unpreconditioned", "preconditioned")
                and ctx.has_prec)
    if in_batch:
        ctx.extra_norm = "r" if norm_type == "unpreconditioned" else "rt"
    # what the loop's rows read besides the state: a runner with a store
    # replays an earlier solve's graphs of the same key
    rows_key = (norm_type, in_batch)

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
        if runner is not None and max_iter > 0:
            loop = runner.start(ctx, step_fn, state, horizon=max_iter - 1,
                                rows_key=rows_key)
            loop.advance(max_iter - 1)
            state = loop.state()
        else:
            for _ in range(max_iter):
                state = step_fn(ctx, state)
        return state, max(max_iter, 0), iter_norm(state), tol
    k = 0
    nrm = iter_norm(state)
    tol_host = host_value(tol)
    if runner is not None:
        if k < max_iter and host_value(nrm) > tol_host:
            return _tolerance_replayed(ctx, step_fn, state, max_iter,
                                       tol_host, iter_norm, runner,
                                       rows_key) + (tol,)
        return state, k, nrm, tol
    while k < max_iter and host_value(nrm) > tol_host:
        state = step_fn(ctx, state)
        k += 1
        nrm = iter_norm(state)
    return state, k, nrm, tol


def _tolerance_replayed(ctx, step_fn, state, max_iter, tol_host, iter_norm,
                        runner, rows_key):
    """The loop of :func:`tolerance_loop` by replays, from a state that
    takes at least one step: ``(state, iterations, norm)``.

    The first step runs eagerly and its norm is read back; then each chunk
    writes its steps' norms into a device buffer that is read back once.
    Where the eager loop would stop inside a chunk (the norm at or below
    the tolerance, NaN, or ``max_iter`` reached), the chunk's starting state
    is taken back and the steps up to that one replayed singly."""
    loop = runner.start(ctx, step_fn, state,
                        {"norm": lambda c, s: iter_norm(s)},
                        horizon=max_iter - 1, checkpoint=True,
                        rows_key=rows_key)
    k = 1
    nrm = loop.first_rows["norm"]
    if k < max_iter and host_value(nrm) > tol_host:
        while True:
            buf = loop.replay_chunk()["norm"]
            c = loop.chunk
            norms = host_value(buf, torch.Tensor.tolist)  # one read a chunk
            stop = next((i + 1 for i, v in enumerate(norms)
                         if not v > tol_host), c + 1)
            j = min(stop, max_iter - k)
            if j > c:
                k += c
                continue
            if j < c:
                nrm = buf[j - 1].clone()
                loop.restore()
                for _ in range(j):
                    loop.replay_one()
            else:
                nrm = buf[c - 1].clone()
            k += j
            break
    return loop.state(), k, nrm
