"""Declarative per-iteration probes (observability layer).

Each probe is a function ``probe(ctx, state, aux) -> tensor`` evaluated
after every step; :func:`..solvers.engine.history_scan` stacks the rows.
Names match the JAX package (and the reference's ``callbacks/``);
``aux`` carries run-constant data (``b``, ``x_true``).  Rows are single-word
in every mode: a double-word value (``dtype="f32x2"``) is collapsed
(:func:`~..ops.doublefloat.collapse`).
"""

from __future__ import annotations

import torch

from ..ops.doublefloat import collapse

__all__ = ["PROBES", "resolve_probes", "DEFAULT_PROBES"]


def error_A_norm(ctx, state, aux):
    e = state["x"] - aux["x_true"]
    (eae,) = ctx.dots((e, ctx.mv(e)))
    return torch.sqrt(torch.abs(collapse(eae)))


def error_2_norm(ctx, state, aux):
    e = state["x"] - aux["x_true"]
    (ee,) = ctx.dots((e, e))
    return torch.sqrt(torch.abs(collapse(ee)))


def residual_2_norm(ctx, state, aux):
    r_true = aux["b"] - ctx.mv(state["x"])
    (rr,) = ctx.dots((r_true, r_true))
    return torch.sqrt(torch.abs(collapse(rr)))


def updated_residual_2_norm(ctx, state, aux):
    r = state["r"]
    (rr,) = ctx.dots((r, r))
    return torch.sqrt(torch.abs(collapse(rr)))


def _scalar(key):
    def probe(ctx, state, aux):
        return collapse(state[key])

    return probe


def save_x(ctx, state, aux):
    return collapse(state["x"])


def save_r(ctx, state, aux):
    return collapse(state["r"])


PROBES = {
    "error_A_norm": error_A_norm,
    "error_2_norm": error_2_norm,
    "residual_2_norm": residual_2_norm,
    "updated_residual_2_norm": updated_residual_2_norm,
    "alpha": _scalar("a"),
    "beta": _scalar("b"),
    "nu": _scalar("nu"),
    "mu": _scalar("mu"),
    "save_x": save_x,
    "save_r": save_r,
}

DEFAULT_PROBES = ("updated_residual_2_norm",)


def resolve_probes(probes):
    """Normalise a probe spec list into ``{name: fn}``.

    Entries may be names from :data:`PROBES` or ``(name, fn)`` pairs for
    custom probes.
    """
    out = {}
    for p in probes:
        if isinstance(p, str):
            out[p] = PROBES[p]
        elif isinstance(p, tuple) and len(p) == 2 and callable(p[1]):
            out[p[0]] = p[1]
        elif callable(p):
            out[getattr(p, "__name__", repr(p))] = p
        else:
            raise TypeError(f"bad probe spec {p!r}")
    return out
