"""Tolerance solves that did not report convergence within ``max_iter``:
1 for such a call, else 0, for every call (limit 0)."""


def measure(ctx):
    cap = int(ctx.mix["max_iter"])
    return {c["i"]: int(not (c["converged"] and c["iterations"] <= cap))
            for c in ctx.calls}
