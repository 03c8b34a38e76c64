"""Iterations a fixed-iteration call made, against the mix's
``max_iter``: ``|iterations - max_iter|`` of every call (limit 0)."""


def measure(ctx):
    want = int(ctx.mix["max_iter"])
    return {c["i"]: abs(int(c["iterations"]) - want) for c in ctx.calls}
