"""Gap ``||x - x_cg|| / ||x_cg||`` of each sampled answer of a
fixed-iteration call from the reference's plain CG
(``reference/linalg.py:cg``), run in float64 from ``x0 = 0`` for the mix's
``max_iter`` iterations on the right-hand side the program was given (``b``
rounded to the configuration's dtype): in exact arithmetic pipe-PR-CG's
iterates are CG's, so a step left out, repeated or computed wrong shows
here where the residual may not."""

import torch

from h100_bench.reference.linalg import cg


def measure(ctx):
    low = getattr(torch, ctx.config["dtype"])
    out = {}
    for i, x in ctx.samples.items():
        b = ctx.rhs(i).to(low).to(torch.float64)
        xc, _ = cg(ctx.matvec, b, int(ctx.mix["max_iter"]))
        out[i] = float(torch.linalg.vector_norm(x.to(torch.float64) - xc)
                       / torch.linalg.vector_norm(xc))
    return out
