"""True relative residual ``||b - A x|| / ||b||`` of each sampled answer,
``A`` the reference operator and ``b = A x_true`` both in float64."""

import torch


def measure(ctx):
    out = {}
    for i, x in ctx.samples.items():
        b = ctx.rhs(i)
        r = b - ctx.matvec(x.to(torch.float64))
        out[i] = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    return out
