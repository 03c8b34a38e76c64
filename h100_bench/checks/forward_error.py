"""Relative forward error ``||x - x_true|| / ||x_true||`` of each sampled
answer, ``x_true`` the solution the right-hand side was made from."""

import torch


def measure(ctx):
    out = {}
    for i, x in ctx.samples.items():
        xt = ctx.solution(i)
        out[i] = float(torch.linalg.vector_norm(x.to(torch.float64) - xt)
                       / torch.linalg.vector_norm(xt))
    return out
