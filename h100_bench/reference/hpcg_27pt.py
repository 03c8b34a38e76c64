"""HPCG's operator (the reference HPCG's ``GenerateProblem``: 27-point
stencil on an ``nx ny nz`` box, 26 on the diagonal, -1 to each neighbour,
Dirichlet boundary), rebuilt from its configuration, its rows and columns
under the configuration's one random permutation ``p``:
``A_p[i, j] = A[p[i], p[j]]``."""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference.linalg import stencil27_matvec

__all__ = ["size", "permutation", "matvec"]


def size(cfg):
    return int(cfg["grid"]) ** 3


def permutation(cfg):
    """``p`` as numpy int64 (``None`` in the natural numbering)."""
    seed = cfg.get("perm_seed")
    if seed is None:
        return None
    return np.random.default_rng(int(seed)).permutation(size(cfg))


def matvec(cfg, device, dtype=torch.float64):
    """``x -> A_p x`` in ``dtype``: ``(A z)[p]`` with ``z[p] = x``."""
    g = int(cfg["grid"])
    p = permutation(cfg)
    if p is None:
        return lambda x: stencil27_matvec(g, x.to(dtype))
    p = torch.from_numpy(p).to(device)

    def mv(x):
        z = torch.empty_like(x, dtype=dtype)
        z[p] = x.to(dtype)
        return stencil27_matvec(g, z)[p]

    return mv
