"""The PETSc k-banded model problem, rebuilt from its configuration
(``scaling_experiments_petsc/ex2a.c:77-95``): ``A[i, i] = 1 + i/(n-1)
(kappa - 1) rho^(n-1-i)``, ``A[i, j] = off_value`` for ``0 < |i - j| < k``."""

from __future__ import annotations

import torch

from h100_bench.reference.linalg import band_matvec

__all__ = ["diagonal", "matvec"]


def diagonal(cfg, device, dtype=torch.float64):
    n = int(cfg["n"])
    i = torch.arange(n, dtype=torch.float64, device=device)
    decay = torch.pow(torch.tensor(float(cfg["rho"]), dtype=torch.float64,
                                   device=device), (n - 1) - i)
    d = 1.0 + i / (n - 1) * (float(cfg["kappa"]) - 1.0) * decay
    return d.to(dtype)


def matvec(cfg, device, dtype=torch.float64):
    """``x -> A x`` in ``dtype`` (the band's values rounded to it)."""
    diag = diagonal(cfg, device, dtype)
    off = torch.tensor(float(cfg["off_value"]), dtype=dtype, device=device)
    k = int(cfg["k"])
    return lambda x: band_matvec(diag, off, k, x)
