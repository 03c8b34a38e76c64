"""Synthetic model problems.

* :func:`model_spectrum_eigenvalues` — eigenvalues of the diagonal model
  problem of the mpi4py strong-scaling runs
  (``scaling_experiments_mpi4py/scaling_tests.py:30-37``).
* :func:`banded_model` — the k-banded model problem of the PETSc
  strong-scaling runs (``scaling_experiments_petsc/ex2a.c:77-95``): diagonal
  ``1 + (i/(n-1)) * (kappa-1) * rho**(n-1-i)``, constant ``off_value`` on
  all off-diagonals with ``|i-j| < k``.

The arrays are built in numpy exactly as the JAX package builds them, so the
two packages start from bit-identical problems; only the finished operator
moves to the torch device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "model_spectrum_eigenvalues",
    "banded_model_diagonal",
    "banded_model",
]


def model_spectrum_eigenvalues(
    n: int, kappa: float = 1e6, rho: float = 0.9, dtype=np.float64
) -> np.ndarray:
    """Eigenvalues of the mpi4py diagonal model problem."""
    lam1 = 1.0 / kappa
    lamn = 1.0
    i = np.arange(n, dtype=dtype)
    decay = rho ** np.arange(n - 1, -1, -1, dtype=dtype)
    return (lam1 + (lamn - lam1) * i / (n - 1) * decay).astype(dtype)


def banded_model_diagonal(
    n: int, kappa: float = 1e6, rho: float = 0.95, dtype=np.float64
) -> np.ndarray:
    """Diagonal entries of the PETSc k-banded model problem."""
    i = np.arange(n, dtype=dtype)
    return (1.0 + i / (n - 1) * (kappa - 1.0) * rho ** np.arange(n - 1, -1, -1, dtype=dtype)).astype(dtype)


def banded_model(
    n: int,
    k: int = 32,
    off_value: float = 1e-4,
    kappa: float = 1e6,
    rho: float = 0.95,
    dtype=np.float64,
    fmt: str = "symdia",
    device=None,
):
    """k-banded model problem as a half-band :class:`SymDiaOperator`.

    Off-diagonals at distances ``1 .. k-1`` hold the constant ``off_value``
    (band condition ``|i-j| < k``, ``ex2a.c:86-90``).  Returns ``(op, b,
    x_true)`` with ``x_true = 1`` and ``b = A @ x_true`` as numpy arrays, and
    the operator's data on ``device`` (default: the CUDA card).

    Only ``fmt='symdia'`` is ported, hence the default (the JAX package
    defaults to ``'dia'``); ``'dia'`` and ``'stencil'`` raise.
    """
    if fmt in ("dia", "stencil"):
        raise NotImplementedError(
            f"fmt={fmt!r} is not ported yet (ROADMAP.md, 'Modules to port', "
            "item 'Operators and formats')")
    if fmt != "symdia":
        raise ValueError(f"unknown fmt {fmt!r}")
    from ..ops.sym_dia import SymDiaOperator

    dev = resolve_device(device)
    diag = banded_model_diagonal(n, kappa, rho, dtype)
    offsets = tuple(range(k))
    data = np.full((k, n), off_value, dtype=dtype)
    data[0] = diag
    for d in range(1, k):
        data[d, n - d :] = 0.0
    op = SymDiaOperator(offsets, torch.from_numpy(data).to(dev))
    x_true = np.ones(n, dtype=dtype)
    counts = np.minimum(np.arange(n), k - 1) + np.minimum(
        n - 1 - np.arange(n), k - 1
    )
    b = diag + off_value * counts
    return op, b, x_true
