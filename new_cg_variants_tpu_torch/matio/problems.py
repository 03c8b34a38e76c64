"""Synthetic model problems.

* :func:`model_spectrum` — the diagonal model problem of the mpi4py
  strong-scaling runs (``scaling_experiments_mpi4py/scaling_tests.py:30-37``):
  eigenvalues ``lam_i = lam1 + (lamn-lam1) * i/(n-1) * rho**(n-1-i)`` with
  ``lam1 = 1/kappa``, ``lamn = 1``.
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
    "model_spectrum",
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


def model_spectrum(n: int, kappa: float = 1e6, rho: float = 0.9,
                   dtype=np.float64, device=None):
    """Diagonal model problem ``A = diag(Lambda)`` as a one-diagonal
    :class:`~..ops.operators.DiaOperator`.

    Returns ``(op, b, x_true)`` where ``x_true = 1/sqrt(n)`` (constant unit
    vector) and ``b = A @ x_true`` as numpy arrays, and the operator's data
    on ``device`` (default: the CUDA card).
    """
    from ..ops.operators import DiaOperator

    dev = resolve_device(device)
    lam = model_spectrum_eigenvalues(n, kappa, rho, dtype)
    op = DiaOperator((0,), torch.from_numpy(lam[None, :].astype(dtype)).to(dev))
    x_true = np.full(n, 1.0 / np.sqrt(n), dtype=dtype)
    b = lam * x_true
    return op, b, x_true


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
    """k-banded model problem.

    Off-diagonals at distances ``1 .. k-1`` on each side hold the constant
    ``off_value`` (band condition ``|i-j| < k``, ``ex2a.c:86-90``).
    ``fmt='symdia'`` returns the symmetric half-band storage
    (:class:`~..ops.sym_dia.SymDiaOperator`: main + upper diagonals, half the
    matrix traffic); ``fmt='dia'`` the general
    :class:`~..ops.operators.DiaOperator` with offsets ``-(k-1) .. k-1``.
    The default here is ``'symdia'``, the storage of the port's main path;
    the JAX package defaults to ``'dia'``.  ``fmt='stencil'`` gives the
    matrix-free :class:`~..ops.stencil.BandedStencilOperator` (O(n) product,
    no matrix storage).

    Returns ``(op, b, x_true)`` with ``x_true = 1`` and ``b = A @ x_true`` as
    numpy arrays, and the operator's data on ``device`` (default: the CUDA
    card).
    """
    if fmt not in ("symdia", "dia", "stencil"):
        raise ValueError(f"unknown fmt {fmt!r}")
    from ..ops.operators import DiaOperator
    from ..ops.stencil import BandedStencilOperator
    from ..ops.sym_dia import SymDiaOperator

    dev = resolve_device(device)
    diag = banded_model_diagonal(n, kappa, rho, dtype)
    counts = np.minimum(np.arange(n), k - 1) + np.minimum(
        n - 1 - np.arange(n), k - 1
    )
    if fmt == "stencil":
        op = BandedStencilOperator(torch.from_numpy(diag).to(dev),
                                   np.asarray(off_value, dtype=diag.dtype), k)
        return op, diag + off_value * counts, np.ones(n, dtype=dtype)
    if fmt == "dia":
        offsets = tuple(range(-(k - 1), k))
        data = np.full((len(offsets), n), off_value, dtype=dtype)
        for d, off in enumerate(offsets):
            if off == 0:
                data[d] = diag
            elif off > 0:
                # entries A[i, i+off] exist for i < n-off; zeros after
                data[d, n - off:] = 0.0
            else:
                data[d, :-off] = 0.0
        op = DiaOperator(offsets, torch.from_numpy(data).to(dev))
        # b = A @ 1: out-of-band positions are explicit zeros, so the row
        # sum is a plain sum over the diagonals
        return op, data.sum(axis=0), np.ones(n, dtype=dtype)
    offsets = tuple(range(k))
    data = np.full((k, n), off_value, dtype=dtype)
    data[0] = diag
    for d in range(1, k):
        data[d, n - d :] = 0.0
    op = SymDiaOperator(offsets, torch.from_numpy(data).to(dev))
    x_true = np.ones(n, dtype=dtype)
    b = diag + off_value * counts
    return op, b, x_true
