"""The program's input and operator for the PETSc k-banded model problem.

The benchmark makes the band on the device from the configuration's
formula (float64, rounded once to the stored dtype) in symmetric half-band
storage (``data[d, i] = A[i, i + d]``, zeros past the edge) and hands it to
:class:`SymDiaOperator`, the storage of the port's main path."""

from __future__ import annotations

import torch

from h100_bench import roofline
from h100_bench.reference import petsc_banded as ref

__all__ = ["size", "dtype", "program_input", "program_operator",
           "operator_bytes"]


def size(cfg):
    return int(cfg["n"])


def dtype(cfg):
    return getattr(torch, cfg["dtype"])


def program_input(cfg, device):
    n, k = int(cfg["n"]), int(cfg["k"])
    data = torch.full((k, n), float(cfg["off_value"]), dtype=torch.float64,
                      device=device)
    data[0] = ref.diagonal(cfg, device)
    for d in range(1, k):
        data[d, n - d:] = 0.0
    return data.to(dtype(cfg))


def program_operator(cfg, data, device):
    from new_cg_variants_tpu_torch import SymDiaOperator

    return SymDiaOperator(tuple(range(int(cfg["k"]))), data)


def operator_bytes(cfg):
    """The stored upper band with its diagonal: ``k n - k (k-1) / 2``
    values (no indices: the offsets are ``0 .. k-1``)."""
    n, k = int(cfg["n"]), int(cfg["k"])
    return roofline.half_band_values(n, k) * roofline.itemsize(dtype(cfg))
