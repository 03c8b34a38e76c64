"""The program's input and operator for HPCG's 27-point operator.

The benchmark builds the matrix as scipy CSR in the configuration's dtype,
in vectorised numpy (:func:`csr`), under the configuration's random
permutation, and hands it to
``as_operator``: the auto route picks the format (ELL in RCM order at 104^3,
float32)."""

from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch

from h100_bench import roofline
from h100_bench.reference import hpcg_27pt as ref

__all__ = ["size", "dtype", "nonzeros", "csr", "program_input",
           "program_operator", "operator_bytes"]


def size(cfg):
    return ref.size(cfg)


def dtype(cfg):
    return getattr(torch, cfg["dtype"])


def nonzeros(cfg):
    """Stored entries: ``(3 g - 2)^3`` on a ``g^3`` box."""
    return (3 * int(cfg["grid"]) - 2) ** 3


def csr(cfg):
    """Row ``i`` of ``A_p`` is row ``p[i]`` of ``A``: the up to 27
    neighbours of each point as a ``(n, 27)`` table (``n`` past each
    boundary), rows gathered by ``p``, columns renumbered by ``p``'s
    inverse and sorted in each row; no COO conversion."""
    import scipy.sparse as sp

    g = int(cfg["grid"])
    n = g ** 3
    idx = np.arange(n, dtype=np.int64).reshape(g, g, g)
    table = np.full((g, g, g, 27), n, dtype=np.int64)
    for k, off in enumerate(itertools.product((-1, 0, 1), repeat=3)):
        src = tuple(slice(max(0, -d), g - max(0, d)) for d in off)
        dst = tuple(slice(max(0, d), g - max(0, -d)) for d in off)
        table[src + (k,)] = idx[dst]
    table = table.reshape(n, 27)
    p = ref.permutation(cfg)
    if p is not None:
        pinv = np.empty(n + 1, dtype=np.int64)
        pinv[p] = np.arange(n)
        pinv[n] = n
        table = pinv[table[p]]
        table.sort(axis=1)
    stored = table < n
    lens = stored.sum(1)
    cols = table[stored]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    diag = cols == np.repeat(np.arange(n), lens)
    val = np.where(diag, 26.0, -1.0).astype(cfg["dtype"])
    return sp.csr_matrix((val, cols.astype(np.int32),
                          indptr.astype(np.int32)), shape=(n, n))


def program_input(cfg, device):
    return csr(cfg)


def program_operator(cfg, a, device):
    from new_cg_variants_tpu_torch import as_operator

    with warnings.catch_warnings():
        # the auto route warns when it falls back to ELL: that is the path
        warnings.simplefilter("ignore")
        return as_operator(a, dtype=dtype(cfg), device=device)


def operator_bytes(cfg):
    """Each stored entry's value and its 4-byte column index."""
    return nonzeros(cfg) * (roofline.itemsize(dtype(cfg)) + 4)
