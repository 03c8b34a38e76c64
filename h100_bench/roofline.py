"""The least bytes a solver step moves, and the card's published peak.

Counted from the step's work, not from any kernel: the operator's stored
entries read once, each state vector the step reads read once and each it
writes written once.  So the share stays defined, and under 100%, whatever
kernels a later version runs the step with.
"""

from __future__ import annotations

import torch

__all__ = ["HBM_BYTES_PER_S", "STEP_VECTORS", "itemsize",
           "half_band_values", "step_bytes"]

#: device memory bandwidth of one H100 SXM, NVIDIA's data sheet (700 W)
HBM_BYTES_PER_S = 3.35e12

#: state vectors one unpreconditioned step reads and writes.  pipe-PR-CG
#: (Chen & Carson, Alg. pipe-PR-CG; ``solvers/families.py`` with M = I):
#: reads x, r, w, u, p, s; writes the same six (u = A s and w = A r
#: recomputed by the step's 2-RHS product from the new s and r, which the
#: step itself makes, so they are not read again)
STEP_VECTORS = {"pipe_pr_cg": (6, 6)}


def itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def half_band_values(n, k):
    """Values of a symmetric band of half-width ``k - 1`` stored as its
    main and upper diagonals."""
    return k * n - k * (k - 1) // 2


def step_bytes(variant, n, operator_bytes, vector_itemsize):
    reads, writes = STEP_VECTORS[variant]
    return operator_bytes + (reads + writes) * n * vector_itemsize
