"""Carry operators and solver states across from numpy arrays.

The JAX package's operators and solver state dicts convert to numpy arrays
(``np.asarray``); these helpers rebuild them as the port's objects on a torch
device and back, so that both packages can start from the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .ops.sym_dia import SymDiaOperator

__all__ = ["operator_from_numpy", "state_from_numpy", "state_to_numpy"]


def operator_from_numpy(offsets, data, *, dtype=None, device=None):
    """A :class:`SymDiaOperator` from stored offsets and ``(ndiag, n)`` data."""
    dev = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(data))
    return SymDiaOperator(offsets, t.to(device=dev, dtype=dtype))


def state_from_numpy(state: dict, *, dtype=None, device=None) -> dict:
    """A solver state dict of numpy arrays as torch tensors on ``device``.

    Vectors and scalars become tensors (scalars 0-d); the iteration counter
    ``k`` becomes a Python int, as the port's step functions carry it.
    """
    dev = resolve_device(device)
    out = {}
    for key, val in state.items():
        if key == "k":
            out[key] = int(np.asarray(val))
        else:
            arr = np.asarray(val)
            out[key] = torch.from_numpy(np.array(arr)).to(device=dev,
                                                         dtype=dtype)
    return out


def state_to_numpy(state: dict) -> dict:
    """The inverse of :func:`state_from_numpy` (``k`` as ``np.int32``)."""
    out = {}
    for key, val in state.items():
        if key == "k":
            out[key] = np.int32(val)
        else:
            out[key] = val.detach().cpu().numpy()
    return out
