"""Operator helpers shared by the storage formats."""

from __future__ import annotations

import torch

__all__ = ["_shift"]


def _shift(v: torch.Tensor, off: int) -> torch.Tensor:
    """shift(v, off)[i] = v[i + off], zero-padded at the boundary."""
    if off == 0:
        return v
    zeros = v.new_zeros(abs(off))
    if off > 0:
        return torch.cat([v[off:], zeros])
    return torch.cat([zeros, v[:off]])
