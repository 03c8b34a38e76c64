"""The zero-padded shift that the plain (CPU) band products are written in."""

from __future__ import annotations

import torch


def shift(v: torch.Tensor, off: int) -> torch.Tensor:
    """shift(v, off)[i] = v[i + off], zero-padded at the boundary."""
    if off == 0:
        return v
    if abs(off) >= v.shape[0]:
        return torch.zeros_like(v)
    zeros = v.new_zeros(abs(off))
    if off > 0:
        return torch.cat([v[off:], zeros])
    return torch.cat([zeros, v[:off]])
