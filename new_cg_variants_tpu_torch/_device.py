"""Device resolution for the port's entry points.

Every entry point takes ``device``; ``None`` means the CUDA card.  Without a
card that raises: the port never drops to the CPU on its own.  The CPU runs
the plain PyTorch versions of the kernels only when the caller names it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev
