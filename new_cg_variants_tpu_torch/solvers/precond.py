"""Preconditioners.

The reference uses exactly one preconditioner in its experiments — Jacobi,
``x -> x / diag(A)`` — but threads arbitrary callables through every
``*_pcg`` variant.  Here a preconditioner is a plain object with
``apply(v)``; :class:`FunctionPreconditioner` wraps a raw callable.
``astype`` and ``to`` carry a preconditioner to the solve's vector dtype and
device (the identity and a wrapped callable hold no tensors and return
themselves).  In the double-word mode a wrapped callable or an object with
``apply`` maps :class:`~..ops.doublefloat.DF` vectors as they come (neither
is cast or moved there), and Jacobi is
:class:`~..ops.doublefloat.DFJacobi`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["JacobiPreconditioner", "FunctionPreconditioner",
           "IdentityPreconditioner", "make_preconditioner"]


@dataclass
class JacobiPreconditioner:
    """Diagonal scaling  M^{-1} v = v / diag(A)."""

    inv_diag: torch.Tensor

    @classmethod
    def from_operator(cls, op):
        d = op.diagonal()
        if d.dtype == torch.bfloat16:
            # bf16 is a storage tier for the MATRIX data; the inverse
            # diagonal is one vector — keep the PCApply in f32
            d = d.to(torch.float32)
        return cls(1.0 / d)

    def apply(self, v):
        return self.inv_diag * v

    def astype(self, dtype):
        return JacobiPreconditioner(self.inv_diag.to(dtype))

    def to(self, device):
        return JacobiPreconditioner(self.inv_diag.to(device).contiguous())


class IdentityPreconditioner:
    """M = I.  Used when a ``*_pcg`` variant is run without a spec, matching
    the reference default ``preconditioner=lambda x: x``."""

    def apply(self, v):
        return v

    def astype(self, dtype):
        return self

    def to(self, device):
        return self


class FunctionPreconditioner:
    """Wrap a callable ``v -> M^{-1} v`` on torch tensors."""

    def __init__(self, fn):
        self.fn = fn

    def apply(self, v):
        return self.fn(v)

    def astype(self, dtype):
        return self

    def to(self, device):
        return self


def make_preconditioner(spec, op):
    """Resolve a preconditioner spec.

    ``spec`` may be None, ``'jacobi'``, a preconditioner object (anything
    with ``.apply``), or a callable.
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec == "jacobi":
            return JacobiPreconditioner.from_operator(op)
        raise ValueError(f"unknown preconditioner {spec!r}")
    if hasattr(spec, "apply"):
        return spec
    if callable(spec):
        return FunctionPreconditioner(spec)
    raise TypeError(f"bad preconditioner spec: {spec!r}")
