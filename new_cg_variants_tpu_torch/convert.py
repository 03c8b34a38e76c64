"""Carry operators and solver states across from numpy arrays.

The JAX package's operators and solver state dicts convert to numpy arrays
(``np.asarray``); these helpers rebuild them as the port's objects on a torch
device and back, so that both packages can start from the same inputs.  A double-word value
(``dtype="f32x2"``) crosses as the pair ``(hi, lo)`` of its word arrays, a
double-word operator as its offsets and three word arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .ops.block_banded import BlockBandedOperator, PermutedBlockBandedOperator
from .ops.doublefloat import DF, DFOperator
from .ops.operators import DenseOperator, DiaOperator, EllOperator
from .ops.stencil import BandedStencilOperator
from .ops.sym_dia import SymDiaOperator
from .solvers.precond import JacobiPreconditioner

__all__ = ["operator_from_numpy", "df_operator_from_numpy",
           "preconditioner_from_numpy", "state_from_numpy", "state_to_numpy"]


def _tensor(a, dtype, dev):
    # a copy: arrays that JAX hands out are read-only
    return torch.from_numpy(np.array(a, order="C")).to(device=dev,
                                                       dtype=dtype)


def operator_from_numpy(offsets=None, data=None, *, kind="symdia",
                        dtype=None, device=None, **arrays):
    """The port's operator of the JAX operator's ``kind``, from its numpy
    arrays:

    * ``"symdia"`` / ``"dia"``: :class:`SymDiaOperator` /
      :class:`DiaOperator` from stored ``offsets`` and ``(ndiag, n)``
      ``data``;
    * ``"dense"``: :class:`DenseOperator` from an ``(n, n)`` ``data``
      (``offsets`` is ``None``);
    * ``"ell"``: :class:`EllOperator` from ``val`` and ``idx`` (``(n, L)``)
      and ``nnz``;
    * ``"stencil"``: :class:`BandedStencilOperator` from ``diag``,
      ``off_value`` and ``k``;
    * ``"block_banded"``: :class:`BlockBandedOperator` from ``a_blk``,
      ``n_orig`` and ``nnz``, wrapped in a
      :class:`PermutedBlockBandedOperator` when ``perm`` is given.
    """
    dev = resolve_device(device)
    if kind == "ell":
        val = _tensor(np.asarray(arrays["val"]).T, dtype, dev).T
        idx = _tensor(np.asarray(arrays["idx"], dtype=np.int32).T, None,
                      dev).T
        return EllOperator(val, idx, int(arrays["nnz"]))
    if kind == "stencil":
        diag = _tensor(arrays["diag"], dtype, dev)
        return BandedStencilOperator(
            diag, np.asarray(arrays["off_value"]), int(arrays["k"]))
    if kind == "block_banded":
        op = BlockBandedOperator(_tensor(arrays["a_blk"], dtype, dev),
                                 int(arrays["n_orig"]), int(arrays["nnz"]))
        perm = arrays.get("perm")
        if perm is None:
            return op
        return PermutedBlockBandedOperator(
            op, _tensor(np.asarray(perm, dtype=np.int64), None, dev))
    if arrays:
        raise TypeError(f"unexpected arrays {sorted(arrays)} for {kind!r}")
    t = _tensor(data, dtype, dev)
    if kind == "dense":
        return DenseOperator(t)
    if kind not in ("symdia", "dia"):
        raise ValueError(f"unknown operator kind {kind!r}")
    return (SymDiaOperator if kind == "symdia" else DiaOperator)(offsets, t)


def df_operator_from_numpy(offsets, hi, lo, lo2, *, idx=None, nnz=0,
                           device=None):
    """A :class:`~.ops.doublefloat.DFOperator` from its three word arrays:
    DIA (``(ndiag, n)`` words at ``offsets``), ELL (``(n, L)`` words with
    ``idx`` and ``nnz``; ``offsets`` is ``None``) or, with ``offsets`` and
    ``idx`` ``None``, dense (``(n, n)`` words), such as the JAX
    ``DFOperator``'s ``inner`` data, ``lo_data`` and ``lo2_data``."""
    if idx is not None:
        inner = operator_from_numpy(kind="ell", val=hi, idx=idx, nnz=nnz,
                                    device=device)
    else:
        kind = "dense" if offsets is None else "dia"
        inner = operator_from_numpy(offsets, hi, kind=kind, device=device)
    lo, lo2 = (_tensor(w, None, inner.device) for w in (lo, lo2))
    return DFOperator(inner, lo, lo2)


def preconditioner_from_numpy(inv_diag, *, dtype=None, device=None):
    """A :class:`JacobiPreconditioner` from a numpy inverse diagonal."""
    dev = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(inv_diag))
    return JacobiPreconditioner(t.to(device=dev, dtype=dtype))


def _leaf_from_numpy(val, dtype, dev):
    """A dict (the gv hook's ``wrep`` state) entry by entry; a pair ``(hi,
    lo)`` as a :class:`~.ops.doublefloat.DF`; a floating array as a tensor of
    ``dtype``; an integer or bool one in its own type.
    """
    if isinstance(val, dict):
        return {k: _leaf_from_numpy(v, dtype, dev) for k, v in val.items()}
    if isinstance(val, tuple):
        return DF(*(_leaf_from_numpy(w, dtype, dev) for w in val))
    t = torch.from_numpy(np.array(np.asarray(val)))
    return t.to(device=dev, dtype=dtype if t.is_floating_point() else None)


def state_from_numpy(state: dict, *, dtype=None, device=None) -> dict:
    """A solver state dict of numpy arrays as torch tensors on ``device``.

    Vectors (``x r p s w u`` and, for preconditioned runs, ``rt st wt ut``)
    and scalars (``nu mu eta delta gamma rho a a1 a2 b b1``) become tensors
    (scalars 0-d), or double-word values where they arrive as ``(hi, lo)``
    pairs; the iteration counter ``k`` becomes a Python int, as the
    port's step functions carry it; ``wrep``, the state of gv's stateful
    replacement hook, is carried across entry by entry.
    """
    dev = resolve_device(device)
    return {key: int(np.asarray(val)) if key == "k"
            else _leaf_from_numpy(val, dtype, dev)
            for key, val in state.items()}


def _leaf_to_numpy(val):
    if isinstance(val, dict):
        return {k: _leaf_to_numpy(v) for k, v in val.items()}
    if isinstance(val, DF):
        return (_leaf_to_numpy(val.hi), _leaf_to_numpy(val.lo))
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def state_to_numpy(state: dict) -> dict:
    """The inverse of :func:`state_from_numpy` (``k`` as ``np.int32``)."""
    return {key: np.int32(val) if key == "k" else _leaf_to_numpy(val)
            for key, val in state.items()}
