"""Padded-ELL SpMV, 1 or 2 right-hand sides: the port of the JAX package's
``ops/ell_pallas.py``.

With ``val`` / ``idx`` of shape ``(n, L)`` (the l-th stored entry of row i,
padding slots holding value 0 and index i),

    y[i] = sum_l val[i, l] * v[idx[i, l]]

* :func:`ell_spmv` — ``A @ v``;
* :func:`ell_spmv2` — ``(A @ v, A @ w)`` from one read of ``val`` and
  ``idx`` (the JAX ``EllOperator.mv2``).

On CUDA tensors each launches the hand-written kernel of
``csrc/ell_spmv.cu``, which takes float32 or float64 values, int32 indices
and any ``n`` and ``L``, and wants ``val`` / ``idx`` as ``(n, L)`` views of
slot-major storage (``val.T`` contiguous, as
:class:`~.operators.EllOperator` keeps them: slot l of neighbouring rows is
then one coalesced read).  On CPU tensors it runs the plain PyTorch version
(:func:`_ell_mv_plain`, :func:`_ell_mv2_plain`: the JAX package's gather
formulation), which is also what the kernel is checked against on the card.
Each wrapper counts its launches in ``.launches``.

Neither the kernel nor the plain version checks that every index lies in
``[0, n)``: a check on the card costs a reduction and a wait for it on every
product.  :func:`check_index` makes it, and
:class:`~.operators.EllOperator` calls it once when it is built; the
wrappers are for arrays so checked, and are not exported.
"""

from __future__ import annotations

import torch

from ._kernels import check_ell, check_vectors

__all__ = ["check_index", "ELL_WRAPPERS"]


def check_index(idx, n):
    """Raise ``ValueError`` unless every ELL column index lies in
    ``[0, n)``."""
    if idx.numel() and bool((idx.min() < 0) | (idx.max() >= n)):
        raise ValueError(f"ELL column indices outside [0, {n})")


def _ell_mv_plain(val, idx, v):
    """Plain PyTorch ELL SpMV: one gather, multiply and row sum."""
    return (val * v[idx]).sum(1)


def _ell_mv2_plain(val, idx, v, w):
    """Plain PyTorch 2-RHS ELL SpMV: one gather of ``[v | w]``."""
    g = torch.stack([v, w], dim=1)[idx]  # (n, L, 2)
    out = (val[:, :, None] * g).sum(1)
    return out[:, 0], out[:, 1]


def _launch(val, idx, vecs):
    from ._kernels import library

    n, L, sfx = check_ell(val, idx)
    check_vectors(val, vecs, n)
    ys = [torch.empty(n, dtype=val.dtype, device=val.device) for _ in vecs]
    two = len(vecs) == 2
    fn = getattr(library("ell_spmv.cu"), f"ell_spmv_{sfx}")
    rc = fn(val.data_ptr(), idx.data_ptr(), L, n, vecs[0].data_ptr(),
            vecs[1].data_ptr() if two else None, ys[0].data_ptr(),
            ys[1].data_ptr() if two else None, len(vecs), val.device.index,
            torch.cuda.current_stream(val.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {rc}")
    return ys


def _plain_or_launch(wrapper, val, idx, vecs):
    tensors = (val, idx) + tuple(vecs)
    if all(t.is_cuda for t in tensors):
        ys = _launch(val, idx, vecs)
        wrapper.launches += 1
        return ys
    if all(t.device.type == "cpu" for t in tensors):
        if len(vecs) == 2:
            return list(_ell_mv2_plain(val, idx, *vecs))
        return [_ell_mv_plain(val, idx, vecs[0])]
    raise ValueError(f"vectors on {[str(v.device) for v in vecs]} with ELL "
                     f"arrays on {val.device} / {idx.device}")


def ell_spmv(val, idx, v):
    """``y = A @ v`` for the padded-ELL matrix ``(val, idx)``, its indices
    already held to ``[0, n)`` by :func:`check_index`."""
    (y,) = _plain_or_launch(ell_spmv, val, idx, (v,))
    return y


def ell_spmv2(val, idx, v, w):
    """``(A @ v, A @ w)`` from one read of ``val`` and ``idx``, its indices
    already held to ``[0, n)`` by :func:`check_index`."""
    y, z = _plain_or_launch(ell_spmv2, val, idx, (v, w))
    return y, z


ELL_WRAPPERS = (ell_spmv, ell_spmv2)
for _fn in ELL_WRAPPERS:
    _fn.launches = 0
