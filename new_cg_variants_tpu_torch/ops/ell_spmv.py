"""Padded-ELL SpMV, 1 or 2 right-hand sides: the port of the JAX package's
``ops/ell_pallas.py``.

With ``val`` / ``idx`` of shape ``(n, L)`` (the l-th stored entry of row i,
padding slots holding value 0 and index i),

    y[i] = sum_l val[i, l] * v[idx[i, l]]

* :func:`ell_spmv` — ``A @ v``;
* :func:`ell_spmv2` — ``(A @ v, A @ w)`` from one read of ``val`` and
  ``idx`` (the JAX ``EllOperator.mv2``).

Both take an optional ``perm``: the arrays then hold ``B = P A P^T`` in a
locality order (:func:`reorder`: row i of B is row ``perm[i]`` of A, its
slots in the same order, its columns mapped through the inverse
permutation), and the product is ``y[perm] = B v[perm]``: :func:`ell_gather`
gathers the vectors into the order, the product writes ``y[perm[i]]``.  The
terms of each row are the same products added in the same slot order, so
the result is the given order's, bit for bit.

On CUDA tensors each launches the hand-written kernels of
``csrc/ell_spmv.cu``, which take float32, float64 or bf16 values (bf16
with float32 vectors and results, as the JAX package's default ELL product
promotes them), int32 indices and any ``n`` and ``L``, and want ``val`` / ``idx`` as ``(n, L)`` views of
slot-major storage (``val.T`` contiguous, as
:class:`~.operators.EllOperator` keeps them: slot l of neighbouring rows is
then one coalesced read).  On CPU tensors they run the plain PyTorch
versions (:func:`_ell_mv_plain`, :func:`_ell_mv2_plain`: the JAX package's
gather formulation, and :func:`_ell_reordered_plain`: gather in, the same,
scatter out), which are also what the kernels are checked against on the
card.  Each wrapper counts its launches in ``.launches``.

Neither the kernels nor the plain versions check that every index lies in
``[0, n)``: a check on the card costs a reduction and a wait for it on every
product.  :func:`check_index` makes it, and
:class:`~.operators.EllOperator` calls it once when it is built; the
wrappers are for arrays so checked, and are not exported.
"""

from __future__ import annotations

import torch

from ._kernels import check_ell, check_vectors, compute_dtype

__all__ = ["check_index", "check_perm", "reorder", "ELL_WRAPPERS"]


def check_index(idx, n):
    """Raise ``ValueError`` unless every ELL column index lies in
    ``[0, n)``."""
    if idx.numel() and bool((idx.min() < 0) | (idx.max() >= n)):
        raise ValueError(f"ELL column indices outside [0, {n})")


def check_perm(perm, n):
    """``perm`` as an int32 tensor on its device; ``ValueError`` unless it
    is a permutation of ``range(n)``."""
    perm = torch.as_tensor(perm)
    if (perm.shape != (n,) or perm.is_floating_point()
            or (n and bool((perm.min() < 0) | (perm.max() >= n)))
            or not bool((torch.bincount(perm.long(), minlength=n)
                         == 1).all())):
        raise ValueError(f"an ELL order must be a permutation of range({n})")
    return perm.to(torch.int32).contiguous()


def reorder(val_t, idx_t, perm):
    """Slot-major ``(L, n)`` storage of ``B = P A P^T`` from that of ``A``:
    row i of B is row ``perm[i]`` of A with its slots in the same order, its
    column indices mapped through the inverse permutation (a padding slot
    keeps value 0 and gets index i)."""
    p = perm.long()
    inv = torch.empty_like(p)
    inv[p] = torch.arange(p.numel(), device=p.device)
    return (val_t[:, p].contiguous(),
            inv[idx_t[:, p].long()].to(torch.int32).contiguous())


def restore(val_t, idx_t, perm):
    """The inverse of :func:`reorder`: ``A``'s slot-major storage from
    ``B``'s."""
    p = perm.long()
    val = torch.empty_like(val_t)
    val[:, p] = val_t
    idx = torch.empty_like(idx_t)
    idx[:, p] = perm[idx_t.long()]
    return val, idx


def _ell_mv_plain(val, idx, v):
    """Plain PyTorch ELL SpMV: one gather, multiply and row sum (the
    products made row-major first, so that every row is summed by the same
    code wherever it stands: a locality order then gives the same bits)."""
    return (val * v[idx]).contiguous().sum(1)


def _ell_mv2_plain(val, idx, v, w):
    """Plain PyTorch 2-RHS ELL SpMV: one gather of ``[v | w]``, each row
    summed as :func:`_ell_mv_plain` sums it."""
    g = torch.stack([v, w], dim=1)[idx]  # (n, L, 2)
    out = (val[:, None, :] * g.transpose(1, 2)).contiguous().sum(2)
    return out[:, 0], out[:, 1]


def _ell_gather_plain(perm, vecs):
    """Plain version of the gather in: each vector in the storage's order."""
    p = perm.long()
    return [v[p] for v in vecs]


def _ell_reordered_plain(val, idx, perm, vecs):
    """Plain product in a locality order: gather in, the plain product of
    the given order's formulation, scatter out."""
    xs = _ell_gather_plain(perm, vecs)
    ys = ([_ell_mv_plain(val, idx, xs[0])] if len(xs) == 1
          else list(_ell_mv2_plain(val, idx, *xs)))
    p = perm.long()
    out = []
    for y in ys:
        z = torch.empty_like(y)
        z[p] = y
        out.append(z)
    return out


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ell_gather(perm, vecs):
    """The gather in of a product in a locality order, on CUDA tensors:
    ``v[perm]`` (then ``w[perm]``) as one flat buffer, which :func:`ell_spmv`
    / :func:`ell_spmv2` launch before their product."""
    from ._kernels import KERNEL_DTYPES, library

    v = vecs[0]
    n = v.shape[0]
    check_vectors(v, vecs, n)
    if not (v.is_cuda and perm.is_cuda and perm.device == v.device
            and perm.dtype == torch.int32 and perm.shape == (n,)
            and perm.is_contiguous()):
        raise ValueError("the gather takes CUDA vectors and a contiguous "
                         "int32 (n,) order on their device")
    xs = torch.empty(len(vecs) * n, dtype=v.dtype, device=v.device)
    fn = getattr(library("ell_spmv.cu"),
                 f"ell_gather_{KERNEL_DTYPES[v.dtype]}")
    rc = fn(perm.data_ptr(), n, v.data_ptr(),
            vecs[1].data_ptr() if len(vecs) == 2 else None, xs.data_ptr(),
            len(vecs), v.device.index, _stream(v))
    if rc != 0:
        raise RuntimeError(f"ell_gather kernel launch failed: CUDA error {rc}")
    ell_gather.launches += 1
    return xs


def _launch(val, idx, vecs, perm=None):
    from ._kernels import library

    n, L, sfx = check_ell(val, idx)
    check_vectors(val, vecs, n)
    ys = [torch.empty(n, dtype=compute_dtype(val.dtype), device=val.device)
          for _ in vecs]
    two = len(vecs) == 2
    if perm is None:
        v0, v1 = vecs[0].data_ptr(), vecs[1].data_ptr() if two else None
    else:
        xs = ell_gather(perm, vecs)
        v0, v1 = xs.data_ptr(), None
    fn = getattr(library("ell_spmv.cu"), f"ell_spmv_{sfx}")
    rc = fn(val.data_ptr(), idx.data_ptr(), L, n,
            None if perm is None else perm.data_ptr(), v0, v1,
            ys[0].data_ptr(), ys[1].data_ptr() if two else None, len(vecs),
            val.device.index, _stream(val))
    if rc != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {rc}")
    return ys


def _plain_or_launch(wrapper, val, idx, vecs, perm):
    tensors = (val, idx) + tuple(vecs) + (() if perm is None else (perm,))
    if all(t.is_cuda for t in tensors):
        ys = _launch(val, idx, vecs, perm)
        wrapper.launches += 1
        return ys
    if all(t.device.type == "cpu" for t in tensors):
        if perm is not None:
            return _ell_reordered_plain(val, idx, perm, vecs)
        if len(vecs) == 2:
            return list(_ell_mv2_plain(val, idx, *vecs))
        return [_ell_mv_plain(val, idx, vecs[0])]
    raise ValueError(f"vectors on {[str(v.device) for v in vecs]} with ELL "
                     f"arrays on {val.device} / {idx.device}")


def ell_spmv(val, idx, v, perm=None):
    """``y = A @ v`` for the padded-ELL matrix ``(val, idx)``, its indices
    already held to ``[0, n)`` by :func:`check_index`; with ``perm`` (int32,
    from :func:`check_perm`) the arrays hold ``B = P A P^T``
    (:func:`reorder`) and ``y`` is still ``A @ v``."""
    (y,) = _plain_or_launch(ell_spmv, val, idx, (v,), perm)
    return y


def ell_spmv2(val, idx, v, w, perm=None):
    """``(A @ v, A @ w)`` from one read of ``val`` and ``idx``, as
    :func:`ell_spmv`."""
    y, z = _plain_or_launch(ell_spmv2, val, idx, (v, w), perm)
    return y, z


ELL_WRAPPERS = (ell_spmv, ell_spmv2, ell_gather)
for _fn in ELL_WRAPPERS:
    _fn.launches = 0
