"""Padded-ELL SpMV, 1 or 2 right-hand sides: the port of the JAX package's
``ops/ell_pallas.py``.

With ``val`` / ``idx`` of shape ``(n, L)`` (the l-th stored entry of row i,
padding slots holding value 0 and index i),

    y[i] = sum_l val[i, l] * v[idx[i, l]]

* :func:`ell_spmv` — ``A @ v``;
* :func:`ell_spmv2` — ``(A @ v, A @ w)`` from one read of ``val`` and
  ``idx`` (the JAX ``EllOperator.mv2``);
* :func:`ell_spmv_cache` / :func:`ell_spmv2_cache` — the local product of a
  row shard (``parallel/contexts.py:EllRowShardContext``): ``m`` rows whose
  indices point into a vector of length ``c >= m``, the rank's own rows
  followed by what the exchange brought.  The kernel takes ``n`` as the
  row count only and reads ``v[idx]`` wherever the index points, so these
  are the same C entry with ``n = m`` and the cache as the vector.

Both take an optional ``perm``: the arrays then hold ``B = P A P^T`` in a
locality order (:func:`reorder`: row i of B is row ``perm[i]`` of A, its
slots in the same order, its columns mapped through the inverse
permutation), and the product is ``y[perm] = B v[perm]``: :func:`ell_gather`
gathers the vectors into the order, the product writes ``y[perm[i]]``.  The
terms of each row are the same products added in the same slot order, so
the result is the given order's, bit for bit.  That is what a single
product of :class:`~.operators.EllOperator` in a locality order does; a
solve takes the permutation out of its loop instead
(:func:`~.block_banded.solver_basis`): it iterates on ``B`` with no order,
whose products neither gather in nor scatter out, and moves its vectors in
with :func:`gather_rows` (``ell_gather``) and out with :func:`scatter_rows`
once a solve.  The cache entries
take the order as two arrays, ``perm`` for the shard's rows and ``cols``
for the columns they touch (``parallel/dist.py:_ell_locality_shard``): the
indices then point into ``cache[cols]``, which the gather in builds,
``len(cols)`` long whatever the cache's length.

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

__all__ = ["check_index", "check_perm", "reorder", "gather_rows",
           "ELL_WRAPPERS"]


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


def _ell_reordered_plain(val, idx, perm, vecs, cols=None):
    """Plain product in a locality order: gather in (through ``cols``,
    default ``perm``), the plain product of the given order's formulation,
    scatter out (through ``perm``)."""
    xs = _ell_gather_plain(perm if cols is None else cols, vecs)
    ys = ([_ell_mv_plain(val, idx, xs[0])] if len(xs) == 1
          else list(_ell_mv2_plain(val, idx, *xs)))
    p = perm.long()
    out = []
    for y in ys:
        z = torch.empty_like(y)
        z[p] = y
        out.append(z)
    return out


def gather_rows(perm, v):
    """``v[perm]``: a CUDA vector through :func:`ell_gather` (one launch), a
    CPU tensor through its plain version (along the first axis)."""
    if v.device.type == "cpu" and perm.device.type == "cpu":
        return _ell_gather_plain(perm, [v])[0]
    return ell_gather(perm, [v.contiguous()])


def scatter_rows(perm, y):
    """``out`` with ``out[perm] = y`` along the first axis: the inverse of
    :func:`gather_rows`, indexing with the int32 ``perm`` itself (no int64
    copy of it is kept)."""
    out = torch.empty_like(y)
    out[perm] = y
    return out


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_order(order, k, device, what):
    """``order`` a contiguous int32 ``(k,)`` tensor on ``device`` (``k``
    ``None``: any length)."""
    if not (order.is_cuda and order.device == device
            and order.dtype == torch.int32 and order.ndim == 1
            and (k is None or order.shape[0] == k)
            and order.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous int32 "
                         f"({'k' if k is None else k},) CUDA tensor on "
                         f"{device}")


def ell_gather(perm, vecs):
    """The gather in of a product in a locality order, on CUDA tensors:
    ``v[perm]`` (then ``w[perm]``) as one flat buffer, which :func:`ell_spmv`
    / :func:`ell_spmv2` and the cache entries launch before their product.
    ``perm``: the ``k`` indices to gather (a permutation of the vectors'
    range, or a shard's column order), already held to that range."""
    from ._kernels import KERNEL_DTYPES, library

    v = vecs[0]
    check_vectors(v, vecs, v.shape[0])
    if not v.is_cuda:
        raise ValueError("the gather takes CUDA vectors")
    _check_order(perm, None, v.device, "the gather's indices")
    k = perm.shape[0]
    xs = torch.empty(len(vecs) * k, dtype=v.dtype, device=v.device)
    fn = getattr(library("ell_spmv.cu"),
                 f"ell_gather_{KERNEL_DTYPES[v.dtype]}")
    rc = fn(perm.data_ptr(), k, v.data_ptr(),
            vecs[1].data_ptr() if len(vecs) == 2 else None, xs.data_ptr(),
            len(vecs), v.device.index, _stream(v))
    if rc != 0:
        raise RuntimeError(f"ell_gather kernel launch failed: CUDA error {rc}")
    ell_gather.launches += 1
    return xs


def check_launch_args(val, idx, vecs, perm=None, c=None, cols=None):
    """Validate what :func:`_launch` is handed: the ``(n, L)`` arrays, the
    vectors of length ``c`` (default ``n``), the rows' order ``perm``
    (``(n,)``) and the columns' ``cols`` (any length: the vector the
    product reads is ``len(cols)`` long).  Returns ``(n, L, suffix)``."""
    n, L, sfx = check_ell(val, idx)
    check_vectors(val, vecs, n if c is None else c)
    if cols is not None and perm is None:
        raise ValueError("a column order needs the rows' order")
    if perm is not None:
        _check_order(perm, n, val.device, "the rows' order")
        if cols is None and c not in (None, n):
            raise ValueError(f"an order of {n} rows gathers from vectors of "
                             f"{n}, not {c}: pass the columns' order")
    if cols is not None:
        _check_order(cols, None, val.device, "the columns' order")
    return n, L, sfx


def _launch(val, idx, vecs, perm=None, c=None, cols=None):
    """The kernel on ``(n, L)`` arrays; ``c``: the vectors' length, when it
    is not ``n`` (a shard's cache); ``perm`` / ``cols``: the rows' and the
    columns' locality order (``cols`` default ``perm``)."""
    from ._kernels import library

    n, L, sfx = check_launch_args(val, idx, vecs, perm, c, cols)
    ys = [torch.empty(n, dtype=compute_dtype(val.dtype), device=val.device)
          for _ in vecs]
    two = len(vecs) == 2
    if perm is None:
        v0, v1 = vecs[0].data_ptr(), vecs[1].data_ptr() if two else None
    else:
        xs = ell_gather(perm if cols is None else cols, vecs)
        v0 = xs.data_ptr()
        # the second vector is the buffer's second half
        v1 = v0 + xs.numel() // 2 * xs.element_size() if two else None
    fn = getattr(library("ell_spmv.cu"), f"ell_spmv_{sfx}")
    rc = fn(val.data_ptr(), idx.data_ptr(), L, n,
            None if perm is None else perm.data_ptr(), v0, v1,
            ys[0].data_ptr(), ys[1].data_ptr() if two else None, len(vecs),
            val.device.index, _stream(val))
    if rc != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {rc}")
    return ys


def _plain_or_launch(wrapper, val, idx, vecs, perm, c=None, cols=None):
    tensors = (val, idx, *vecs, *(t for t in (perm, cols) if t is not None))
    if all(t.is_cuda for t in tensors):
        ys = _launch(val, idx, vecs, perm, c, cols)
        wrapper.launches += 1
        return ys
    if all(t.device.type == "cpu" for t in tensors):
        if perm is not None:
            return _ell_reordered_plain(val, idx, perm, vecs, cols)
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


def ell_spmv_cache(val, idx, cache, perm=None, cols=None):
    """``y[i] = sum_l val[i, l] * cache[idx[i, l]]`` for the ``m`` rows of
    ``(val, idx)`` and a vector ``cache`` of length ``c >= m``, the indices
    already held to ``[0, c)`` by :func:`check_index`.  With ``perm`` /
    ``cols`` (int32, ``(m,)`` and ``(k,)``) the rows are in a locality
    order, row i being the shard's row ``perm[i]``, and the indices point
    into ``cache[cols]`` (held to ``[0, k)``); ``y`` is in the shard's
    given order all the same."""
    (y,) = _plain_or_launch(ell_spmv_cache, val, idx, (cache,), perm,
                            cache.shape[0], cols)
    return y


def ell_spmv2_cache(val, idx, cache_v, cache_w, perm=None, cols=None):
    """Both right-hand sides' caches from one read of ``val`` and ``idx``
    (and, in a locality order, one gather in), as :func:`ell_spmv_cache`."""
    y, z = _plain_or_launch(ell_spmv2_cache, val, idx, (cache_v, cache_w),
                            perm, cache_v.shape[0], cols)
    return y, z


ELL_WRAPPERS = (ell_spmv, ell_spmv2, ell_gather, ell_spmv_cache,
                ell_spmv2_cache)
for _fn in ELL_WRAPPERS:
    _fn.launches = 0
