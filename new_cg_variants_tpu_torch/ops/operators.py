"""Linear operators: dense and diagonal (DIA) storage.

* :class:`DenseOperator` — a plain 2-D tensor; ``mv`` is one matrix product
  (``torch.matmul``: the JAX package leaves it to XLA too, no kernel of its
  own), ``mv2`` one product with ``[v | w]``.
* :class:`DiaOperator` — diagonal storage, row-indexed: ``data[d, i] =
  A[i, i + offsets[d]]`` with explicit zeros where the position falls outside
  the matrix.  ``mv`` / ``mv2`` go through :mod:`.spmv_dia`: the hand-written
  kernel on the card, the plain shift formulation on the CPU.
* :class:`~.sym_dia.SymDiaOperator` (its own module) — the symmetric
  half-band form.

All expose ``n``, ``nnz``, ``dtype``, ``device``, ``mv(v)``, ``mv2(v, w)``
(one pass over A for both), ``diagonal()``, ``astype(dtype)``,
``to(device)``, ``todense()`` and ``tocsr()`` (host, float64).

The ELL format, the ``build_*`` constructors, ``choose_format`` and
``from_coo`` of the JAX package are not ported yet (ROADMAP.md, open item
1.5), so :func:`as_operator` takes operators and arrays only.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from . import spmv_dia

__all__ = ["DenseOperator", "DiaOperator", "as_operator"]


class DenseOperator:
    """Dense SPD operator; SpMV is a matrix product."""

    def __init__(self, a: torch.Tensor):
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected a square matrix, got {tuple(a.shape)}")
        self.a = a

    @property
    def n(self) -> int:
        return self.a.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.a.shape[0] * self.a.shape[1])

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def mv(self, v):
        return self.a @ v

    def mv2(self, v, w):
        out = self.a @ torch.stack([v, w], dim=1)
        return out[:, 0], out[:, 1]

    def diagonal(self):
        return torch.diagonal(self.a)

    def astype(self, dtype):
        return DenseOperator(self.a.to(dtype))

    def to(self, device):
        return DenseOperator(self.a.to(device))

    def todense(self):
        return self.a.detach().cpu().to(torch.float64).numpy()

    def tocsr(self):
        import scipy.sparse as sp

        return sp.csr_matrix(self.todense())


class DiaOperator:
    """Diagonal-storage operator, row-indexed.

    ``offsets`` is a tuple of any distinct integers (negative ones are the
    lower diagonals); ``data`` is a ``(ndiags, n)`` torch tensor and
    ``mv``/``mv2`` run on its device.
    """

    def __init__(self, offsets, data: torch.Tensor):
        offsets = tuple(int(o) for o in offsets)
        if len(set(offsets)) != len(offsets):
            raise ValueError(f"repeated offsets in {offsets}")
        if data.ndim != 2 or data.shape[0] != len(offsets):
            raise ValueError(f"data shape {tuple(data.shape)} does not match "
                             f"{len(offsets)} offsets")
        self.offsets = offsets
        self.data = data

    @property
    def n(self) -> int:
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        n = self.n
        return int(sum(n - abs(o) for o in self.offsets))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def mv(self, v):
        return spmv_dia.dia_spmv(self.offsets, self.data, v)

    def mv2(self, v, w):
        return spmv_dia.dia_spmv2(self.offsets, self.data, v, w)

    def diagonal(self):
        return self.data[self.offsets.index(0)]

    def astype(self, dtype):
        return DiaOperator(self.offsets, self.data.to(dtype))

    def to(self, device):
        return DiaOperator(self.offsets, self.data.to(device).contiguous())

    def tocsr(self):
        import scipy.sparse as sp

        n = self.n
        data = self.data.detach().cpu().to(torch.float64).numpy()
        rows, cols, vals = [], [], []
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(data[d, i])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n))

    def todense(self):
        return self.tocsr().toarray()


def as_operator(a, dtype=None, device=None):
    """Coerce an operator, a numpy array or a tensor into an operator on
    ``device`` (default: the CUDA card) in ``dtype`` (default: its own).

    Anything exposing the operator protocol (``mv`` / ``diagonal``) passes
    through; an array becomes a :class:`DenseOperator`.  A scipy sparse
    matrix or a COO triple needs the format policy of the JAX package's
    ``from_coo``, which is not ported yet.
    """
    dev = resolve_device(device)
    # (a tensor has ``mv`` and ``diagonal`` too, and is an array here)
    if (hasattr(a, "mv") and hasattr(a, "diagonal")
            and not isinstance(a, torch.Tensor)):
        op = a if a.device == dev else a.to(dev)
        return op if dtype is None or dtype == op.dtype else op.astype(dtype)
    if (hasattr(a, "tocoo") and not isinstance(a, np.ndarray)) or all(
            hasattr(a, k) for k in ("row", "col", "val")):
        raise NotImplementedError(
            f"{type(a).__name__} input needs from_coo / choose_format, which "
            "are not ported yet (ROADMAP.md, open item 1.5 'Operators and "
            "formats'); pass a DiaOperator, a SymDiaOperator or a dense array")
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return DenseOperator(t.to(device=dev, dtype=dtype))
