"""Double-word (two-float) arithmetic: the ``dtype="f32x2"`` solve mode.

The port of the JAX package's ``ops/doublefloat.py``.  The mode carries every
solver vector and scalar as an unevaluated pair ``hi + lo`` of float32 words
(Dekker double-word arithmetic, ~48 significant bits) and the operator as the
exact three-word split of its float64 values, so that a float32 machine
reproduces the reference's float64 convergence (attainable accuracy, delay of
convergence).  The H100 has float64; the mode is ported because the JAX
package has it, and its results are compared with float64 runs.

* :class:`DF` — a pair ``(hi, lo)`` with operator overloads, so that the
  family step bodies (:mod:`..solvers.families`) run unchanged in double
  words: ``x + a1 * p`` is :func:`~.compensated.df_mul` then
  :func:`~.compensated.df_add`.  A plain dataclass, not a tensor subclass.
* :class:`DFOperator` — a :class:`~.operators.DiaOperator`,
  :class:`~.operators.DenseOperator` or :class:`~.operators.EllOperator`
  holding the high words, with the two lower words beside it; ``mv`` /
  ``mv2`` go through :mod:`.df_spmv` for DIA and dense (the kernel on the
  card, the plain version on the CPU).  An ELL inner takes the JAX
  package's gathered formulation in plain PyTorch on either device (the
  JAX package has no double-word ELL kernel).
* :func:`df_dot` — the double-word inner product.
* :class:`DFJacobi` and :class:`DoubleFloatContext` — the Jacobi
  preconditioner and the execution context of the mode, built by
  ``run(..., dtype="f32x2")`` / ``solve``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from . import df_spmv
from ..matio.matrix_market import CooMatrix
from .compensated import df_add, df_div, df_dot_words, df_mul
from .operators import (
    DenseOperator,
    DiaOperator,
    EllOperator,
    build_dense,
    build_dia,
    build_ell,
    choose_format,
    coo_from_scipy,
)
from .sym_dia import SymDiaOperator

__all__ = ["DF", "DFOperator", "DFJacobi", "DoubleFloatContext", "collapse",
           "df_split", "df_split3", "df_zeros", "df_where", "df_safe_div",
           "df_dot", "df_operator"]


def collapse(v):
    """A :class:`DF` as ``hi + lo`` in working precision; anything else
    unchanged.  Probe rows and convergence norms are recorded single-word."""
    return v.hi + v.lo if isinstance(v, DF) else v


@dataclass
class DF:
    """Unevaluated double-word value ``hi + lo`` (a tensor pair, any shape).

    Every overload takes a plain number or tensor on either side too (as a
    value with a zero low word), so step bodies written for tensors run
    unchanged.
    """

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape

    @property
    def device(self):
        return self.hi.device

    def value(self):
        """Collapse to working precision."""
        return self.hi + self.lo

    def value64(self):
        """Collapse to float64 on the words' device (keeps both words)."""
        return self.hi.double() + self.lo.double()

    def to(self, device):
        return DF(self.hi.to(device), self.lo.to(device))

    def _coerce(self, other):
        if isinstance(other, DF):
            return other
        if isinstance(other, torch.Tensor):
            o = other.to(device=self.hi.device, dtype=self.hi.dtype)
        else:  # a number: filled on the device, no copy from the host
            o = self.hi.new_full((), other)
        return DF(o, torch.zeros_like(o))

    def __add__(self, other):
        o = self._coerce(other)
        return DF(*df_add(self.hi, self.lo, o.hi, o.lo))

    __radd__ = __add__

    def __neg__(self):
        return DF(-self.hi, -self.lo)

    def __sub__(self, other):
        o = self._coerce(other)
        return DF(*df_add(self.hi, self.lo, -o.hi, -o.lo))

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        o = self._coerce(other)
        return DF(*df_mul(self.hi, self.lo, o.hi, o.lo))

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        return DF(*df_div(self.hi, self.lo, o.hi, o.lo))

    def __rtruediv__(self, other):
        return self._coerce(other).__truediv__(self)


def _host64(a):
    """An array, tensor or number as a float64 numpy array on the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)


def _tensors(words, dtype, dev):
    # (numpy gives 0-d results of 0-d arithmetic as scalars)
    return tuple(torch.from_numpy(np.asarray(w)).to(device=dev, dtype=dtype)
                 for w in words)


def df_split(a, dtype=torch.float32, device=None) -> DF:
    """The double-word value nearest a float64 array: ``hi = f32(a)``, ``lo =
    f32(a - hi)``, split on the host and placed on ``device`` (default: the
    CUDA card)."""
    dev = resolve_device(device)
    a64 = _host64(a)
    hi = a64.astype(np.float32)
    lo = (a64 - hi.astype(np.float64)).astype(np.float32)
    return DF(*_tensors((hi, lo), dtype, dev))


def df_split3(a, dtype=torch.float32, device=None):
    """Three-word split ``(hi, lo, lo2)`` of a float64 array, exact: 3 x 24
    bits hold its 53-bit significand, so ``hi + lo + lo2`` gives the array
    back bit for bit.  The operator's data takes this split: with two words
    the matrix would be a fixed perturbation of relative size 2^-48, and CG
    would converge to the perturbed system's solution."""
    dev = resolve_device(device)
    a64 = _host64(a)
    hi = a64.astype(np.float32)
    rem = a64 - hi.astype(np.float64)
    lo = rem.astype(np.float32)
    lo2 = (rem - lo.astype(np.float64)).astype(np.float32)
    return _tensors((hi, lo, lo2), dtype, dev)


def df_zeros(n, dtype=torch.float32, device=None) -> DF:
    z = torch.zeros(n, dtype=dtype, device=resolve_device(device))
    return DF(z, z)


def df_where(cond, a: DF, b: DF) -> DF:
    return DF(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def df_safe_div(num, den):
    """The double-word form of :func:`.scalars.safe_div`: 0 where
    the collapsed denominator is exactly 0."""
    if not isinstance(num, DF):
        num = den._coerce(num)
    if not isinstance(den, DF):
        den = num._coerce(den)
    nz = (den.hi + den.lo) != 0
    one = torch.ones_like(den.hi)
    safe = df_where(nz, den, DF(one, torch.zeros_like(one)))
    q = num / safe
    zero = torch.zeros_like(q.hi)
    return df_where(nz, q, DF(zero, zero))


def df_dot(x: DF, y: DF) -> DF:
    """Double-word inner product: error-free products, the cross terms in
    their error words, the double-word tree sum (forward error O(eps^2 n)
    relative to the exact dot of the double-word inputs)."""
    return DF(*df_dot_words(x.hi, x.lo, y.hi, y.lo))


#: Largest dimension at which the auto route of :func:`df_operator` turns a
#: block-banded choice into a dense operator (larger: ELL).  The JAX
#: package's routing rule (``supports_df_dense``, ``df_spmv.py:188``); the
#: dense kernel here takes any n.
DF_DENSE_ROUTE_MAX_N = 8192


class DFOperator:
    """Operator whose matrix is the exact three-word split ``(hi, lo, lo2)``
    of float64 data (:func:`df_split3`).

    ``inner`` is a :class:`~.operators.DiaOperator`,
    :class:`~.operators.DenseOperator` or :class:`~.operators.EllOperator`
    holding the high words; ``lo_data`` and ``lo2_data`` are the lower words
    in the same layout (for ELL: ``(n, L)``, as ``inner.val``).  ``mv`` is
    accurate to ~eps_df^2 of the float64 matrix.
    """

    def __init__(self, inner, lo_data: torch.Tensor, lo2_data: torch.Tensor):
        if not isinstance(inner, (DiaOperator, DenseOperator, EllOperator)):
            raise TypeError(f"a double-word operator holds a DIA, dense or "
                            f"ELL inner operator, not {type(inner).__name__}")
        self.inner = inner
        self.lo_data = lo_data
        self.lo2_data = lo2_data

    @property
    def n(self) -> int:
        return self.inner.n

    @property
    def nnz(self) -> int:
        return self.inner.nnz

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    @property
    def _words(self):
        inner = self.inner
        hi = (inner.data if isinstance(inner, DiaOperator)
              else inner.val if isinstance(inner, EllOperator) else inner.a)
        return hi, self.lo_data, self.lo2_data

    def diagonal(self) -> DF:
        hi, lo, lo2 = self._words
        if isinstance(self.inner, DiaOperator):
            d = self.inner.offsets.index(0)
            return DF(hi[d], lo[d] + lo2[d])
        if isinstance(self.inner, EllOperator):
            rows = torch.arange(self.n, device=hi.device)[:, None]
            hit = self.inner.idx == rows
            return DF(torch.where(hit, hi, 0.0).sum(1),
                      torch.where(hit, lo + lo2, 0.0).sum(1))
        return DF(torch.diagonal(hi), torch.diagonal(lo) + torch.diagonal(lo2))

    def mv(self, v: DF) -> DF:
        if isinstance(self.inner, DiaOperator):
            y = df_spmv.df_dia_spmv(self.inner.offsets, *self._words,
                                    (v.hi, v.lo))
        elif isinstance(self.inner, EllOperator):
            # the JAX package's gathered formulation: the dense plain
            # version's steps on the gathered vector words
            idx = self.inner.idx
            y = df_spmv._df_dense_mv_plain(*self._words, v.hi[idx],
                                           v.lo[idx])
        else:
            y = df_spmv.df_dense_spmv(*self._words, (v.hi, v.lo))
        return DF(*y)

    def mv2(self, v: DF, w: DF):
        pairs = ((v.hi, v.lo), (w.hi, w.lo))
        if isinstance(self.inner, DiaOperator):
            y, z = df_spmv.df_dia_spmv2(self.inner.offsets, *self._words,
                                        *pairs)
        elif isinstance(self.inner, EllOperator):
            return self.mv(v), self.mv(w)
        else:
            y, z = df_spmv.df_dense_spmv2(*self._words, *pairs)
        return DF(*y), DF(*z)

    def to(self, device):
        return DFOperator(self.inner.to(device),
                          self.lo_data.to(device).contiguous(),
                          self.lo2_data.to(device).contiguous())

    def tocsr(self):
        """Host float64 CSR of the whole matrix ``hi + lo + lo2`` (for the
        error probes' direct solve)."""
        low = (self.lo_data.detach().cpu().double()
               + self.lo2_data.detach().cpu().double())
        inner = self.inner
        if isinstance(inner, DiaOperator):
            lower = DiaOperator(inner.offsets, low)
        elif isinstance(inner, EllOperator):
            lower = EllOperator(low, inner.idx.cpu(), inner.nnz)
        else:
            lower = DenseOperator(low)
        return (inner.tocsr() + lower.tocsr()).tocsr()

    def todense(self):
        return self.tocsr().toarray()


def df_operator(A, fmt: str = "auto", device=None) -> DFOperator:
    """A :class:`DFOperator` on ``device`` (default: the CUDA card), its
    float64 data split on the host, exactly (:func:`df_split3`).

    Takes a :class:`~.sym_dia.SymDiaOperator` (its full two-triangle band,
    expanded on the host), a :class:`~.operators.DiaOperator`,
    :class:`~.operators.DenseOperator` or :class:`~.operators.EllOperator`,
    a scipy sparse matrix or :class:`~..matio.matrix_market.CooMatrix`, or
    a dense array.  Float32 data splits with zero low words.  Sparse input
    is built in ``fmt`` (``'dense' | 'dia' | 'ell' | 'auto'``); ``'auto'``
    follows :func:`~.operators.choose_format` with the JAX package's
    rewrites for the mode: ``block_banded`` becomes ``dense`` up to
    :data:`DF_DENSE_ROUTE_MAX_N` and ``ell`` above it, ``symdia`` and
    ``stencil`` become ``dia`` (the mode carries the full band)."""
    dev = resolve_device(device)
    if isinstance(A, DFOperator):
        return A.to(dev)
    if isinstance(A, (SymDiaOperator, DiaOperator)):
        offsets, data = (A.todia_host() if isinstance(A, SymDiaOperator)
                         else (A.offsets, A.data))
        hi, lo, lo2 = df_split3(data, device=dev)
        return DFOperator(DiaOperator(offsets, hi), lo, lo2)
    if isinstance(A, EllOperator):
        # in the original numbering (one restore of a locality order's
        # storage): the double-word ELL product has no kernel of its own
        val_t, idx_t = A._given()
        return _df_ell(val_t.T, idx_t, A.nnz, dev)
    if isinstance(A, DenseOperator):
        A = A.a
    if hasattr(A, "tocoo") and not isinstance(A, np.ndarray):
        A = coo_from_scipy(A)
    if isinstance(A, CooMatrix):
        return _df_from_coo(A, fmt, dev)
    if isinstance(A, (np.ndarray, torch.Tensor)) or hasattr(A, "__array__"):
        hi, lo, lo2 = df_split3(A, device=dev)
        return DFOperator(DenseOperator(hi), lo, lo2)
    raise TypeError(f"cannot build a double-word operator from {type(A)}")


def _df_ell(val, idx_t, nnz, dev) -> DFOperator:
    """The double-word ELL operator of ``(n, L)`` values and slot-major
    ``(L, n)`` indices; every word array is split and kept slot-major."""
    hi, lo, lo2 = df_split3(val.T, device=dev)
    return DFOperator(EllOperator(hi.T, torch.as_tensor(idx_t).to(dev).T,
                                  nnz), lo.T, lo2.T)


def _df_from_coo(coo, fmt, dev) -> DFOperator:
    if fmt == "auto":
        fmt = choose_format(coo)
        if fmt == "block_banded":
            fmt = "dense" if coo.shape[0] <= DF_DENSE_ROUTE_MAX_N else "ell"
        elif fmt in ("symdia", "stencil"):
            fmt = "dia"
    if fmt == "dense":
        hi, lo, lo2 = df_split3(build_dense(coo), device=dev)
        return DFOperator(DenseOperator(hi), lo, lo2)
    if fmt == "dia":
        offsets, data = build_dia(coo)
        hi, lo, lo2 = df_split3(data, device=dev)
        return DFOperator(DiaOperator(offsets, hi), lo, lo2)
    if fmt == "ell":
        val, idx, nnz = build_ell(coo)
        return _df_ell(val, idx.T, nnz, dev)
    raise ValueError(f"unknown format {fmt!r}")


class DFJacobi:
    """Jacobi preconditioner in double words: ``M^-1 v = inv_diag * v``."""

    def __init__(self, inv_diag: DF):
        self.inv_diag = inv_diag

    @classmethod
    def from_operator(cls, op: DFOperator):
        d = op.diagonal()
        one = torch.ones_like(d.hi)
        return cls(DF(one, torch.zeros_like(one)) / d)

    def apply(self, v: DF) -> DF:
        return self.inv_diag * v

    def to(self, device):
        return DFJacobi(self.inv_diag.to(device))


def _declines(self, *args, **kwargs):
    """No fused phase of this family has a double-word kernel: the family
    takes its generic body."""
    return None


class DoubleFloatContext:
    """Execution context of the double-word mode (single device).

    The family step bodies run unchanged: vector updates go through the
    :class:`DF` overloads, ``dots`` is :func:`df_dot` and ``mv`` the
    double-word product.  ``pipe_vector_phase`` runs the double-word vector
    phase (:func:`.df_spmv.df_pipe_vector_phase`, a kernel on the card); every
    other fused hook declines.
    """

    def __init__(self, op: DFOperator, precond=None):
        self.op = op
        self.precond = precond
        #: as :attr:`..solvers.context.Context.extra_norm`
        self.extra_norm = None

    @property
    def has_prec(self) -> bool:
        return self.precond is not None

    def mv(self, v):
        return self.op.mv(v)

    def mv2(self, v, w):
        return self.op.mv2(v, w)

    def prec(self, v):
        return self.precond.apply(v) if self.precond is not None else v

    def dots(self, *pairs):
        return tuple(df_dot(a, b) for (a, b) in pairs)

    def norm(self, v):
        (sq,) = self.dots((v, v))
        return torch.sqrt(torch.abs(sq.value()))

    def mv_dots(self, v, pairs):
        d = self.dots(*pairs)
        return self.mv(v), d

    def mv2_dots(self, v, w, pairs):
        d = self.dots(*pairs)
        y, z = self.mv2(v, w)
        return y, z, d

    def pipe_vector_phase(self, x, r, w, u, p, s, a1, beta):
        a1, beta = x._coerce(a1), x._coerce(beta)
        *vecs, dots = df_spmv.df_pipe_vector_phase(
            *((v.hi, v.lo) for v in (x, r, w, u, p, s)), (a1.hi, a1.lo),
            (beta.hi, beta.lo))
        return (*(DF(*v) for v in vecs), tuple(DF(*d) for d in dots))

    (pipe_full_step, pr_full_step, cgcg_matvec_phase, gv_matvec_phase,
     hs_matvec_phase, pr_full_step_prec, cgcg_matvec_phase_prec,
     gv_matvec_phase_prec, pipe_full_step_prec,
     pipe_vector_phase_prec) = (_declines,) * 10
