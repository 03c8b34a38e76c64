"""Execution context: how a solver step touches the operator.

The algorithm is written once against this small interface (``mv``,
``mv2``, ``prec``, ``dots``, ...); the context decides how each piece runs.
Step functions call ``dots`` once per synchronization phase with all the
inner products of that phase, which keeps each variant's sync structure
explicit (one phase per pipe iteration).
"""

from __future__ import annotations

import weakref

import torch

from ..ops import fused_family, fused_step, sym_fused
from ..ops._kernels import KERNEL_DTYPES
from ..ops.compensated import comp_dot
from ..ops.operators import DiaOperator
from ..ops.scalars import predict_nu, safe_div
from ..ops.sym_dia import SymDiaOperator
from ..utils.profiling import count
from .precond import IdentityPreconditioner, JacobiPreconditioner

__all__ = ["Context", "generic_pipe_vector_phase", "split_pipe_full_step",
           "with_torch_scalars"]


class Context:
    """Single-device execution context.

    ``compensated=True`` makes every inner product the error-free-transform
    dot (:func:`~..ops.compensated.comp_dot`, roughly twice the working
    precision) and every fused hook decline: the kernels' dots are plain
    sums.

    The fused-phase hooks (``hs_matvec_phase`` ... ``pipe_full_step_prec``,
    ``pipe_vector_phase_prec``) each run one family's phase through one
    kernel, or return ``None``, and the family then takes its generic body
    (``mv`` / ``mv2`` / ``prec`` / ``dots``).  Which it is follows from the
    operator's kind and the run's configuration alone, so it is the same on
    the CPU and on the card:

    * :class:`~..ops.sym_dia.SymDiaOperator`: every unpreconditioned hook
      applies (:mod:`..ops.sym_fused`; ``pipe_full_step`` forms the step's
      alpha and beta in the same launch, which no other operator's kernel
      does); a preconditioned one when the preconditioner is a
      :class:`~.precond.JacobiPreconditioner` (whose ``inv_diag`` the
      kernel applies) and no extra norm rides the dot batch
      (:attr:`extra_norm`, set by :func:`~.engine.tolerance_loop`).
    * :class:`~..ops.operators.DiaOperator` whose band qualifies
      (:func:`~..ops.fused_step.supports_full_step`, a function of the
      offsets): the same hooks under the same conditions, through the
      full-DIA kernel (:mod:`..ops.fused_step`, :mod:`..ops.fused_family`).
      On a wider band they return ``None`` and the pipe families take the
      split formulation: ``pipe_vector_phase`` (kernel), or
      ``pipe_vector_phase_prec`` (kernel; any preconditioner, when no norm
      rides the dot batch), then ``mv2`` / ``mv`` (kernel).
    * Any other operator (dense, ELL, stencil, block-banded): every hook
      returns ``None``, so every name runs its generic body over ``mv`` /
      ``mv2`` (on ELL one launch of ``csrc/ell_spmv.cu`` per product);
      the unpreconditioned pipe names take the split formulation with the
      vector-phase kernel, as on a wide band.

    ``pipe_vector_phase`` reads no operator: it takes the kernel unless the
    dots are compensated or the vectors are neither float32 nor float64.
    """

    def __init__(self, op, precond=None, compensated=False):
        self.op = op
        self.precond = precond
        self.compensated = compensated
        #: ``"r"`` or ``"rt"`` when a preconditioned tolerance solve needs
        #: ``r.r`` or ``rt.rt`` in each iteration's dot batch, else ``None``
        self.extra_norm = None

    @property
    def has_prec(self) -> bool:
        return self.precond is not None

    def graph_key(self):
        """What a captured step reads of this context, as a hashable key
        (:func:`~.graphs.capture_key`): the operator by weak reference, its
        attributes (a tensor by its address, shape, strides and dtype; a
        number, string or tuple by value), the preconditioner's kind,
        :attr:`compensated` and :attr:`extra_norm`.  ``None`` where that is
        not all a step reads: a preconditioner other than the identity (a
        Jacobi diagonal, an object, a callable), an operator attribute of
        another kind, or a subclass."""
        if type(self) is not Context or not (
                self.precond is None
                or type(self.precond) is IdentityPreconditioner):
            return None
        attrs = getattr(self.op, "__dict__", None)
        if attrs is None or type(self.op).__hash__ is None:
            return None
        attrs = _named(tuple(sorted(attrs.items())))
        if attrs is _UNNAMED:
            return None
        op = weakref.ref(self.op)
        return (op, attrs, type(self.precond), self.compensated,
                self.extra_norm)

    def mv(self, v):
        return self.op.mv(v)

    def mv2(self, v, w):
        return self.op.mv2(v, w)

    def prec(self, v):
        return self.precond.apply(v) if self.precond is not None else v

    def dots(self, *pairs):
        """Batch of inner products: one synchronization phase.

        Returns one 0-d tensor per ``(a, b)`` pair; nothing is read back to
        the host.
        """
        dot = comp_dot if self.compensated else torch.dot
        return tuple(dot(a, b) for (a, b) in pairs)

    def norm(self, v):
        (sq,) = self.dots((v, v))
        return torch.sqrt(sq)

    def mv_dots(self, v, pairs):
        """``(A v, dots(pairs))`` as one synchronization phase."""
        d = self.dots(*pairs)
        return self.mv(v), d

    def mv2_dots(self, v, w, pairs):
        """``(A v, A w, dots(pairs))`` as one synchronization phase."""
        d = self.dots(*pairs)
        y, z = self.mv2(v, w)
        return y, z, d

    @property
    def _sym(self) -> bool:
        return isinstance(self.op, SymDiaOperator)

    @property
    def _dia(self) -> bool:
        return isinstance(self.op, DiaOperator)

    def pipe_vector_phase(self, x, r, w, u, p, s, a1, beta):
        """Unpreconditioned pipe vector phase + its 4-dot batch, on any
        operator: one pass of the vector-phase kernel
        (:func:`~..ops.fused_step.fused_pipe_vector_phase`; on CPU tensors
        its plain version, the generic formulation's bits), or the generic
        formulation with compensated dots or vectors of a dtype the kernel
        does not take (:data:`~..ops._kernels.KERNEL_DTYPES`).  Counts
        ``vector_phases.kernel`` or ``vector_phases.generic``
        (:mod:`..utils.profiling`) each time the step's Python runs."""
        if not self.compensated and x.dtype in KERNEL_DTYPES:
            count("vector_phases.kernel")
            return fused_step.fused_pipe_vector_phase(x, r, w, u, p, s, a1,
                                                      beta)
        count("vector_phases.generic")
        return generic_pipe_vector_phase(self, x, r, w, u, p, s, a1, beta)

    def _fused(self, name, jacobi=False):
        """The one-pass kernel entry ``name`` of the operator's storage, or
        ``None`` when the operator has none (a dense operator, a full-DIA
        band wider than :func:`~..ops.fused_step.supports_full_step` admits),
        with compensated dots, or, for a ``jacobi`` entry (which applies
        ``inv_diag`` itself), when the preconditioner is another or a norm
        rides the dot batch."""
        if self.compensated:
            return None
        if jacobi and not (isinstance(self.precond, JacobiPreconditioner)
                           and self.extra_norm is None):
            return None
        if self._sym:
            return getattr(sym_fused, "fused_sym_" + name)
        if self._dia and fused_step.supports_full_step(self.op.offsets):
            module = fused_step if name.startswith("pipe_") else fused_family
            return getattr(module, "fused_" + name)
        return None

    def pipe_full_step(self, s_, meurant, recompute):
        """Whole unpreconditioned pipe-P/PR iteration with its scalars:
        beta from the state's predicted nu, the vector phase, dots and
        SpMV(s), alpha of the new dots.  Returns ``(x2, r2, w_out, p2, s2,
        u2, (mu, delta, gamma, nu), alpha, beta)``, or ``None`` (the caller
        then takes the split formulation, :func:`split_pipe_full_step`,
        between torch's scalars).  On half-band storage one launch forms
        the scalars too
        (:func:`~..ops.sym_fused.fused_sym_pipe_full_step_scalars`, counted
        ``scalar_epilogues.kernel``); on a full-DIA band torch forms them
        around the kernel's pass (:func:`with_torch_scalars`).
        """
        if self.compensated:
            return None
        if self._sym:
            count("scalar_epilogues.kernel")
            return sym_fused.fused_sym_pipe_full_step_scalars(
                self.op.offsets, self.op.data,
                s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
                s_["nu"], s_["delta"], s_["gamma"], s_["a"],
                meurant=meurant, recompute=recompute)
        fn = self._fused("pipe_full_step")
        if fn is None:
            return None

        def step(s_, a1, beta, recompute):
            return fn(self.op.offsets, self.op.data, s_["x"], s_["r"],
                      s_["w"], s_["u"], s_["p"], s_["s"], a1, beta,
                      recompute=recompute)

        return with_torch_scalars(step, s_, meurant, recompute)

    def pr_full_step(self, s_, a1, beta):
        """Whole unpreconditioned PR/Meurant iteration (beta is predicted,
        so x, r, p updates, ``s = A p`` and the 4 dots are one pass)."""
        fn = self._fused("pr_full_step")
        return fn and fn(
            self.op.offsets, self.op.data,
            s_["x"], s_["r"], s_["p"], s_["s"], a1, beta)

    def cgcg_matvec_phase(self, s_, a1):
        """Chronopoulos-Gear phase: x, r updates + ``w = A r`` + nu, eta."""
        fn = self._fused("cgcg_matvec_phase")
        return fn and fn(
            self.op.offsets, self.op.data,
            s_["x"], s_["r"], s_["p"], s_["s"], a1)

    def gv_matvec_phase(self, s_, a1):
        """GV phase: x, r, w updates + ``t = A w`` + nu, eta."""
        fn = self._fused("gv_matvec_phase")
        return fn and fn(
            self.op.offsets, self.op.data,
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"], a1)

    def hs_matvec_phase(self, rt, p, beta):
        """HS second sync phase: p update + ``s = A p`` + mu.

        Takes the (preconditioned) residual directly, so it serves hs_cg
        (rt = r) and hs_pcg with ANY preconditioner: HS's second phase
        never touches M.
        """
        fn = self._fused("hs_matvec_phase")
        return fn and fn(self.op.offsets, self.op.data, rt, p, beta)

    def pr_full_step_prec(self, s_, a1, beta):
        """Whole Jacobi-preconditioned PR/M iteration, PCApply included."""
        fn = self._fused("pr_full_step_prec", jacobi=True)
        return fn and fn(
            self.op.offsets, self.op.data, self.precond.inv_diag,
            s_["x"], s_["r"], s_["p"], s_["s"], s_["rt"], s_["st"], a1, beta)

    def cgcg_matvec_phase_prec(self, s_, a1):
        """Jacobi-preconditioned CG matvec phase (PCApply in the pass)."""
        fn = self._fused("cgcg_matvec_phase_prec", jacobi=True)
        return fn and fn(
            self.op.offsets, self.op.data, self.precond.inv_diag,
            s_["x"], s_["r"], s_["p"], s_["s"], a1)

    def gv_matvec_phase_prec(self, s_, a1):
        """Jacobi-preconditioned GV matvec phase (PCApply in the pass)."""
        fn = self._fused("gv_matvec_phase_prec", jacobi=True)
        return fn and fn(
            self.op.offsets, self.op.data, self.precond.inv_diag,
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
            s_["rt"], s_["st"], a1)

    def pipe_full_step_prec(self, s_, a1, beta, recompute):
        """Whole Jacobi-preconditioned pipe-P/PR iteration: vector phase,
        dots, both SpMVs and both PCApplies in one pass."""
        fn = self._fused("pipe_full_step_prec", jacobi=True)
        return fn and fn(
            self.op.offsets, self.op.data, self.precond.inv_diag,
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
            s_["rt"], s_["st"], s_["wt"], s_["ut"],
            a1, beta, recompute=recompute)

    def pipe_vector_phase_prec(self, s_, a1, beta):
        """Preconditioned pipe vector phase (8 updates + the 4-dot batch) in
        one kernel pass on full-DIA storage; the caller follows it with
        ``mv2`` / ``mv`` and the PCApplies.  The kernel never touches M, so
        any preconditioner qualifies; ``None`` when a norm rides the dot
        batch, the dots are compensated or the operator is of another
        kind."""
        if not self._dia or self.compensated or self.extra_norm is not None:
            return None
        return fused_step.fused_pipe_vector_phase_prec(
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
            s_["rt"], s_["st"], s_["wt"], s_["ut"], a1, beta)


#: what :func:`_named` answers for a value of another kind
_UNNAMED = object()


def _named(v):
    """A value as :meth:`Context.graph_key` names it: a tensor by its
    address, shape, strides, dtype and device, a number, string or ``None``
    as it is, a tuple by its items; else :data:`_UNNAMED`."""
    if isinstance(v, torch.Tensor):
        return (v.data_ptr(), v.shape, v.stride(), v.dtype, v.device)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, tuple):
        named = tuple(_named(x) for x in v)
        return _UNNAMED if any(x is _UNNAMED for x in named) else named
    return _UNNAMED


def generic_pipe_vector_phase(ctx, x, r, w, u, p, s, a1, beta):
    """Reference formulation of the pipe vector phase over any context."""
    x2 = x + a1 * p
    r2 = r - a1 * s
    w2 = w - a1 * u
    p2 = r2 + beta * p
    s2 = w2 + beta * s
    dots = ctx.dots((p2, s2), (r2, s2), (s2, s2), (r2, r2))
    return x2, r2, w2, p2, s2, dots


def with_torch_scalars(step, s_, meurant, recompute):
    """The pipe iteration ``step(s_, a1, beta, recompute)``, which returns
    its vectors and then its dots ``(mu, delta, gamma, nu)``, with its
    scalars formed by torch: ``beta = safe_div(predict_nu(...), nu)`` from
    the state before it, ``alpha = safe_div(nu2, mu2)`` after it
    (:mod:`..ops.scalars`).  Returns the step's outputs, then alpha and
    beta.  Counts ``scalar_epilogues.torch``."""
    count("scalar_epilogues.torch")
    beta = safe_div(predict_nu(s_["nu"], s_["delta"], s_["gamma"], s_["a"],
                               meurant), s_["nu"])
    *vecs, dots = step(s_, s_["a"], beta, recompute)
    return (*vecs, dots, safe_div(dots[3], dots[0]), beta)


def split_pipe_full_step(ctx, s_, a1, beta, recompute):
    """The pipe iteration as vector phase + ``mv2`` (or ``mv``): the split
    formulation, with the fused step's return order.  The pipe step takes it
    when :meth:`Context.pipe_full_step` declines (a wide full-DIA band, a
    dense operator), and the fused steps are tested against it."""
    x, r, w, p, s, dots = ctx.pipe_vector_phase(
        s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"], a1, beta,
    )
    if recompute:
        u, w = ctx.mv2(s, r)
    else:
        u = ctx.mv(s)
    return x, r, w, p, s, u, dots
