"""Solver API: history runs (experiments) and tolerance solves (production).

* :func:`run` — fixed iterations capturing per-iteration probe histories;
  output index 0 is the initial state and ``1..max_iter-1`` follow each
  iteration (``numerical_experiments/cg_variants/hs_cg.py:33-65``).
* :func:`solve` — convergence test with early exit, like PETSc ``KSPSolve``
  with norm types natural / unpreconditioned / preconditioned / none
  (``cg_impls/pipeprcg.c:112-136``).

Every name of :data:`VARIANT_NAMES` (18: nine families, each with its
``_pcg`` twin) runs on any operator of the port (half-band, full-DIA, dense,
ELL, stencil, block-banded) and on what
:func:`~..ops.operators.as_operator` turns into one: a dense array, a scipy
sparse matrix or a :class:`~..matio.matrix_market.CooMatrix` (routed by the
auto format policy, :func:`~..ops.operators.choose_format`).  ``_pcg`` names
take ``preconditioner=None | "jacobi" | object with .apply | callable`` (a
``_cg`` name ignores it; a ``_pcg`` name without one runs with M = I).
``compensated=True`` makes every inner product an error-free-transform dot;
``dtype="f32x2"`` runs the whole solve in double words
(:mod:`..ops.doublefloat`).

A block-banded operator holds the reordered system ``P A P^T``; both entry
points solve in that basis (:func:`~..ops.block_banded.solver_basis`):
``b``, ``x0`` and ``x_true`` are permuted once per solve, and ``x`` and the
vector probe rows come back in the original order and dimension.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..ops import df_spmv
from ..ops.doublefloat import (
    DFJacobi,
    DoubleFloatContext,
    _host64,
    df_operator,
    df_split,
    df_split3,
)
from ..ops.block_banded import solver_basis
from ..ops.operators import as_operator, torch_dtype
from ..probes.probes import resolve_probes
from .context import Context
from .engine import history_scan, tolerance_loop
from .families import FAMILIES, family_of, make_gv_step
from .precond import IdentityPreconditioner, make_preconditioner

__all__ = ["run", "solve", "SolveResult", "VARIANT_NAMES",
           "is_double_word"]

VARIANT_NAMES = tuple(
    f"{base}_{suffix}"
    for base in ("hs", "cg", "gv", "pr", "m", "pipe_p", "pipe_pr", "pipe_p_m", "pipe_pr_m")
    for suffix in ("cg", "pcg")
)


def is_double_word(dtype) -> bool:
    """Whether ``dtype`` names the double-word mode (``"f32x2"``)."""
    return isinstance(dtype, str) and dtype == "f32x2"


def _gv_replace_hooks(key, init_fn, step_fn, w_replace, w_replace_init):
    """Wire the gv residual-replacement hook into (init_fn, step_fn).

    ``w_replace_init`` selects the stateful protocol: the step carries the
    hook's own state as the ``wrep`` entry of the solver state (the
    reference's mutable ``wk_replace_flags`` dict, gv_cg.py:40).
    """
    if key != "gv" or w_replace is None:
        return init_fn, step_fn
    stateful = w_replace_init is not None
    step_fn = make_gv_step(w_replace, stateful=stateful)
    if stateful:
        base_init = init_fn

        def init_fn(ctx, b, x0):
            st = base_init(ctx, b, x0)
            st["wrep"] = w_replace_init
            return st

    return init_fn, step_fn


def _resolve(variant, op, preconditioner, w_replace=None,
             w_replace_init=None):
    """``(init_fn, step_fn, precond)`` of a variant name on operator ``op``;
    the preconditioner in the solve's vector dtype on the operator's device.
    """
    key, prec_flag = family_of(variant)
    init_fn, step_fn = FAMILIES[key]
    init_fn, step_fn = _gv_replace_hooks(key, init_fn, step_fn, w_replace,
                                         w_replace_init)
    precond = make_preconditioner(preconditioner if prec_flag else None, op)
    if prec_flag and precond is None:
        # a *_pcg variant with no preconditioner given degrades to M = I,
        # like the reference's default `preconditioner=lambda x: x`
        precond = IdentityPreconditioner()
    if precond is not None:
        if hasattr(precond, "astype"):
            precond = precond.astype(_vector_dtype(op))
        if hasattr(precond, "to"):
            precond = precond.to(op.device)
    return init_fn, step_fn, precond


def _operator(A, dtype, device):
    return as_operator(A, dtype=torch_dtype(dtype), device=device)


def _vector_dtype(op):
    """Solve-vector dtype of any operator (every one has ``dtype``): bf16 is
    a storage-only tier, vectors stay f32."""
    return torch.float32 if op.dtype == torch.bfloat16 else op.dtype


#: above this dimension the direct solve goes through scipy sparse LU
_SPARSE_SOLVE_MIN_N = 4096


def _compute_x_true(op, b):
    """Host-side direct solve for the error probes (scipy, float64)."""
    b64 = np.asarray(torch.as_tensor(b).detach().cpu(), dtype=np.float64)
    if op.n >= _SPARSE_SOLVE_MIN_N:
        import scipy.sparse.linalg as spla

        return spla.spsolve(op.tocsr().tocsc(), b64)
    return np.linalg.solve(op.todense(), b64)


def _needs_x_true(probe_fns):
    return any(name.startswith("error") for name in probe_fns)


def _vectors(op, b, x0, device):
    vdt = _vector_dtype(op)
    b = torch.as_tensor(b, dtype=vdt, device=device)
    x0 = (torch.zeros_like(b) if x0 is None
          else torch.as_tensor(x0, dtype=vdt, device=device))
    return b, x0


def run(
    variant,
    A,
    b,
    x0=None,
    max_iter=100,
    preconditioner=None,
    probes=("updated_residual_2_norm",),
    x_true=None,
    w_replace=None,
    w_replace_init=None,
    dtype=None,
    compensated=False,
    print_every=0,
    device=None,
):
    """Run ``max_iter`` iterations of a variant, capturing probe histories.

    Returns a dict with ``'name'``, ``'max_iter'``, ``'x'`` (the final
    iterate, a tensor on ``device``) and one ``(max_iter,)`` (or
    ``(max_iter, n)`` for vector probes) numpy array per probe.

    ``w_replace`` is the gv residual-replacement hook and ``w_replace_init``
    switches it to the stateful protocol (:func:`.families.make_gv_step`).
    ``print_every=K`` prints a progress line every K iterations.

    ``dtype="f32x2"`` runs the whole solve in double-word arithmetic
    (:mod:`..ops.doublefloat`): ~48 significant bits from float32 words.
    Probe rows come back single-word; ``'x'`` is ``hi + lo`` in float64.
    """
    dev = resolve_device(device)
    if is_double_word(dtype):
        return _run_df(variant, A, b, x0, max_iter, preconditioner, probes,
                       x_true, print_every, w_replace, w_replace_init, dev)
    op = _operator(A, dtype, dev)
    b, x0 = _vectors(op, b, x0, dev)
    probe_fns = resolve_probes(probes)
    if _needs_x_true(probe_fns) and x_true is None:
        x_true = _compute_x_true(op, b)
    # a block-banded operator: solve in its reordered basis
    op, to_basis, from_basis = solver_basis(op)
    b, x0 = to_basis(b), to_basis(x0)
    init_fn, step_fn, precond = _resolve(variant, op, preconditioner,
                                         w_replace, w_replace_init)
    aux = {"b": b}
    if _needs_x_true(probe_fns):
        aux["x_true"] = to_basis(
            torch.as_tensor(x_true, dtype=b.dtype, device=dev))
    ctx = Context(op, precond, compensated=compensated)
    final, hist = history_scan(ctx, init_fn, step_fn, probe_fns, b, x0,
                               max_iter, aux, print_every=print_every)
    output = {"name": variant, "max_iter": max_iter,
              "x": from_basis(final["x"])}
    for name in probe_fns:
        h = hist[name]
        if h.ndim == 2 and h.shape[1] == op.n:
            h = from_basis(h.T).T  # vector probe rows, original order
        output[name] = h.cpu().numpy()
    return output


def _df_pieces(variant, A, b, x0, preconditioner, dev, w_replace=None,
               w_replace_init=None):
    """The double-word mode's operator, right-hand side, initial guess,
    family functions and preconditioner on ``dev``.

    A ``_pcg`` name takes ``None`` or ``"identity"`` (M = I), ``"jacobi"``
    (a :class:`~..ops.doublefloat.DFJacobi` of the operator's diagonal), a
    ``DFJacobi``, an object with ``.apply`` or a callable; the last two map
    double-word vectors to double-word vectors and are used as they are.
    """
    _df_selfcheck(dev)
    op = df_operator(A, device=dev)
    b_df = df_split(_host64(b), device=dev)
    x0_df = df_split(np.zeros(op.n) if x0 is None else _host64(x0),
                     device=dev)
    key, prec_flag = family_of(variant)
    init_fn, step_fn = FAMILIES[key]
    # the replacement hook's view holds double-word values here: a policy
    # that looks at magnitudes collapses them with .value()
    init_fn, step_fn = _gv_replace_hooks(key, init_fn, step_fn, w_replace,
                                         w_replace_init)
    precond = None
    if prec_flag:
        spec = preconditioner
        if spec is None or (isinstance(spec, str) and spec == "identity"):
            precond = IdentityPreconditioner()
        elif isinstance(spec, str) and spec == "jacobi":
            precond = DFJacobi.from_operator(op)
        elif isinstance(spec, DFJacobi):
            precond = spec.to(dev)
        else:
            precond = make_preconditioner(spec, op)
    return op, b_df, x0_df, init_fn, step_fn, precond


#: devices on which the double-word transforms have passed _df_selfcheck
_DF_CHECKED = set()


def _df_selfcheck(dev):
    """Once per device: the error words of a double-word product survive.

    A tiny three-word DIA product through the path every double-word product
    takes on ``dev`` (the kernel of ``csrc/df_spmv.cu`` on the card, the
    plain version on the CPU) whose exact results need both words: row 0
    needs 2Sum's error word (1 + 2^-30 (1 + 2^-12)), row 1 2Prod's ((1 +
    2^-12)^2 = 1 + 2^-11 + 2^-24).  Arithmetic that contracts a multiply and
    an add, or flushes a word, loses one of them; the mode would then run at
    single precision while looking plausible, so this raises.
    """
    if str(dev) in _DF_CHECKED:
        return
    c = 1.0 + 2.0 ** -12
    band = df_split3(np.array([[1.0, c], [2.0 ** -30, 0.0]]), device=dev)
    v = df_split(np.array([1.0, c]), device=dev)
    yh, yl = df_spmv.df_dia_spmv((0, 1), *band, (v.hi, v.lo))
    got = (yh.double() + yl.double()).cpu().numpy()
    want = np.array([1.0 + 2.0 ** -30 * c, c * c])
    if not (np.array_equal(got, want) and bool((yl != 0).all())):
        raise RuntimeError(
            f"the double-word error words did not survive on {dev}: got "
            f"{got.tolist()} (low words {yl.tolist()}), expected "
            f"{want.tolist()}; dtype='f32x2' would collapse to single "
            "precision")
    _DF_CHECKED.add(str(dev))


def _run_df(variant, A, b, x0, max_iter, preconditioner, probes, x_true,
            print_every, w_replace, w_replace_init, dev):
    """Fixed-iteration history run in double-word arithmetic."""
    op, b_df, x0_df, init_fn, step_fn, precond = _df_pieces(
        variant, A, b, x0, preconditioner, dev, w_replace, w_replace_init)
    probe_fns = resolve_probes(probes)
    aux = {"b": b_df}
    if _needs_x_true(probe_fns):
        if x_true is None:
            x_true = _compute_x_true(op, _host64(b))
        # split too, so the error probes subtract in double words (a
        # single-word x_true would floor the error at float32 rounding)
        aux["x_true"] = df_split(_host64(x_true), device=dev)
    ctx = DoubleFloatContext(op, precond)
    final, hist = history_scan(ctx, init_fn, step_fn, probe_fns, b_df, x0_df,
                               max_iter, aux, print_every=print_every)
    output = {"name": variant, "max_iter": max_iter,
              "x": final["x"].value64()}
    for name in probe_fns:
        output[name] = hist[name].cpu().numpy()
    return output


@dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    norm: float
    converged: bool


def solve(
    A,
    b,
    variant="pipe_pr_cg",
    x0=None,
    rtol=1e-8,
    atol=0.0,
    max_iter=10_000,
    preconditioner=None,
    norm_type="natural",
    dtype=None,
    compensated=False,
    device=None,
):
    """Tolerance-driven solve with early exit (production path).

    ``norm_type``: ``'natural'`` tests sqrt(nu) from the iteration scalars;
    ``'unpreconditioned'`` the recurrence residual ||r||; ``'preconditioned'``
    ||M^-1 r||; ``'none'`` runs exactly ``max_iter`` iterations with no
    convergence test and no host sync inside the loop (the scaling
    configuration, ``-ksp_norm_type none``).  For an unpreconditioned
    variant the first three coincide.  ``dtype="f32x2"`` solves in double
    words (:func:`run`); ``x`` is then ``hi + lo`` in float64.
    """
    dev = resolve_device(device)
    if is_double_word(dtype):
        op, b, x0, init_fn, step_fn, precond = _df_pieces(
            variant, A, b, x0, preconditioner, dev)
        ctx = DoubleFloatContext(op, precond)
        s, k, nrm, tol = tolerance_loop(ctx, init_fn, step_fn, b, x0,
                                        max_iter, rtol, atol, norm_type)
        return SolveResult(
            x=s["x"].value64(), iterations=int(k), norm=float(nrm),
            converged=bool(norm_type == "none" or float(nrm) <= float(tol)))
    op = _operator(A, dtype, dev)
    b, x0 = _vectors(op, b, x0, dev)
    # a block-banded operator: solve in its reordered basis
    op, to_basis, from_basis = solver_basis(op)
    init_fn, step_fn, precond = _resolve(variant, op, preconditioner)
    ctx = Context(op, precond, compensated=compensated)
    s, k, nrm, tol = tolerance_loop(ctx, init_fn, step_fn, to_basis(b),
                                    to_basis(x0), max_iter, rtol, atol,
                                    norm_type)
    return SolveResult(
        x=from_basis(s["x"]),
        iterations=int(k),
        norm=float(nrm),
        converged=bool(norm_type == "none" or float(nrm) <= float(tol)),
    )
