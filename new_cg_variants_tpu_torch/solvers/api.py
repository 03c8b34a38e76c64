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

``use_jit=True`` (the default) runs the iteration loop on the card as
replays of captured CUDA graphs (:mod:`.graphs`), as the JAX package runs it
under ``jax.jit``; the bits are the eager loop's.  ``use_jit=False``, and
every run on the CPU, launches each step's kernels from the host.

A block-banded operator holds the reordered system ``P A P^T``, and so does
an ELL operator in a locality order (the RCM order ``from_coo`` keeps);
both entry points solve in that basis
(:func:`~..ops.block_banded.solver_basis`): ``b``, ``x0`` and ``x_true`` are
permuted once per solve (on an ELL operator by row 12's gather in), every
product of the loop runs on the reordered storage with no permutation, and
``x`` and the vector probe rows come back in the original order and
dimension.  A preconditioner of a ``_pcg`` name on such an ELL operator
acts as in the JAX package's given-order ELL solve (:func:`resolve`):
Jacobi is the basis's diagonal, and any other object or callable sees
vectors in the original order (:class:`.precond.GivenOrderPreconditioner`);
on a block-banded operator it acts in the basis, as in the JAX package.

Every single-device entry point (:func:`run`, :func:`solve`, the scaling
harness's ``time_variant``) is built by :func:`prepare`; every tolerance
solve, on one device or a mesh, ends in :func:`solve_result`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import df_spmv
from ..ops.doublefloat import (
    DFJacobi,
    DFOperator,
    DoubleFloatContext,
    _host64,
    df_operator,
    df_split,
    df_split3,
)
from ..ops.block_banded import solver_basis
from ..ops.operators import EllOperator, as_operator, torch_dtype
from ..probes.probes import resolve_probes
from ..utils.profiling import span
from .context import Context
from . import graphs
from .engine import history_scan, host_value, tolerance_loop
from .families import FAMILIES, family_of, make_gv_step
from .precond import (
    GivenOrderPreconditioner,
    IdentityPreconditioner,
    JacobiPreconditioner,
    make_preconditioner,
)

__all__ = ["run", "solve", "SolveResult", "VARIANT_NAMES",
           "is_double_word", "prepare", "resolve", "solve_result"]

VARIANT_NAMES = tuple(
    f"{base}_{suffix}"
    for base in ("hs", "cg", "gv", "pr", "m", "pipe_p", "pipe_pr", "pipe_p_m", "pipe_pr_m")
    for suffix in ("cg", "pcg")
)


def is_double_word(dtype) -> bool:
    """Whether ``dtype`` names the double-word mode (``"f32x2"``)."""
    return isinstance(dtype, str) and dtype == "f32x2"


def loop_runner(dev, use_jit, w_replace, w_replace_init):
    """``(runner, w_replace)`` of a loop on ``dev``: the graph runner (or
    ``None``, the eager loop) and the hook as the loop calls it, checked
    to answer with a tensor under capture (:func:`.graphs.checked_hook`)."""
    hooked = w_replace is not None
    runner = graphs.runner(dev, use_jit, hooked=hooked)
    if runner is not None and hooked:
        w_replace = graphs.checked_hook(w_replace,
                                        stateful=w_replace_init is not None)
    return runner, w_replace


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


def resolve(variant, op, preconditioner, *, shard_local=False,
            w_replace=None, w_replace_init=None):
    """``(op, to_basis, from_basis, init_fn, step_fn, precond)`` of a
    solve of ``variant`` on ``op``: the operator in its basis
    (:func:`~..ops.block_banded.solver_basis`), the family's functions with
    the gv replacement hook wired in (:func:`_gv_replace_hooks`), and the
    preconditioner of a ``_pcg`` name (a ``_cg`` name ignores the spec).

    Single words: ``None`` is M = I (the reference's default
    ``preconditioner=lambda x: x``), else :func:`.precond.make_preconditioner`
    of the spec, cast to the solve's vector dtype on the operator's device.
    On an ELL operator in a locality order ``perm``, ``"jacobi"`` is the
    basis's diagonal, a :class:`.precond.JacobiPreconditioner` has its
    ``inv_diag`` gathered into the basis once, and any other object or
    callable sees and returns vectors in the original order
    (:class:`.precond.GivenOrderPreconditioner`), as in the JAX package's
    given-order ELL solve.  ``shard_local`` (a mesh of more than one rank)
    leaves those as they are: each rank applies them to its own rows, so
    they must act row by row (the identity, a pointwise function), as the
    JAX package's ``dist_run`` requires.  A block-banded operator's
    preconditioner acts in its basis, as in the JAX package.

    Double words (a :class:`~..ops.doublefloat.DFOperator`, its own basis):
    ``None`` or ``"identity"`` is M = I, ``"jacobi"`` the
    :class:`~..ops.doublefloat.DFJacobi` of its diagonal, a ``DFJacobi``
    moves to its device, and an object or callable maps double-word vectors
    as it is.  The hook's view holds double-word values: a policy on
    magnitudes collapses them with ``.value()``.
    """
    key, prec_flag = family_of(variant)
    init_fn, step_fn = _gv_replace_hooks(key, *FAMILIES[key], w_replace,
                                         w_replace_init)
    inner, to_basis, from_basis = solver_basis(op)
    spec = preconditioner
    if not prec_flag:
        precond = None
    elif isinstance(op, DFOperator):
        if spec is None or (isinstance(spec, str) and spec == "identity"):
            precond = IdentityPreconditioner()
        elif isinstance(spec, str) and spec == "jacobi":
            precond = DFJacobi.from_operator(op)
        elif isinstance(spec, DFJacobi):
            precond = spec.to(op.device)
        else:
            precond = make_preconditioner(spec, op)
    else:
        vdt = _vector_dtype(op)
        if (isinstance(op, EllOperator) and op.perm is not None
                and spec is not None
                and not isinstance(spec, (str, IdentityPreconditioner))):
            if isinstance(spec, JacobiPreconditioner):
                spec = JacobiPreconditioner(to_basis(
                    spec.inv_diag.to(device=op.device, dtype=vdt)))
            elif not shard_local:
                spec = GivenOrderPreconditioner(
                    make_preconditioner(spec, op), op.perm)
        precond = make_preconditioner(spec, inner)
        if precond is None:
            precond = IdentityPreconditioner()
        if hasattr(precond, "astype"):
            precond = precond.astype(vdt)
        if hasattr(precond, "to"):
            precond = precond.to(inner.device)
    return inner, to_basis, from_basis, init_fn, step_fn, precond


def _vector_dtype(op):
    """Solve-vector dtype of any operator (every one has ``dtype``): bf16 is
    a storage-only tier, vectors stay f32."""
    return torch.float32 if op.dtype == torch.bfloat16 else op.dtype


#: above this dimension the direct solve goes through scipy sparse LU
_SPARSE_SOLVE_MIN_N = 4096


def compute_x_true(op, b):
    """Host-side direct solve for the error probes (scipy, float64)."""
    b64 = np.asarray(torch.as_tensor(b).detach().cpu(), dtype=np.float64)
    if op.n >= _SPARSE_SOLVE_MIN_N:
        import scipy.sparse.linalg as spla

        return spla.spsolve(op.tocsr().tocsc(), b64)
    return np.linalg.solve(op.todense(), b64)


def needs_x_true(probe_fns):
    return any(name.startswith("error") for name in probe_fns)


def vectors(op, b, x0, device):
    """``b`` and ``x0`` (default zeros) in ``op``'s vector dtype on
    ``device``."""
    vdt = _vector_dtype(op)
    b = torch.as_tensor(b, dtype=vdt, device=device)
    x0 = (torch.zeros_like(b) if x0 is None
          else torch.as_tensor(x0, dtype=vdt, device=device))
    return b, x0


#: devices on which the double-word transforms have passed df_selfcheck
_DF_CHECKED = set()


def df_selfcheck(dev):
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


class Prepared(NamedTuple):
    """A single-device solve as :func:`prepare` builds it: ``b`` and ``x0``
    in its basis and words; ``x_out`` maps the final ``x`` to the original
    order (double words: ``hi + lo`` in float64), ``rows_out`` vector probe
    rows ``(T, n)``; ``aux_x_true`` places ``x_true`` (``None``:
    :func:`compute_x_true`) as the error probes read it."""

    ctx: object
    init_fn: Callable
    step_fn: Callable
    b: object
    x0: object
    x_out: Callable
    rows_out: Callable
    aux_x_true: Callable


def prepare(variant, A, b, x0=None, *, preconditioner, dtype, compensated,
            device, w_replace=None, w_replace_init=None):
    """The set-up of a single-device solve of ``variant`` on ``A`` for
    either word format, as a :class:`Prepared`.

    Single words: ``A`` as an operator in ``dtype`` on ``device``
    (:func:`~..ops.operators.as_operator`), ``b`` and ``x0`` in its vector
    dtype, moved into its basis with the preconditioner (:func:`resolve`),
    and a :class:`.context.Context` (``compensated``: error-free-transform
    dots).  ``dtype="f32x2"``: the double-word operator, ``b`` and ``x0``
    split exactly from float64, and a
    :class:`~..ops.doublefloat.DoubleFloatContext` (its dots are double-word
    already: ``compensated`` is not read), after the once-per-device
    :func:`df_selfcheck`.
    """
    dev = resolve_device(device)
    hooks = dict(w_replace=w_replace, w_replace_init=w_replace_init)
    if is_double_word(dtype):
        df_selfcheck(dev)
        op = df_operator(A, device=dev)
        given = _host64(b)
        b = df_split(given, device=dev)
        x0 = df_split(np.zeros(op.n) if x0 is None else _host64(x0),
                      device=dev)
        op_, _, from_basis, init_fn, step_fn, precond = resolve(
            variant, op, preconditioner, **hooks)
        ctx = DoubleFloatContext(op_, precond)

        def x_out(x):
            return x.value64()

        def place(x_true):
            # split too, so the error probes subtract in double words (a
            # single-word x_true would floor the error at float32 rounding)
            return df_split(_host64(x_true), device=dev)
    else:
        op = as_operator(A, dtype=torch_dtype(dtype), device=dev)
        given, x0 = vectors(op, b, x0, dev)
        # a block-banded operator, or ELL in a locality order: solve in its
        # reordered basis
        op_, to_basis, from_basis, init_fn, step_fn, precond = resolve(
            variant, op, preconditioner, **hooks)
        ctx = Context(op_, precond, compensated=compensated)
        b, x0 = to_basis(given), to_basis(x0)
        x_out = from_basis

        def place(x_true):
            return to_basis(torch.as_tensor(x_true, dtype=given.dtype,
                                            device=dev))

    def rows_out(h):
        # vector probe rows (T, n) of the basis (block-banded: padded)
        return from_basis(h.T).T if h.ndim == 2 and h.shape[1] == op_.n else h

    def aux_x_true(x_true):
        return place(compute_x_true(op, given) if x_true is None else x_true)

    return Prepared(ctx, init_fn, step_fn, b, x0, x_out, rows_out,
                    aux_x_true)


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
    use_jit=True,
    device=None,
):
    """Run ``max_iter`` iterations of a variant, capturing probe histories.

    Returns a dict with ``'name'``, ``'max_iter'``, ``'x'`` (the final
    iterate, a tensor on ``device``) and one ``(max_iter,)`` (or
    ``(max_iter, n)`` for vector probes) numpy array per probe.

    ``w_replace`` is the gv residual-replacement hook and ``w_replace_init``
    switches it to the stateful protocol (:func:`.families.make_gv_step`).
    Under ``use_jit=True`` on the card the hook is called at capture, with
    ``k`` a 0-d int64 device tensor, and must answer with a bool tensor (a
    Python answer raises ``TypeError``; ``use_jit=False`` branches in
    Python); a stateful hook's state rides the graph as device tensors.
    ``print_every=K`` prints a progress line every K iterations.

    ``dtype="f32x2"`` runs the whole solve in double-word arithmetic
    (:mod:`..ops.doublefloat`): ~48 significant bits from float32 words.
    Probe rows come back single-word; ``'x'`` is ``hi + lo`` in float64.

    ``use_jit=True`` runs the loop on the card as replays of captured
    chunks of steps (:mod:`.graphs`), the counterpart of the JAX package's
    ``jax.jit`` over ``lax.scan``, with the eager loop's bits; ``use_jit=
    False``, and any run on the CPU, launches every step from the host.
    """
    with span("solve"):
        dev = resolve_device(device)
        runner, w_replace = loop_runner(dev, use_jit, w_replace,
                                        w_replace_init)
        p = prepare(variant, A, b, x0, preconditioner=preconditioner,
                    dtype=dtype, compensated=compensated, device=dev,
                    w_replace=w_replace, w_replace_init=w_replace_init)
        probe_fns = resolve_probes(probes)
        aux = {"b": p.b}
        if needs_x_true(probe_fns):
            aux["x_true"] = p.aux_x_true(x_true)
        final, hist = history_scan(p.ctx, p.init_fn, p.step_fn, probe_fns,
                                   p.b, p.x0, max_iter, aux,
                                   print_every=print_every, runner=runner)
        output = {"name": variant, "max_iter": max_iter,
                  "x": p.x_out(final["x"])}
        for name in probe_fns:
            h = p.rows_out(hist[name])
            with span("readback", "host_syncs"):
                output[name] = h.cpu().numpy()
        return output


@dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    norm: float
    converged: bool


def solve_result(x, k, nrm, tol, norm_type):
    """The :class:`SolveResult` of a finished tolerance loop: ``nrm`` read
    back once, and ``tol`` once unless ``norm_type`` is ``'none'`` (which
    converges by definition), each read counted (:func:`.engine.host_value`)."""
    norm = host_value(nrm)
    converged = norm_type == "none" or norm <= host_value(tol)
    return SolveResult(x=x, iterations=int(k), norm=norm,
                       converged=bool(converged))


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
    use_jit=True,
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

    ``use_jit=True`` runs the loop on the card as replays of captured chunks
    of steps (:mod:`.graphs`), as the JAX package's ``jax.jit`` over
    ``lax.while_loop``: each chunk's norms are read back at once, one host
    sync a chunk (none with ``norm_type='none'``), and it stops at the
    eager loop's iteration with its bits.  ``use_jit=False``, and any solve
    on the CPU, launches every step from the host and reads the norm back
    once per iteration.
    """
    with span("solve"):
        dev = resolve_device(device)
        runner = graphs.runner(dev, use_jit)
        p = prepare(variant, A, b, x0, preconditioner=preconditioner,
                    dtype=dtype, compensated=compensated, device=dev)
        s, k, nrm, tol = tolerance_loop(p.ctx, p.init_fn, p.step_fn, p.b,
                                        p.x0, max_iter, rtol, atol,
                                        norm_type, runner=runner)
        return solve_result(p.x_out(s["x"]), k, nrm, tol, norm_type)
