"""Solver API: history runs (experiments) and tolerance solves (production).

* :func:`run` — fixed iterations capturing per-iteration probe histories;
  output index 0 is the initial state and ``1..max_iter-1`` follow each
  iteration (``numerical_experiments/cg_variants/hs_cg.py:33-65``).
* :func:`solve` — convergence test with early exit, like PETSc ``KSPSolve``
  with norm types natural / unpreconditioned / preconditioned / none
  (``cg_impls/pipeprcg.c:112-136``).

This slice runs the four unpreconditioned pipe variants (``pipe_p_cg``,
``pipe_pr_cg``, ``pipe_p_m_cg``, ``pipe_pr_m_cg``) on a
:class:`~..ops.sym_dia.SymDiaOperator`; every other variant name of
:data:`VARIANT_NAMES`, a preconditioner and ``dtype="f32x2"`` raise
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..ops.sym_dia import SymDiaOperator
from ..probes.probes import resolve_probes
from .context import Context
from .engine import history_scan, tolerance_loop
from .families import FAMILIES, family_of

__all__ = ["run", "solve", "SolveResult", "VARIANT_NAMES"]

VARIANT_NAMES = tuple(
    f"{base}_{suffix}"
    for base in ("hs", "cg", "gv", "pr", "m", "pipe_p", "pipe_pr", "pipe_p_m", "pipe_pr_m")
    for suffix in ("cg", "pcg")
)


def _resolve(variant, preconditioner):
    key, prec_flag = family_of(variant)
    if key not in FAMILIES or prec_flag:
        raise NotImplementedError(
            f"variant {variant!r} is not ported yet; this slice runs "
            f"{sorted(k + '_cg' for k in FAMILIES)} (ROADMAP.md)")
    if preconditioner is not None:
        raise NotImplementedError("preconditioners are not ported yet")
    return FAMILIES[key]


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "f32x2":
        raise NotImplementedError(
            "dtype='f32x2' is not ported yet (ROADMAP.md, 'Compensated dots "
            "and f32x2')")
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _operator(A, dtype, device):
    if not isinstance(A, SymDiaOperator):
        raise NotImplementedError(
            f"operator type {type(A).__name__} is not ported yet; this slice "
            "takes SymDiaOperator (banded_model(fmt='symdia'), "
            "convert.operator_from_numpy)")
    op = A if A.device == device else A.to(device)
    dtype = _torch_dtype(dtype)
    return op if dtype is None or dtype == op.dtype else op.astype(dtype)


def _vector_dtype(op):
    """Solve-vector dtype: bf16 is a storage-only tier, vectors stay f32."""
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
    dtype=None,
    compensated=False,
    device=None,
):
    """Run ``max_iter`` iterations of a variant, capturing probe histories.

    Returns a dict with ``'name'``, ``'max_iter'``, ``'x'`` (the final
    iterate, a tensor on ``device``) and one ``(max_iter,)`` (or
    ``(max_iter, n)`` for vector probes) numpy array per probe.
    """
    dev = resolve_device(device)
    init_fn, step_fn = _resolve(variant, preconditioner)
    op = _operator(A, dtype, dev)
    b, x0 = _vectors(op, b, x0, dev)
    probe_fns = resolve_probes(probes)
    aux = {"b": b}
    if _needs_x_true(probe_fns):
        if x_true is None:
            x_true = _compute_x_true(op, b)
        aux["x_true"] = torch.as_tensor(x_true, dtype=b.dtype, device=dev)
    ctx = Context(op, compensated=compensated)
    final, hist = history_scan(ctx, init_fn, step_fn, probe_fns, b, x0,
                               max_iter, aux)
    output = {"name": variant, "max_iter": max_iter, "x": final["x"]}
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

    ``norm_type='none'`` runs exactly ``max_iter`` iterations with no
    convergence test and no host sync inside the loop (the scaling
    configuration, ``-ksp_norm_type none``).
    """
    dev = resolve_device(device)
    init_fn, step_fn = _resolve(variant, preconditioner)
    op = _operator(A, dtype, dev)
    b, x0 = _vectors(op, b, x0, dev)
    ctx = Context(op, compensated=compensated)
    s, k, nrm, tol = tolerance_loop(ctx, init_fn, step_fn, b, x0, max_iter,
                                    rtol, atol, norm_type)
    return SolveResult(
        x=s["x"],
        iterations=int(k),
        norm=float(nrm),
        converged=bool(norm_type == "none" or float(nrm) <= float(tol)),
    )
