"""Scaling-experiment harness: timed repeat solves with forward-error check.

The port of the JAX package's ``harness/scaling.py``, the analog of the
reference's two scaling harnesses:

* mpi4py: ``mpiexec -n P scaling_tests.py n max_iter trial`` builds the
  diagonal model problem, times 1500 fixed iterations per variant, and
  checks forward error against the known solution ``x* = 1/sqrt(n)``
  (``scaling_experiments_mpi4py/scaling_tests.py``).
* PETSc: ``mpirun ./ex2b -ksp_type ... -num_repeat 10`` on the k-banded
  model problem, min-over-trials timing parsed from ``-log_view``
  (``scaling_experiments_petsc/strong_scaling_tests.py``).

A trial is a timed fixed-iteration run of the variant's step loop on one
device; results are min-over-trials per configuration, the reduction the
reference's plot scripts apply (``scaling_plots.py:53``,
``strong_scaling_plots.py:88``).  **Single device only:** a mesh size above
1 raises ``NotImplementedError`` (ROADMAP item 7c).

Timing protocol: each trial starts from ``x0 = 0`` and chains ``max_iter``
steps, the state of one step feeding the next;
the warm-up trial is excluded; one ``torch.cuda.synchronize()`` per trial
closes its timer on the card.  Per-kernel breakdowns come from
:mod:`..utils.profiling` traces, not from host timers.
"""

from __future__ import annotations

import json
import pathlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["ScalingResult", "time_variant", "scaling_run", "save_result"]

#: what a multi-device request raises until the harness reaches the
#: distributed layer (``parallel/``)
MULTI_DEVICE_MESSAGE = (
    "multi-device scaling runs are not ported yet (ROADMAP item 7c); this "
    "harness runs one device")


@dataclass
class ScalingResult:
    variant: str
    n: int
    max_iter: int
    n_devices: int
    times: list = field(default_factory=list)  # seconds per trial
    error: float = float("nan")  # forward error ||x - x_true||

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")

    @property
    def time_per_iter(self) -> float:
        return self.best / self.max_iter

    def to_dict(self):
        return {
            "variant": self.variant, "n": self.n, "max_iter": self.max_iter,
            "n_devices": self.n_devices, "times": list(self.times),
            "best": self.best, "time_per_iter": self.time_per_iter,
            "error": self.error,
        }


def _pieces(variant, op, b, preconditioner, dtype, dev):
    """``(ctx, init_fn, step_fn, b, x0, x_out)`` of a variant's step loop on
    ``dev``, as :func:`~..solvers.api.run` builds them; ``x_out`` maps the
    final ``x`` to a single-word vector in the original order (a
    block-banded operator steps in its reordered basis)."""
    from ..ops.block_banded import solver_basis
    from ..ops.operators import as_operator, torch_dtype
    from ..solvers.api import (
        _df_pieces,
        _resolve,
        _vector_dtype,
        is_double_word,
    )
    from ..solvers.context import Context

    if is_double_word(dtype):
        from ..ops.doublefloat import DoubleFloatContext

        op, b, x0, init_fn, step_fn, precond = _df_pieces(
            variant, op, b, None, preconditioner, dev)
        return (DoubleFloatContext(op, precond), init_fn, step_fn, b, x0,
                lambda x: x.value64())
    op = as_operator(op, dtype=torch_dtype(dtype), device=dev)
    b = torch.as_tensor(b, dtype=_vector_dtype(op), device=dev)
    op, to_basis, from_basis = solver_basis(op)
    init_fn, step_fn, precond = _resolve(variant, op, preconditioner)
    return (Context(op, precond), init_fn, step_fn, to_basis(b),
            to_basis(torch.zeros_like(b)), from_basis)


def time_variant(
    variant,
    op,
    b,
    x_true=None,
    max_iter=1500,
    trials=3,
    mesh=None,
    preconditioner=None,
    dtype=None,
    device=None,
):
    """Time ``trials`` fixed-iteration runs of a variant on ``device``
    (default: the CUDA card); min-over-trials.

    Returns a :class:`ScalingResult`.  ``op`` is any operator or matrix the
    solvers take, cast to ``dtype`` (a torch dtype or ``"f32x2"``) when
    given.  ``mesh`` other than ``None`` raises ``NotImplementedError``
    (ROADMAP item 7c).
    """
    if mesh is not None:
        raise NotImplementedError(MULTI_DEVICE_MESSAGE)
    dev = resolve_device(device)
    ctx, init_fn, step_fn, b, x0, x_out = _pieces(
        variant, op, b, preconditioner, dtype, dev)

    def one_trial():
        s = init_fn(ctx, b, x0)
        t0 = time.perf_counter()
        for _ in range(max_iter):
            s = step_fn(ctx, s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, s

    # warm-up (kernel build and first launches) + timed trials
    _, state = one_trial()
    times = []
    for _ in range(trials):
        dt, state = one_trial()
        times.append(dt)

    x = x_out(state["x"]).detach().to("cpu", torch.float64).numpy()
    err = float("nan")
    if x_true is not None:
        err = float(np.linalg.norm(x - np.asarray(x_true, dtype=np.float64)))

    return ScalingResult(
        variant=variant, n=int(x.shape[0]), max_iter=max_iter, n_devices=1,
        times=times, error=err,
    )


def scaling_run(
    variants,
    problem="banded",
    n=65536,
    max_iter=1500,
    trials=3,
    mesh_sizes=(1,),
    preconditioner=None,
    dtype=None,
    data_dir=None,
    verbose=True,
    device=None,
    **problem_kwargs,
):
    """Run the scaling matrix on ``device`` (default: the CUDA card):
    variants x mesh sizes, where the only mesh size is 1 (a larger one
    raises ``NotImplementedError``, ROADMAP item 7c).

    ``problem``: ``'banded'`` (PETSc ex2a/ex2b model; the port's
    ``banded_model`` stores it half-band unless ``fmt`` says otherwise) or
    ``'spectrum'`` (mpi4py diagonal model).  Results saved one JSON per
    (variant, mesh) when ``data_dir`` given — the analog of the reference's
    per-trial ``.npy`` files (``scaling_tests.py:85-86``) — beside
    ``env_info.json``.
    """
    from ..matio.problems import banded_model, model_spectrum

    if any(int(p) != 1 for p in mesh_sizes):
        raise NotImplementedError(MULTI_DEVICE_MESSAGE)
    dev = resolve_device(device)
    if problem == "banded":
        op, b, x_true = banded_model(n, device=dev, **problem_kwargs)
    elif problem == "spectrum":
        op, b, x_true = model_spectrum(n, device=dev, **problem_kwargs)
    else:
        raise ValueError(f"unknown problem {problem!r}")

    if data_dir is not None:
        from ..utils.env_info import write_env_info

        write_env_info(data_dir)

    results = []
    for p in mesh_sizes:
        for variant in variants:
            res = time_variant(
                variant, op, b, x_true=x_true, max_iter=max_iter,
                trials=trials, preconditioner=preconditioner, dtype=dtype,
                device=dev,
            )
            results.append(res)
            if verbose:
                print(
                    f"{variant:>14s} p={p}: best {res.best:.4f}s "
                    f"({res.time_per_iter*1e3:.3f} ms/iter), err {res.error:.3e}"
                )
            if data_dir is not None:
                save_result(res, data_dir)
    return results


def save_result(res: ScalingResult, data_dir):
    d = pathlib.Path(data_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{res.variant}_p{res.n_devices}_n{res.n}.json"
    path.write_text(json.dumps(res.to_dict(), indent=1))
    return path
