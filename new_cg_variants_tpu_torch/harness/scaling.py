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

Here a "rank count" is a mesh size: a trial is a timed fixed-iteration run
of the variant's step loop on one device, or on every rank of a mesh of
``p`` (:func:`~..parallel.dist.make_mesh`: ranks ``[0, p)`` of the
process group, one process a device, as ``torchrun`` starts them; ranks
beyond ``p`` sit that size out).  Results are min-over-trials per
configuration, the reduction the reference's plot scripts apply
(``scaling_plots.py:53``, ``strong_scaling_plots.py:88``).

Timing protocol: each trial starts from ``x0 = 0`` and chains ``max_iter``
steps (on a mesh: ``max_iter // chunk_iters`` chunks of ``chunk_iters``),
the state of one step feeding the next; the warm-up trial is excluded; one
``torch.cuda.synchronize()`` per trial closes its timer on the card.  On
the card the steps are replays of captured CUDA graphs
(:mod:`..solvers.graphs`), on one device and on each rank of a mesh (the
collectives inside the graphs), as the JAX package jits its ``fori_loop``
chunk and its ``shard_map``: the warm-up trial captures them, every trial
replays them, in chunks of :data:`~..solvers.graphs.CHUNK` steps; on the
CPU each step is launched from the host.
Per-kernel breakdowns come from :mod:`..utils.profiling` traces, not from
host timers.
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


def _chained(ctx, init_fn, step_fn, b, x0, steps, replays, dev):
    """``one_trial() -> (seconds, state)``: the init, then ``steps``
    chained steps, the timer closed by one synchronize of ``dev``.  With a
    :class:`~..solvers.graphs.Runner` (``replays``) the first trial
    captures, and every later one loads its init state into the loop and
    replays; with ``None`` every step is launched from the host."""
    loop = None

    def one_trial():
        nonlocal loop
        s = init_fn(ctx, b, x0)
        if loop is not None:
            loop.load(s)
        t0 = time.perf_counter()
        if replays is None:
            for _ in range(steps):
                s = step_fn(ctx, s)
        else:
            if loop is None:  # the first trial captures
                loop = replays.start(ctx, step_fn, s, horizon=steps - 1)
                loop.advance(steps - 1)
            else:
                loop.advance(steps)
            s = loop.state()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, s

    return one_trial


def time_variant(
    variant,
    op,
    b,
    x_true=None,
    max_iter=1500,
    trials=3,
    mesh=None,
    partition="auto",
    preconditioner=None,
    dtype=None,
    chunk_iters=None,
    device=None,
):
    """Time ``trials`` fixed-iteration runs of a variant on ``device``
    (default: the CUDA card); min-over-trials.

    Returns a :class:`ScalingResult`.  ``op`` is any operator or matrix the
    solvers take, cast to ``dtype`` (a torch dtype or ``"f32x2"``) when
    given.  With ``mesh`` (:func:`~..parallel.dist.make_mesh`) every rank of
    it runs its part under ``partition`` (``dist_run``'s) for ``max_iter
    // chunk_iters`` (at least one) times ``chunk_iters`` steps (default
    ``max_iter``); a rank outside the mesh returns ``None``.
    """
    from ..solvers.api import prepare
    from ..solvers.graphs import runner

    dev = resolve_device(device)
    if mesh is None:
        # as run builds it: a block-banded operator, or ELL in a locality
        # order, steps in its reordered basis
        p = prepare(variant, op, b, preconditioner=preconditioner,
                    dtype=dtype, compensated=False, device=dev)
        ctx, init_fn, step_fn, b, x0 = p.ctx, p.init_fn, p.step_fn, p.b, p.x0
        steps = max_iter if chunk_iters is None \
            else (max_iter // chunk_iters) * chunk_iters

        def final_x(state):
            return p.x_out(state["x"]).detach().to("cpu",
                                                   torch.float64).numpy()

        n_devices, loop_dev = 1, dev
    else:
        from ..parallel.dist import _dist_chunked, _rank_device

        pieces = _dist_chunked(variant, op, b, mesh, partition,
                               preconditioner, dtype, dev)
        if pieces is None:
            return None
        local, final_x = pieces
        ctx, init_fn, step_fn = local.ctx, local.init_fn, local.step_fn
        b, x0 = local.b, local.x0
        chunk_iters = chunk_iters or max_iter
        steps = max(1, max_iter // chunk_iters) * chunk_iters
        n_devices, loop_dev = mesh.size(), _rank_device(mesh)
    one_trial = _chained(ctx, init_fn, step_fn, b, x0, steps,
                         runner(loop_dev, use_jit=steps > 0), loop_dev)

    # warm-up (kernel build and first launches) + timed trials
    _, state = one_trial()
    times = []
    for _ in range(trials):
        dt, state = one_trial()
        times.append(dt)

    x = final_x(state)
    err = float("nan")
    if x_true is not None:
        err = float(np.linalg.norm(x - np.asarray(x_true, dtype=np.float64)))

    return ScalingResult(
        variant=variant, n=int(x.shape[0]), max_iter=max_iter,
        n_devices=n_devices, times=times, error=err,
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
    variants x mesh sizes.

    A size ``p`` runs on ranks ``[0, p)`` of the process group (size 1: on
    rank 0 alone, single-device, as the JAX package runs it); under a
    launcher start as many processes as the largest size (``torchrun
    --nproc-per-node``), a larger size raises ``ValueError``.  Each rank
    returns the results of the sizes it took part in.

    ``problem``: ``'banded'`` (PETSc ex2a/ex2b model; the port's
    ``banded_model`` stores it half-band unless ``fmt`` says otherwise) or
    ``'spectrum'`` (mpi4py diagonal model).  Results saved one JSON per
    (variant, mesh) when ``data_dir`` given — the analog of the reference's
    per-trial ``.npy`` files (``scaling_tests.py:85-86``) — beside
    ``env_info.json``, all written by rank 0.
    """
    import torch.distributed as dist

    from ..matio.problems import banded_model, model_spectrum
    from ..parallel.dist import make_mesh

    dev = resolve_device(device)
    meshes = {int(p): None if int(p) == 1 else make_mesh(int(p), device=dev)
              for p in mesh_sizes}
    rank = dist.get_rank() if dist.is_initialized() else 0
    if problem == "banded":
        op, b, x_true = banded_model(n, device=dev, **problem_kwargs)
    elif problem == "spectrum":
        op, b, x_true = model_spectrum(n, device=dev, **problem_kwargs)
    else:
        raise ValueError(f"unknown problem {problem!r}")

    if data_dir is not None and rank == 0:
        from ..utils.env_info import write_env_info

        write_env_info(data_dir)

    results = []
    for p, mesh in meshes.items():
        if mesh is None and rank != 0:
            continue
        for variant in variants:
            res = time_variant(
                variant, op, b, x_true=x_true, max_iter=max_iter,
                trials=trials, mesh=mesh, preconditioner=preconditioner,
                dtype=dtype, device=dev,
            )
            if res is None:  # a rank beyond this size
                continue
            results.append(res)
            if verbose and rank == 0:
                print(
                    f"{variant:>14s} p={p}: best {res.best:.4f}s "
                    f"({res.time_per_iter*1e3:.3f} ms/iter), err {res.error:.3e}"
                )
            if data_dir is not None and rank == 0:
                save_result(res, data_dir)
    return results


def save_result(res: ScalingResult, data_dir):
    d = pathlib.Path(data_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{res.variant}_p{res.n_devices}_n{res.n}.json"
    path.write_text(json.dumps(res.to_dict(), indent=1))
    return path
