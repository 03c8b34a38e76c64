"""Profiling and derived performance metrics.

The port of the JAX package's ``utils/profiling.py``.  The reference's
tracing layer is (a) barrier-synchronized ``MPI.Wtime`` buckets around the
solver loop (``scaling_experiments_mpi4py/cg_variants/hs_cg.py:31-34,62-64``)
and (b) PETSc ``-log_view`` XML event timing parsed by
``strong_scaling_plots.py:43-59``.  On the card the per-kernel timeline
comes from ``torch.profiler`` (CUPTI), so this module provides:

* :func:`trace` — context manager around ``torch.profiler`` (host and CUDA
  activities) writing a Chrome trace (the ``-log_view`` analog), which
  :mod:`.trace_analysis` parses into per-phase times.
* :func:`derived_metrics` — nnz/s, GFLOP/s, effective bytes/s and
  time/iteration from a timed run.
* :class:`Timer` — accumulating wall timer whose :meth:`Timer.sync` waits
  for the card before the clock is read.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["trace", "trace_path", "derived_metrics", "Timer"]


def _activities():
    """Host activity always; CUDA where this torch build can trace it."""
    from torch.profiler import ProfilerActivity, supported_activities

    have = supported_activities()
    return [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in have]


def trace_path(log_dir: str) -> str:
    """Where :func:`trace` writes: ``<log_dir>/<host>_<pid>.<ms>.pt.trace.json``
    (the name ``torch.profiler.tensorboard_trace_handler`` gives)."""
    return os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}."
                 f"{int(time.time() * 1000)}.pt.trace.json")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace over the enclosed block, written as a Chrome
    trace under ``log_dir``; yields the profiler.  The card is synchronized
    before the profiler stops, so every kernel the block launched is in
    the trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = _activities()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if ProfilerActivity.CUDA in acts and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path(log_dir))


def derived_metrics(
    op, seconds: float, iterations: int, matvecs_per_iter: int = 1,
    dtype_bytes: int = 4,
) -> dict:
    """Throughput numbers for a timed fixed-iteration run.

    ``matvecs_per_iter``: 1 for hs/cg/gv/pr families, 2 for the
    recomputing pipelined variants (pipe_pr*, which apply A to both st
    and rt each iteration — ``cg_impls/pipeprcg.c:162-170``).
    """
    nnz = int(op.nnz)
    t_iter = seconds / max(iterations, 1)
    flops = 2.0 * nnz * matvecs_per_iter  # multiply+add per stored entry
    data_bytes = nnz * dtype_bytes * matvecs_per_iter
    return {
        "time_per_iter_s": t_iter,
        "nnz_per_s": nnz * matvecs_per_iter / t_iter,
        "gflops": flops / t_iter / 1e9,
        "spmv_gbytes_per_s": data_bytes / t_iter / 1e9,
    }


@dataclass
class Timer:
    """Accumulating wall timer.

    >>> t = Timer()
    >>> with t.measure():
    ...     out = step(...)          # launches return at once
    ...     t.sync(out["nu"])        # wait for the card, read the value
    """

    times: list = field(default_factory=list)
    _t0: float = 0.0

    @contextlib.contextmanager
    def measure(self):
        self._t0 = time.perf_counter()
        yield self
        self.times.append(time.perf_counter() - self._t0)

    @staticmethod
    def sync(x) -> float:
        """Wait for ``x``'s card (a CUDA tensor) and return ``x`` as a
        float."""
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return float(x.detach().cpu())
        return float(np.asarray(x))

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")
