"""Profiling: counters and spans of the solve loop, and the trace.

The port of the JAX package's ``utils/profiling.py``.  The reference's
tracing layer is (a) barrier-synchronized ``MPI.Wtime`` buckets around the
solver loop (``scaling_experiments_mpi4py/cg_variants/hs_cg.py:31-34,62-64``)
and (b) PETSc ``-log_view`` XML event timing parsed by
``strong_scaling_plots.py:43-59``.  On the card the per-kernel timeline
comes from ``torch.profiler`` (CUPTI), so this module provides:

* :func:`count` / :func:`counters` — a process-wide table of counters,
  always on, which the solve loop adds to where the work happens: host
  syncs, replays, captures, the capture pool's growth, the steps a
  tolerance solve takes back (the table below).
* :class:`span` — a named stretch of the program.  While a
  ``torch.profiler`` session records, it opens
  ``record_function(name, args="solve=<id> k=v ...")``: a host event on the
  profiler's clock, the timeline of the CUDA events, so that an idle gap of
  the card can be put down to the span around it.  (PyTorch 2.11 and 2.13
  keep the event's name and drop a string ``args``; there the nesting ties
  a span to its ``solve``.)  Given a counter, it adds one to it and its
  host seconds to ``<name>_s`` whether or not a profiler records.  With no
  profiler and no counter it costs one check.
* :func:`trace` — context manager around ``torch.profiler`` (host and CUDA
  activities) writing a Chrome trace (the ``-log_view`` analog), which
  :mod:`.trace_analysis` parses into per-phase times.

The counters (cumulative over the process; seconds are host seconds):

=====================  ====================================================
``solves``             loops started (``engine.tolerance_loop``,
                       ``engine.history_scan``)
``host_syncs``         reads that wait for the card (``readback`` spans),
                       ``readback_s`` their seconds
``replays``            graph launches (``replay`` spans), ``replay_s``
``captures``           graphs captured (one a chunk length a loop)
``capture_s``          seconds of capturing and instantiating them
``pool_bytes``         growth of the card's reserved memory over captures
``capture_hits``       loops that replay a stored loop's graphs
                       (``graphs.Store``) instead of capturing
``steps_taken_back``   steps of a chunk run and then discarded, where a
                       tolerance solve stopped inside it
``format``             ``format`` spans, ``format_s`` their seconds:
                       ``operators.choose_format``'s diagonal count and
                       the symmetry and stencil probes it leads to
``rcm``                ``rcm`` spans, ``rcm_s``: the reverse
                       Cuthill-McKee probe
                       (``block_banded._rcm_probe_full``), once a COO
``ell.pack``           ``ell.pack`` spans, ``ell.pack_s``: the ELL
                       storage's sort and packing (``build_ell``)
``basis_moves``        vectors moved into or out of an operator's
                       reordered basis (``block_banded.solver_basis``:
                       ELL in a locality order, block-banded), ``basis_s``
``vector_phases.*``    pipe vector phases ``Context.pipe_vector_phase``
                       built on the one-pass kernel (``.kernel``:
                       ``fused_step.fused_pipe_vector_phase``) or on the
                       generic body (``.generic``), counted when the
                       step's Python runs: each eager step and each
                       capture, never a replay of a captured graph
``scalar_epilogues.*`` pipe steps whose scalars (beta, alpha) the half-band
                       kernel formed (``.kernel``:
                       ``Context.pipe_full_step`` on half-band storage) or
                       torch (``.torch``: ``with_torch_scalars`` and the
                       preconditioned steps), counted as
                       ``vector_phases.*`` are
=====================  ====================================================

The spans: ``solve`` (``api.solve`` / ``api.run``), ``build``
(``ops.operators.from_coo``) with ``format``, ``rcm`` and ``ell.pack``
inside it (``format`` and ``rcm`` do not overlap), ``loop.start``
(``graphs.Runner.start``), ``capture``, ``replay`` and ``restore``
(``graphs.Loop``), ``readback``, ``basis``.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch
from torch.autograd.profiler import record_function

__all__ = ["count", "counters", "span", "trace", "trace_path"]

_COUNTS = {}
#: the ``solves`` value of the ``solve`` span that is open, while a
#: profiler records
_OPEN_SOLVE = [None]
_recording = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters():
    """A snapshot of every counter."""
    return dict(_COUNTS)


def _event(name, attrs):
    """The profiler's host event of a span, entered, and its solve's id."""
    solves = _COUNTS.get("solves", 0)
    sid = solves + 1 if name == "solve" else _OPEN_SOLVE[0] or solves
    args = " ".join([f"solve={sid}"] + [f"{k}={v}" for k, v in attrs.items()])
    event = record_function(name, args)
    event.__enter__()
    return event, sid


class span:
    """``with span(name, counter=None, **attrs):`` — see the module
    docstring.

    A ``solve`` span's id is the next value of ``solves`` (the loop inside
    counts it); the spans inside it carry that id."""

    __slots__ = ("name", "counter", "attrs", "_event", "_prev", "_t0")

    def __init__(self, name, counter=None, **attrs):
        self.name, self.counter, self.attrs = name, counter, attrs

    def __enter__(self):
        self._event = None
        if _recording():
            self._event, sid = _event(self.name, self.attrs)
            if self.name == "solve":
                self._prev, _OPEN_SOLVE[0] = _OPEN_SOLVE[0], sid
        if self.counter is not None:
            self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        if self.counter is not None:
            seconds = (_clock() - self._t0) * 1e-9
            count(self.counter)
            count(f"{self.name}_s", seconds)
        if self._event is not None:
            if self.name == "solve":
                _OPEN_SOLVE[0] = self._prev
            self._event.__exit__(*exc)


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
