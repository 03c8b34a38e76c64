"""Post-hoc trace analysis: the ``-log_view`` parsing analog.

The port of the JAX package's ``utils/trace_analysis.py``, retargeted at
``torch.profiler`` Chrome traces.  The reference times its PETSc runs with
``-log_view ::xml`` and *parses* the event tree into per-phase fractions
for its scaling plots (``scaling_experiments_petsc/strong_scaling_plots.py:
43-59`` reads the XML, buckets MatMult / VecDot / VecAXPY / PCApply, and
stacks them).  Here the event log is the trace that
:func:`new_cg_variants_tpu_torch.utils.profiling.trace` writes
(``<log_dir>/*.pt.trace.json``), and this module parses it back into the
same kind of per-phase table:

* :func:`load_trace_events` — newest ``*.trace.json[.gz]`` under a trace
  directory -> list of complete events (name, dur, category, lane).
* :func:`op_breakdown` — aggregate device events by kernel name: total
  time, call count, fraction.
* :func:`phase_breakdown` — bucket kernels into solver phases (spmv /
  dots+reductions / vector updates / collectives / other) via name
  patterns, mirroring the reference's MatMult / VecDot / VecAXPY /
  VecScatter buckets.
* :func:`format_table` — printable report.

Device events are the CUDA activity of the trace (categories ``kernel``,
``gpu_memcpy``, ``gpu_memset``).  A trace without any (a CPU run) falls back
to the outermost host operators (``cpu_op``), so the breakdown reflects the
plain versions' work, not the dispatch below it.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import defaultdict

__all__ = [
    "load_trace_events",
    "op_breakdown",
    "phase_breakdown",
    "format_table",
    "phase_of",
    "PHASE_PATTERNS",
    "PORT_KERNELS",
]

#: the port's CUDA kernels (``csrc/*.cu``) by stem, each with its phase: a
#: ``__global__`` function is ``<stem>_kernel`` and a C entry
#: ``<stem>..._f32|_f64``.  The names are distinct, so each kernel is put in
#: its own bucket (the JAX package's Pallas kernels show up as anonymous
#: custom calls and all fall into spmv): a kernel that computes a product,
#: alone or fused with its step's vector updates, is spmv; a vector phase
#: without a product (its dots ride along) is vector.
PORT_KERNELS = {
    "sym_dia": "spmv", "sym_family": "spmv", "dia_spmv": "spmv",
    "dia_family": "spmv", "df_dia": "spmv", "df_dense": "spmv",
    "ell_spmv": "spmv", "ell_gather": "spmv",
    "pipe_vector": "vector", "df_pipe": "vector",
}


def _port_stems(phase):
    """A pattern of the port kernels of ``phase``; a stem starts a word,
    so ``dia_spmv`` is not read inside ``sym_dia_spmv``."""
    stems = "|".join(s for s, p in PORT_KERNELS.items() if p == phase)
    return rf"(?<!\w)(?:{stems})"


# Solver-phase buckets <- kernel-name patterns, first match wins.  Mirrors
# the reference's PETSc event buckets: MatMult -> spmv, VecDot/VecMDot +
# MPI_Allreduce -> dots, VecAXPY-class -> vector, VecScatter -> comm.  The
# port's kernels come first, by name (the JAX version's round-3 lesson: time
# fell into "other" while only the Python-side names matched); the spmv
# bucket also takes the products torch computes for the operators without a
# kernel of their own (dense: cuBLAS gemv/gemm; stencil: a scan;
# block-banded permutations: gathers).  Collectives come before dots, whose
# pattern would take "AllReduce"; a gemv or gemm kernel's name starts the
# word (cuBLAS's dot kernels carry "cublasGemvTensorStrided" in their
# template arguments).
PHASE_PATTERNS = [
    ("vector", re.compile(_port_stems("vector"))),
    ("spmv", re.compile(
        _port_stems("spmv") + r"|spmv|(?<![a-z])gemv|(?<![a-z])gemm|"
        r"cutlass|xmma|cusparse|"
        r"csrmv|gather|index_select|indexSelect|index_elementwise|scatter|"
        r"DeviceScan|scan_innermost|scan_outer|cumsum", re.I)),
    ("collectives", re.compile(
        r"nccl|all-reduce|all_reduce|allreduce|all-gather|all_gather|"
        r"allgather|reduce-scatter|reduce_scatter|sendrecv", re.I)),
    ("dots/reduce", re.compile(r"dot|reduce|norm|sum", re.I)),
    ("vector", re.compile(
        r"elementwise|fill|copy|memcpy|memset|add|sub|mul|div|axpy|where|"
        r"select|compare|broadcast|sqrt|abs|clamp|neg|cat", re.I)),
]

#: Chrome-trace categories of CUDA activity
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _newest_trace_file(log_dir: str) -> str:
    pats = [
        os.path.join(log_dir, "**", "*.trace.json.gz"),
        os.path.join(log_dir, "**", "*.trace.json"),
    ]
    hits: list[str] = []
    for p in pats:
        hits += glob.glob(p, recursive=True)
    if not hits:
        raise FileNotFoundError(f"no trace.json[.gz] under {log_dir}")
    return max(hits, key=os.path.getmtime)


def load_trace_events(log_dir: str) -> list[dict]:
    """All complete ('X') events of the newest trace under ``log_dir``.

    Each event keeps ``name``, ``dur`` (us), ``ts`` (us), ``cat`` (the
    profiler's category: ``kernel``, ``cpu_op``, ...), its ``lane`` (the
    process name) and ``thread`` (the thread or stream name), and ``pid`` /
    ``tid``.
    """
    path = _newest_trace_file(log_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    raw = doc["traceEvents"] if isinstance(doc, dict) else doc

    # metadata: pid/tid -> human lane names
    pnames: dict = {}
    tnames: dict = {}
    for ev in raw:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pnames[ev.get("pid")] = ev["args"].get("name", "")
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tnames[(ev.get("pid"), ev.get("tid"))] = ev["args"].get("name", "")

    out = []
    for ev in raw:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        pid, tid = ev.get("pid"), ev.get("tid")
        out.append({
            "name": ev.get("name", ""),
            "dur": float(ev["dur"]),
            "ts": float(ev.get("ts", 0.0)),
            "cat": ev.get("cat", ""),
            "lane": str(pnames.get(pid, "")),
            "thread": str(tnames.get((pid, tid), "")),
            "pid": pid,
            "tid": tid,
        })
    return out


def _outermost(events: list[dict]) -> list[dict]:
    """The events not nested in another of the same thread (a host
    operator's time covers the operators it calls)."""
    out = []
    by_thread: dict = defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e["dur"]
    return out


def _device_events(events: list[dict]) -> list[dict]:
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if dev:
        return dev
    return _outermost([e for e in events if e.get("cat") == "cpu_op"])


def op_breakdown(events: list[dict], top: int = 20) -> list[dict]:
    """Aggregate device events by kernel name, sorted by total time."""
    agg: dict = defaultdict(lambda: [0.0, 0])
    for e in _device_events(events):
        a = agg[e["name"]]
        a[0] += e["dur"]
        a[1] += 1
    total = sum(v[0] for v in agg.values()) or 1.0
    rows = [
        {"name": k, "total_us": v[0], "count": v[1], "frac": v[0] / total}
        for k, v in agg.items()
    ]
    rows.sort(key=lambda r: -r["total_us"])
    return rows[:top]


def phase_of(name: str) -> str:
    """The phase bucket of a kernel or operator name."""
    for phase, pat in PHASE_PATTERNS:
        if pat.search(name):
            return phase
    return "other"


def phase_breakdown(events_or_dir) -> dict:
    """Per-phase times and fractions (the reference's stacked-event
    analog), with the device events' count.

    Accepts a trace directory or a pre-loaded event list.  Kernels are
    assigned to the FIRST matching phase pattern; unmatched time lands in
    ``other``.
    """
    events = (
        load_trace_events(events_or_dir)
        if isinstance(events_or_dir, (str, os.PathLike))
        else events_or_dir
    )
    sums: dict = defaultdict(float)
    dev = _device_events(events)
    for e in dev:
        sums[phase_of(e["name"])] += e["dur"]
    total = sum(sums.values()) or 1.0
    return {
        "total_us": total,
        "events": len(dev),
        "phases": {k: {"us": v, "frac": v / total} for k, v in sorted(
            sums.items(), key=lambda kv: -kv[1])},
    }


def format_table(breakdown: dict) -> str:
    """Printable per-phase report (one line per phase)."""
    lines = [f"device time: {breakdown['total_us']/1e3:.3f} ms"]
    for phase, row in breakdown["phases"].items():
        lines.append(
            f"  {phase:<12s} {row['us']/1e3:10.3f} ms  {row['frac']*100:5.1f}%"
        )
    return "\n".join(lines)
