"""One run of one cell: set-up, the measured window, the comparison with
the reference, the result line.

Set-up (``setup_s``) is everything before the window: imports, the
program's kernels (built into the package's ``_build/`` inside the checkout
where missing), the input and the operator (``build_s``), the right-hand
sides, and one warm-up call at the cell's shapes.  The window is a closed
loop of one caller for ``--seconds`` (the call running at the deadline
ends it).  With ``--trace 1`` the program's capture counters and host
spans are installed for the whole window (:mod:`.program_hooks`), and the
profiler traces its first ``trace_calls`` calls (the traced window).  After the window: the memory peak is read, the
program's state freed, and a sample of the answers, drawn from the seed,
judged against the reference (``checks/``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["main", "run", "judge", "Judge", "FORBIDDEN"]

#: top-level module names that must not be loaded when the window closes:
#: JAX and the JAX package (the port's name only begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "new_cg_variants_tpu")


def _parse(argv):
    ap = argparse.ArgumentParser(prog="h100_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _cache_dirs(root):
    """Fixed cache directories inside the checkout for whatever builds
    kernels through PyTorch's own machinery (the program's ``nvcc`` builds
    go to its package's ``_build/``)."""
    base = Path(root) / ".h100_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Judge:
    """What the checks read: the calls, the sampled answers, and the
    reference's float64 operator and solutions."""

    def __init__(self, cell, seed, calls, samples, matvec, n, pool, device):
        self.mix, self.config = cell.mix, cell.config
        self.calls, self.samples, self.matvec = calls, samples, matvec
        self._seed, self._n, self._pool, self._device = seed, n, pool, device

    def solution(self, i):
        from h100_bench import traffic

        return traffic.solution(self._seed, self._n, i % self._pool,
                                self._device)

    def rhs(self, i):
        return self.matvec(self.solution(i))


def judge(cell, reference, seed, calls, samples, n, pool_size, device):
    """Each check of the cell over the calls and the sampled answers:
    ``({name: {"value": worst, "limit": limit}}, calls that failed one,
    correct)``.  A NaN or infinite reading fails, and prints as null."""
    ctx = Judge(cell, seed, calls, samples, reference.matvec(cell.config,
                                                             device),
                n, pool_size, device)
    checks, bad_calls = {}, set()
    for name, limit, module in cell.checks():
        values = module.measure(ctx)
        bad_calls |= {i for i, v in values.items() if not v <= limit}
        worst = max(values.values()) if values else None
        if worst is not None and not math.isfinite(worst):
            worst = None
            bad_calls |= set(values)
        checks[name] = {"value": worst, "limit": limit}
    correct = bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return checks, bad_calls, correct


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(root, workload, seed, seconds, trace, t0=None, device=None,
        out=None, err=None):
    """Run the cell; print the result line to ``out``.  ``device=None``
    looks for the card (and fails without enough of them); a test passes a
    device to drive the same run elsewhere.  Returns the exit code."""
    out = out or sys.stdout
    err = err or sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    _cache_dirs(root)
    import torch

    from h100_bench import profiling, roofline, traffic
    from h100_bench.spec import Cell

    cell = Cell(root, workload)
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"h100_bench: workload {workload} needs {cell.chips} CUDA "
                  f"card(s); torch sees {have}", file=err)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg, mix = cell.config, cell.mix
    if mix.get("loop") != "closed" or int(mix.get("callers", 0)) != 1:
        raise ValueError(f"mix {cell.workload['traffic']}: the generator "
                         "drives a closed loop of one caller")
    problem, reference, entry = cell.problem(), cell.reference(), cell.entry()
    n = problem.size(cfg)

    # ---- set-up --------------------------------------------------------
    phases = {"imports": time.perf_counter() - t0}
    tp = time.perf_counter()
    inp = problem.program_input(cfg, device)
    sync()
    tb = time.perf_counter()
    phases["input"] = tb - tp
    op = problem.program_operator(cfg, inp, device)
    sync()
    build_s = phases["build"] = time.perf_counter() - tb
    del inp
    tp = time.perf_counter()
    ref_mv = reference.matvec(cfg, device)
    pool_size = int(mix["rhs_pool"])
    pool = traffic.rhs_pool(seed, n, pool_size, ref_mv, problem.dtype(cfg),
                            device)
    del ref_mv
    sync()
    phases["rhs"] = time.perf_counter() - tp
    tp = time.perf_counter()
    call = entry.prepare(op, mix, device)
    call(pool[0])
    sync()
    phases["warm-up"] = time.perf_counter() - tp
    setup_s = time.perf_counter() - t0
    print("setup seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in phases.items()),
          file=err)

    # ---- the window ----------------------------------------------------
    hooks = prof = span = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from h100_bench.program_hooks import Hooks

        hooks = Hooks()
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        span = record_function(profiling.WINDOW)
        span.__enter__()

    def stop_profile():
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)

    profiled = int(mix["trace_calls"]) if trace else 0
    sampler = traffic.Reservoir(int(mix["sample"]), seed)
    calls = []
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    try:
        while True:
            i = len(calls)
            ts = time.perf_counter()
            if trace:
                with record_function(profiling.CALL):
                    res = call(pool[i % pool_size])
            else:
                res = call(pool[i % pool_size])
            end = time.perf_counter()
            rec = {"i": i, "t0": ts, "t1": end,
                   "iterations": int(res.iterations),
                   "converged": bool(res.converged),
                   "profiled": i < profiled}
            if hooks is not None:
                rec["captures"] = len(hooks.captures)
                rec["capture_s"] = hooks.capture_seconds()
            calls.append(rec)
            sampler.offer(i, res.x)
            del res
            if len(calls) == profiled:
                stop_profile()
            if end >= deadline:
                break
    finally:
        if trace:
            if len(calls) < profiled:
                stop_profile()
            hooks.remove()
    window_s = end - start

    # ---- after the window ----------------------------------------------
    its = [c["iterations"] for c in calls]
    print(f"calls {len(calls)}: iterations {min(its)}-{max(its)} mean "
          f"{sum(its) / len(its):.1f}"
          + (f"; reserved {torch.cuda.memory_reserved(device) / 1e9:.3f} GB"
             if on_card else ""), file=err)
    bad_modules = forbidden_modules()
    if bad_modules:
        print("h100_bench: loaded in this process after the window: "
              + ", ".join(bad_modules), file=err)
        return 3
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    traced = None
    if trace:
        from torch.autograd import DeviceType

        traced = profiling.read(prof.events(), DeviceType.CUDA)
        del prof
    del call, op, pool
    if on_card:
        torch.cuda.empty_cache()

    checks, bad_calls, correct = judge(cell, reference, seed, calls,
                                       sampler.items, n, pool_size, device)

    vec_itemsize = roofline.itemsize(problem.dtype(cfg))
    obs = {
        "setup_s": setup_s, "build_s": build_s, "calls": calls,
        "window_s": window_s, "trace": traced,
        "step_bytes": roofline.step_bytes(mix["variant"], n,
                                          problem.operator_bytes(cfg),
                                          vec_itemsize),
        "peak_bytes_per_s": roofline.HBM_BYTES_PER_S,
    }
    metrics = {}
    for name, unit, reader in cell.metrics("per_layer" if trace
                                           else "end_to_end"):
        value = reader.read(obs)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if on_card:
        dev["power_limit"] = _power_limit()
    if trace:
        dev["busy_s"] = traced.busy_s if traced else 0.0
        dev["window_s"] = traced.window_s if traced else window_s
    result = {"correct": correct, "attempted": len(calls),
              "failed": len(bad_calls), "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced.device_ops,
                               "idle_gaps": traced.idle_gaps}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=err)
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv, root, t0=None):
    args = _parse(argv)
    return run(root, args.workload, args.seed, args.seconds, args.trace,
               t0=t0)
