#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``new_cg_variants_tpu_torch/csrc`` (with
``nvcc``, into the package's ignored ``_build/`` directory), then:

1. ``build``   — seconds spent building the kernels;
2. ``card``    — the card's name and power limit (``nvidia-smi``);
3. ``check``   — each kernel against its plain PyTorch version on the card,
   in float32 and float64, on O(1) random band data at the main path's shape
   (n = 655,360, k = 32) and at small ragged shapes (k = 8), every value held
   to its own componentwise scale, with the kernel's time (CUDA events), the
   plain version's time, the least time the card could take and, for the
   SpMV, one cuSPARSE CSR product as a yardstick;
4. ``main_f32`` — the main path: pipe-PR-CG, unpreconditioned, float32, on
   the PETSc k-banded model problem (n = 655,360, k = 32) in half-band
   storage, timed as ``bench.py`` times it (2 x 5000 chained iterations per
   trial, each trial restarting on a perturbed right-hand side, until the two
   fastest trials agree within 5%), plus ``solve(norm_type="none")``'s own
   ms/iter.  The launch counters must show 3 SpMV launches per init and one
   fused launch per iteration;
5. ``main_f64`` — the same problem in float64 for 25 iterations on the card
   and on the CPU (plain versions); the nu and alpha histories must agree to
   rtol 1e-10;
6. ``kernels`` — one JSON line over both kernels.

Every phase prints one JSON line.  Any failed check raises, and the script
exits nonzero; it also exits nonzero, printing no result, when no CUDA device
is available.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 655_360
K_BAND = 32
ITERS_PER_CHUNK = 5000
REPEATS = 2
MIN_TRIALS = 3
MAX_TRIALS = 8
SOLVE_ITERS = 5000
PROFILE_STEPS = 200
F64_ITERS = 25
F64_RTOL = 1e-10
SMALL_SHAPES = ((4099, 8), (100, 8))
# Componentwise error bounds, kernel against plain version.  Both sum the
# same terms in another order (and the kernel contracts multiply-adds into
# FMAs), so each value differs by a few units of rounding of its own scale:
# (|A| |v|)_i for a product, |a| + |c| |b| for an update a + c b (carried
# through the fused step), sum |a_i b_i| for a dot product.  The checked band
# holds O(1) random values, so every row carries all its terms at one scale
# and no few rows set it: a kernel that dropped the mirror term or misplaced
# one diagonal misses by about 1 in these units (PERF.md, Findings).
TOL = {"float32": 1e-5, "float64": 1e-12}
# Data-sheet peaks (NVIDIA H100, dense, no tensor cores)
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def memory_rate(name):
    """Device-memory bytes/s of the card, from its data sheet."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


def bound(nbytes, flops, dtype_name, rate):
    """Least time (ms) for the work, and which resource sets it."""
    t_bytes = nbytes / rate * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters):
    """Device time per call of ``fn``, from CUDA events.

    A spin kernel holds the stream while the host enqueues the calls, so the
    events see the device's time for the calls back to back, not the host's
    pace of launching them.
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2.0 * host_s * iters + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cw_err(torch, got, want, scale):
    """Largest difference in units of each value's own scale."""
    tiny = torch.finfo(scale.dtype).tiny
    return float(((got - want).abs() / scale.clamp_min(tiny)).max())


def dot_err(torch, got, want, a, b):
    return float((got - want).abs() / torch.dot(a.abs(), b.abs()))


def random_band(torch, offsets, n, dtype, rng):
    """O(1) random half-band data, with explicit zeros past the matrix edge."""
    data = rng.uniform(-1.0, 1.0, (len(offsets), n))
    for d, off in enumerate(offsets):
        data[d, max(n - off, 0):] = 0.0
    return torch.as_tensor(data, dtype=dtype, device="cuda")


def pipe_step_scales(sd, offsets, data, vecs, a1, beta, recompute):
    """Componentwise scale of each fused-step output: the step on magnitudes."""
    x, r, w, u, p, s = (v.abs() for v in vecs)
    a1, beta, ad = a1.abs(), beta.abs(), data.abs()
    r2 = r + a1 * s
    w2 = w + a1 * u
    s2 = w2 + beta * s
    p2 = r2 + beta * p
    x2 = x + a1 * p
    u2 = sd._mv_plain(offsets, ad, s2)
    w_out = sd._mv_plain(offsets, ad, r2) if recompute else w2
    return x2, r2, w_out, p2, s2, u2


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def library_csr(torch, offsets, data):
    """The full matrix as a CUDA CSR tensor (yardstick only)."""
    n = data.shape[1]
    rows, cols, vals = [], [], []
    for d, off in enumerate(offsets):
        i = torch.arange(0, n - off, device=data.device)
        rows += [i] if off == 0 else [i, i + off]
        cols += [i] if off == 0 else [i + off, i]
        vals += [data[d, : n - off]] if off == 0 else [data[d, : n - off]] * 2
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (n, n))
    return coo.coalesce().to_sparse_csr()


def check_kernels(torch, card, timings):
    """Each kernel against its plain version; raises after all checks ran."""
    from new_cg_variants_tpu_torch.ops import sym_dia as sd
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    rate = memory_rate(card)
    shapes = ((N, K_BAND),) + SMALL_SHAPES
    outputs = ("x2", "r2", "w_out", "p2", "s2", "u2")
    failed = []
    for dtype in (torch.float32, torch.float64):
        dn = dtype_name(dtype)
        tol = TOL[dn]
        for n, k in shapes:
            rng = np.random.default_rng(n + k)
            offs = tuple(range(k))  # the stored offsets of banded_model
            data = random_band(torch, offs, n, dtype, rng)
            vec = [torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                   device="cuda") for _ in range(6)]
            main = (n, k) == (N, K_BAND) and dtype == torch.float32
            isz = data.element_size()

            # --- sym_dia_spmv / sym_dia_spmv2
            v, w = vec[0], vec[1]
            y = sd.sym_dia_spmv(offs, data, v)
            y2, z2 = sd.sym_dia_spmv2(offs, data, v, w)
            yp = sd._mv_plain(offs, data, v)
            zp = sd._mv_plain(offs, data, w)
            ys = sd._mv_plain(offs, data.abs(), v.abs())
            zs = sd._mv_plain(offs, data.abs(), w.abs())
            torch.cuda.synchronize()
            errs = [cw_err(torch, y, yp, ys), cw_err(torch, y2, yp, ys),
                    cw_err(torch, z2, zp, zs)]
            abs_err = max(float((g - want).abs().max())
                          for g, want in ((y, yp), (y2, yp), (z2, zp)))
            rec = dict(kernel="sym_dia_spmv", dtype=dn, n=n, k=k,
                       max_err=max(errs), max_abs_err=abs_err, tol=tol)
            if main:
                ms = time_ms(torch, lambda: sd.sym_dia_spmv(offs, data, v), 50)
                ms2 = time_ms(torch,
                              lambda: sd.sym_dia_spmv2(offs, data, v, w), 50)
                plain_ms = time_ms(torch, lambda: sd._mv_plain(offs, data, v), 5)
                csr = library_csr(torch, offs, data)
                lib_err = cw_err(torch, csr @ v, yp, ys)
                lib_ms = time_ms(torch, lambda: csr @ v, 50)
                del csr
                b_ms, b_by = bound((k + 2) * n * isz, 4 * k * n, dn, rate)
                b2_ms, _ = bound((k + 4) * n * isz, 8 * k * n, dn, rate)
                rec.update(ms=ms, spmv2_ms=ms2, plain_ms=plain_ms,
                           library_ms=lib_ms, library_err=lib_err,
                           bound_ms=b_ms, bound_by=b_by, spmv2_bound_ms=b2_ms)
                timings["sym_dia_spmv"] = rec
            emit("check", **rec)
            if not max(errs) <= tol:
                failed.append(rec)

            # --- fused_sym_pipe_full_step, recompute on and off
            a1 = torch.tensor(0.37, dtype=dtype, device="cuda")
            beta = torch.tensor(0.61, dtype=dtype, device="cuda")
            for recompute in (True, False):
                got = sf.fused_sym_pipe_full_step(offs, data, *vec, a1, beta,
                                                  recompute=recompute)
                want = sf._pipe_step_plain(offs, data, *vec, a1, beta,
                                           recompute)
                scales = pipe_step_scales(sd, offs, data, vec, a1, beta,
                                          recompute)
                torch.cuda.synchronize()
                verrs = [cw_err(torch, g, wv, sc)
                         for g, wv, sc in zip(got[:6], want[:6], scales)]
                _, r2, _, p2, s2, _, _ = want
                pairs = ((p2, s2), (r2, s2), (s2, s2), (r2, r2))
                derrs = [dot_err(torch, g, wv, a, b)
                         for g, wv, (a, b) in zip(got[6], want[6], pairs)]
                abs_err = max(float((g - wv).abs().max())
                              for g, wv in zip(got[:6], want[:6]))
                rec = dict(kernel="fused_sym_pipe_full_step", dtype=dn, n=n,
                           k=k, recompute=recompute, max_err=max(verrs),
                           err_by_output=dict(zip(outputs, verrs)),
                           max_dot_err=max(derrs), max_abs_err=abs_err,
                           tol=tol)
                if main and recompute:
                    ms = time_ms(torch, lambda: sf.fused_sym_pipe_full_step(
                        offs, data, *vec, a1, beta, recompute=True), 50)
                    plain_ms = time_ms(torch, lambda: sf._pipe_step_plain(
                        offs, data, *vec, a1, beta, True), 5)
                    b_ms, b_by = bound((k + 12) * n * isz, (8 * k + 18) * n,
                                       dn, rate)
                    rec.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                               bound_ms=b_ms, bound_by=b_by)
                    timings["fused_sym_pipe_full_step"] = rec
                emit("check", **rec)
                if not (max(verrs) <= tol and max(derrs) <= tol):
                    failed.append(rec)
            del data, vec
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{len(failed)} kernel checks disagree: {failed}")


def reset_counts():
    from new_cg_variants_tpu_torch.ops import sym_dia as sd
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    for fn in (sd.sym_dia_spmv, sd.sym_dia_spmv2, sf.fused_sym_pipe_full_step):
        fn.launches = 0


def read_counts():
    from new_cg_variants_tpu_torch.ops import sym_dia as sd
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    return {"sym_dia_spmv": sd.sym_dia_spmv.launches,
            "sym_dia_spmv2": sd.sym_dia_spmv2.launches,
            "fused_sym_pipe_full_step": sf.fused_sym_pipe_full_step.launches}


def profile_steps(torch, ctx, step_fn, state):
    """Device busy share and kernel time by name over PROFILE_STEPS steps.

    From ``torch.profiler``'s CUDA kernel events; ``None`` fields where the
    profiler saw no device activity (not measured).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = step_fn(ctx, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS - 1):
            state = step_fn(ctx, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        return {"steps": PROFILE_STEPS - 1, "device_busy_share": None}
    busy, end = 0.0, -1.0
    for a, z in sorted(spans):
        busy += max(0.0, z - max(a, end))
        end = max(end, z)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    steps = PROFILE_STEPS - 1
    return {"steps": steps, "wall_ms_per_iter": wall_us / steps / 1e3,
            "device_busy_ms_per_iter": busy / steps / 1e3,
            "device_busy_share": busy / wall_us,
            "kernels_per_iter": len(spans) / steps,
            "top_kernels_us_per_iter": {k[:60]: v / steps for k, v in top}}


def main_path_f32(torch, timings):
    from new_cg_variants_tpu_torch import banded_model, solve
    from new_cg_variants_tpu_torch.solvers.context import Context
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES

    op64, b64, x_true = banded_model(N, k=K_BAND, fmt="symdia", device="cpu")
    op = op64.astype(torch.float32).to("cuda")
    b = torch.as_tensor(b64, dtype=torch.float32, device="cuda")
    init_fn, step_fn = FAMILIES["pipe_pr"]
    ctx = Context(op)

    def chunk(s):
        for _ in range(ITERS_PER_CHUNK):
            s = step_fn(ctx, s)
        return s

    reset_counts()
    state = chunk(init_fn(ctx, b, torch.zeros_like(b)))
    float(state["nu"])
    times, inits = [], 1
    for trial in range(MAX_TRIALS):
        s = init_fn(ctx, b * (1.0 + 1e-6 * (trial + 1)), torch.zeros_like(b))
        inits += 1
        float(s["nu"])  # drain init before the timer
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            s = chunk(s)
        nu_final = float(s["nu"])
        times.append(time.perf_counter() - t0)
        if len(times) >= MIN_TRIALS:
            t1, t2 = sorted(times)[:2]
            if t2 <= 1.05 * t1:
                break
    ms_per_iter = min(times) / (REPEATS * ITERS_PER_CHUNK) * 1e3
    solve_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(op, b, variant="pipe_pr_cg", max_iter=SOLVE_ITERS,
                    norm_type="none", device="cuda")
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) / SOLVE_ITERS * 1e3)
        inits += 1
    profile = profile_steps(torch, ctx, step_fn, init_fn(ctx, b, res.x))
    inits += 1
    counts = read_counts()

    steps = (ITERS_PER_CHUNK * (1 + REPEATS * len(times)) + 2 * SOLVE_ITERS
             + PROFILE_STEPS)
    want = {"sym_dia_spmv": 3 * inits, "sym_dia_spmv2": 0,
            "fused_sym_pipe_full_step": steps}
    x = res.x
    resid = float(torch.linalg.norm(b - op.mv(x)) / torch.linalg.norm(b))
    fwd = float(torch.linalg.norm(x.double().cpu() - torch.from_numpy(x_true))
                / np.linalg.norm(x_true))
    kernel_ms = timings["fused_sym_pipe_full_step"]["ms"]
    emit("main_f32", variant="pipe_pr_cg", n=N, k=K_BAND,
         ms_per_iter=ms_per_iter, trial_seconds=times,
         solve_ms_per_iter=solve_ms, fused_kernel_ms=kernel_ms,
         fused_kernel_share_of_step=kernel_ms / ms_per_iter, profile=profile,
         nu_final=nu_final, rel_residual=resid, rel_forward_error=fwd,
         launches=counts, expected_launches=want)
    if not (np.isfinite(nu_final) and nu_final > 0):
        raise AssertionError(f"nu at the end is {nu_final}: diverged")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not (np.isfinite(resid) and bool(torch.isfinite(x).all())):
        raise AssertionError("non-finite solution")
    return counts


def main_path_f64(torch):
    from new_cg_variants_tpu_torch import banded_model, run

    op64, b64, _ = banded_model(N, k=K_BAND, fmt="symdia", device="cpu")
    kw = dict(max_iter=F64_ITERS + 1, probes=("nu", "alpha"),
              dtype=torch.float64)
    reset_counts()
    gpu = run("pipe_pr_cg", op64, b64, device="cuda", **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    cpu = run("pipe_pr_cg", op64, b64, device="cpu", **kw)
    errs = {p: float(np.max(np.abs(gpu[p] - cpu[p]) / np.abs(cpu[p])))
            for p in ("nu", "alpha")}
    emit("main_f64", variant="pipe_pr_cg", n=N, k=K_BAND, iterations=F64_ITERS,
         max_rel_diff=errs, rtol=F64_RTOL, launches=counts)
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(gpu[p], cpu[p], rtol=F64_RTOL)
    if counts["sym_dia_spmv"] != 3 or \
            counts["fused_sym_pipe_full_step"] != F64_ITERS:
        raise AssertionError(f"launch counts {counts}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from new_cg_variants_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(str(p.name) for p in paths.values()))
    for p in paths.values():
        log = p.with_suffix(".log").read_text()
        print("\n".join(ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln),
              file=sys.stderr)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    timings = {}
    check_kernels(torch, card, timings)
    counts = main_path_f32(torch, timings)
    main_path_f64(torch)

    sources = {
        "sym_dia_spmv": ("new_cg_variants_tpu_torch/csrc/sym_dia.cu",
                         "new_cg_variants_tpu/ops/sym_dia.py:47"),
        "fused_sym_pipe_full_step": (
            "new_cg_variants_tpu_torch/csrc/sym_fused.cu",
            "new_cg_variants_tpu/ops/sym_fused.py:184"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
