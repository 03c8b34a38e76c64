#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``new_cg_variants_tpu_torch/csrc`` (with
``nvcc``, into the package's ignored ``_build/`` directory), then:

1. ``build``   — seconds spent building the kernels;
2. ``card``    — the card's name and power limit (``nvidia-smi``);
3. ``check``   — (``check_sym``) each kernel entry against its plain PyTorch
   version on the card, in float32 and float64, on O(1) random band data at
   the main path's shape (n = 655,360, k = 32), at small ragged shapes
   (k = 8), at the widest band the auto route stores half-band (n = 65,536,
   k = 128) and at a band wider than the matrix (n = 100, k = 128), every value
   held to its own componentwise scale, with the kernel's time (CUDA events),
   the plain version's time, the least time the card could take and, for the
   SpMV, one cuSPARSE CSR product as a yardstick.  The entries: the SpMV
   (1 and 2 right-hand sides) and the eleven entries of
   ``csrc/sym_family.cu`` (the pipe step and its Jacobi twin, each with
   recompute on and off; hs, pr, cgcg, gv and their Jacobi twins);
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
6. ``variants_f32`` — the other 16 variant names on the same full-width
   problem through ``solve(norm_type="none")`` for 300 iterations, ``_pcg``
   names with ``preconditioner="jacobi"``: ms/iter, a finite solution, and
   launch counters equal to what the family prescribes (its own fused entry
   once per iteration, the SpMV in init only); and one generic-body run
   (``pipe_pr_pcg`` with the norm in the dot batch), which must launch the
   2-right-hand-side SpMV once per iteration and no fused entry;
7. ``variants_f64`` — card against CPU in float64 over 25 iterations at
   n = 65,536, one name per family entry: the ``_cg`` names on the model
   problem, the ``_pcg`` names (Jacobi) on a scaled band on which Jacobi
   leaves a condition number near 2e3 (on the model problem Jacobi converges
   within six iterations and the histories past them are rounding noise);
   nu and alpha histories to rtol 1e-10;
8. ``check`` lines of the full-DIA kernels (``check_dia``, run right after
   the checks of 3): the DIA SpMV of ``csrc/dia_spmv.cu`` (1 and 2 right-hand
   sides, the halo-extended entries, the staged-window and the direct regime,
   offsets that are not symmetric), the two vector phases of
   ``csrc/pipe_vector.cu`` and the eleven entries of ``csrc/dia_family.cu``
   (as in 3), each against its plain version, at n = 655,360 with 63
   diagonals and at small and ragged shapes; the SpMV and the vector phases
   also at the shape of 10 (n = 4,194,304), timed there too;
9. ``dia_f32`` — the full-DIA path at full width: ``banded_model(655_360,
   k=32, fmt="dia")`` in float32; pipe-PR-CG under the bench protocol of 4,
   then the other 17 names for 300 iterations each, with the launch counts
   of 6 (each name its own entry of the full-DIA family kernel once per
   iteration, the SpMV in init only); then ``pipe_pr_pcg`` with a
   preconditioner given as a function, which takes the split formulation
   (preconditioned vector phase + the 2-right-hand-side SpMV);
10. ``dia_wide_f32`` — a 5-diagonal grid operator with offsets (-2048, -1, 0,
    1, 2048) on n = 4,194,304, too wide for the family kernel: ``pipe_pr_cg``
    and ``pipe_pr_pcg`` take the split formulation (vector-phase kernel, then
    the 2-right-hand-side SpMV kernel in its direct regime), ``pr_cg`` its
    generic body (one SpMV launch per iteration), 300 iterations each;
11. ``dia_f64`` — card against CPU in float64 over 25 iterations at
    n = 65,536 on full-DIA storage, one name per family entry (the model
    problem, and the scaled band for the Jacobi runs), and one run on a dense
    512 x 512 operator;
12. ``check`` lines of the double-word kernels (``check_df``, run after
    ``check_dia``): the DIA product of ``csrc/df_spmv.cu`` (1 and 2
    right-hand sides; 63 diagonals at n = 655,360, the wide grid band, small,
    ragged and non-symmetric bands), its dense product (n = 4096, 8192 and
    small n, also below the 256 threads of a row) and the vector phase of
    ``csrc/df_pipe.cu`` (at 2560 tiles of 256 rows, 16,384, and 1, 3, 5, 6, 7),
    each against its plain version on the same O(1) random three-word and
    double-word data: every product and vector word equal (max |difference|
    0), the four dots within 1e-12 of float64 in units of sum |a_i b_i|;
    the vector phase's dots also equal to its tile order (tile_order_dots),
    on two calls back to back on different data, with a third call that
    must repeat the first one's dot bits, and one launch a call (the
    profiler's count). Timed at the paths' shapes, with the bounds from
    bytes and from float32 operations counted without fused multiply-adds,
    and the float64 counterpart of each (a different function, labelled so);
13. ``df_f32x2`` — the double-word path at full width: pipe-PR-CG with
    ``dtype="f32x2"`` on the model problem of 4 built in float64 (expanded to
    63 diagonals and split exactly, 495 MB of words), 300 iterations of
    ``solve(norm_type="none")`` with rows 9 (2 right-hand sides) and 11 once
    per iteration, the profiler's launches per iteration; the other 17 names
    for 20 iterations (generic bodies: row 9 once per product); plain-float64
    pipe-PR-CG on the same problem beside it;
14. ``df_dense_f32x2`` — pipe-PR-CG in f32x2 on a dense SPD operator (n =
    4096): row 10 (2 right-hand sides) and row 11 once per iteration, the
    profiler's launches per iteration;
15. ``df_card_vs_cpu`` — f32x2 on the card against the CPU on the same words,
    25 iterations (n = 65,536 full-DIA, and a dense 512 x 512): collapsed nu
    and alpha to rtol 1e-10; and the one-shot check that the error words
    survive, on the card;
16. ``df_accuracy`` — the outcome of the mode: on the diagonal model spectrum
    at kappa = 1e6 (n = 65,536) float32 stalls near 1e-5 relative A-norm
    error and f32x2 reaches 1e-10 within 300 iterations;
17. ``check`` lines of the ELL kernel (``check_ell``): ``ell_spmv`` and
    ``ell_spmv2`` of ``csrc/ell_spmv.cu`` (kernel row 12) against their plain
    versions in float32 and float64 on O(1) random values, every value in
    units of its own scale (|A| |v|)_i: HPCG's 27-point pattern at n =
    104^3 = 1,124,864 (L = 27) in natural order and under a random symmetric
    permutation, a ragged pattern (n = 4099, rows of 0..9 entries), n = 100
    and L = 1; each in the given order and, where the operator would keep
    one (the permuted pattern's RCM order; a random order for the small
    shapes where RCM does not narrow the band), in a locality order: storage
    reordered, the gather in (``ell_gather``), the product scattering out,
    whose results must equal the given order's bit for bit.  Timed in
    float32 at HPCG's pattern, with the plain versions, cuSPARSE CSR through
    torch, ``torch.index_select`` beside the gather and the bound;
18. ``ell_f32`` — general sparse input through the auto route: HPCG's
    operator (27-point, 104^3; diagonal 26, -1 to each neighbour) under a
    random symmetric permutation, handed over as scipy CSR in float32; the
    route must pick ELL in the RCM order and warn; pipe-PR-CG for 300
    iterations (launches, the profiler's kernels per iteration and busy
    share), the other 17 names for 100 (row 12 once per product of each
    generic body, each after one gather in), one solve to rtol 1e-6 that
    converges; the host seconds of the operator's build;
19. ``formats_f32`` — the model problem of 4 as scipy CSR: permuted, the
    auto route must pick the block-banded packing (bs = 128); unpermuted,
    the stencil (and ``banded_model(fmt="stencil")``); pipe-PR-CG for 300
    iterations on each, no kernel launched, the block-banded residual (in
    the original order) within 10x of the half-band path's;
20. ``sparse_f64`` — card against CPU in float64 over 25 iterations on ELL
    (the permuted 27-point operator on 32^3), block-banded (the permuted
    model problem, n = 65,536) and stencil operators, one name per family
    and a Jacobi ``_pcg`` name on each; pipe-PR-CG in f32x2 on an ELL inner;
21. ``convergence_f64`` — the ``figure_gen`` flow on the card in float64
    (``harness.convergence``): HPCG's operator on 32^3 under a random
    permutation (n = 32,768; the auto route picks ELL) and the scaled band
    (n = 65,536, k = 32; half-band) written with ``write_mtx``;
    ``run_convergence_suite`` over the nine default names with the
    extended-precision oracle on the host (Jacobi and none on the first,
    Jacobi on the second), their table rows and seconds; the first with
    Jacobi again on the card and on the CPU, stopped before the rounding
    floor: iterations to 1e-5 within 1, log10 of the best error within
    0.05, the oracle's columns identical; launch counts of every run (row
    12 once per product of each generic body and each probe product, after
    one gather; each name's family entry once per step; nothing on the
    CPU); then ``updated_error_A_norm`` (against ``spsolve``) and
    ``lanczos_recurrence`` on a card run of ``hs_pcg`` on 24^3.  Row 12 and
    the half-band kernels are checked and timed in float64 at these shapes
    first;
22. ``cli_f32`` — ``cli.main`` in-process at the main path's width:
    ``solve`` (pipe-PR-CG, 300 iterations, 3 repeats) and ``scaling`` (five
    names, 1500 iterations, 3 trials; its result files, ``env_info.json``
    with the ``nvidia-smi`` line, ``scaling.call``), with launch counts;
    ``solve --devices 2`` must raise ``NotImplementedError`` and ``solve
    --dtype bf16`` the kernels' ``TypeError``;
23. ``trace_f32`` — 200 steps of the main path under
    ``utils.profiling.trace``, parsed by ``utils.trace_analysis``: the
    family kernel in the spmv bucket, no kernel of the port in "other", the
    parsed device time within 10% of the profiler's busy time;
24. ``kernels`` — one JSON line over all kernel entries: one record per entry
    and shape that a driven path gives it, with the entry's launches on the
    paths of that shape.

Every phase prints one JSON line.  Any failed check raises, and the script
exits nonzero; it also exits nonzero, printing no result, when no CUDA device
is available.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
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
VARIANT_ITERS = 300
GENERIC_ITERS = 100
VARIANTS_F64_N = 65_536
SMALL_SHAPES = ((4099, 8), (100, 8))
#: (n, k) of the half-band checks beside the main path's and SMALL_SHAPES:
#: the widest band the auto route stores half-band (h = 127,
#: ops/operators.py:_SYMDIA_MAX_HALF_BAND) and a band wider than the matrix
SYM_WIDE_SHAPES = ((65_536, 128), (100, 128))
SYM_SHAPES = ((N, K_BAND),) + SMALL_SHAPES + SYM_WIDE_SHAPES
WIDE_N = 4_194_304
WIDE_OFFSETS = (-2048, -1, 0, 1, 2048)
DENSE_N = 512
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


def emit_check(rec):
    emit("check", **rec)


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


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


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def random_dia(torch, offsets, n, dtype, rng):
    """O(1) random full-DIA data, explicit zeros outside the matrix."""
    data = rng.uniform(-1.0, 1.0, (len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            data[d, max(n - off, 0):] = 0.0
        elif off < 0:
            data[d, :min(-off, n)] = 0.0
    return torch.as_tensor(data, dtype=dtype, device="cuda")


def library_csr(torch, offsets, data, mirror=True):
    """The full matrix as a CUDA CSR tensor (yardstick only).  ``mirror``:
    ``data`` is half-band storage, whose upper diagonals stand for the lower
    ones too; else full-DIA storage."""
    n = data.shape[1]
    rows, cols, vals = [], [], []
    for d, off in enumerate(offsets):
        if not mirror:
            i = torch.arange(max(0, -off), min(n, n - off), device=data.device)
            rows.append(i)
            cols.append(i + off)
            vals.append(data[d, i])
            continue
        i = torch.arange(0, n - off, device=data.device)
        rows += [i] if off == 0 else [i, i + off]
        cols += [i] if off == 0 else [i + off, i]
        vals += [data[d, : n - off]] if off == 0 else [data[d, : n - off]] * 2
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (n, n))
    return coo.coalesce().to_sparse_csr()


def check_spmv(torch, card, timings, report=emit_check, shapes=SYM_SHAPES,
               dtypes=("float32", "float64"), timed=((N, K_BAND), "float32"),
               suffix=""):
    """The half-band SpMV kernel against its plain version at ``shapes`` in
    ``dtypes``, timed (when ``timings`` is a dict) at ``timed`` = (shape,
    dtype), into ``timings["sym_dia_spmv" + suffix]``.  ``report`` takes each
    check's record.  Returns the failed checks."""
    from new_cg_variants_tpu_torch.ops import sym_dia as sd

    rate = memory_rate(card)
    failed = []
    for dtype in (getattr(torch, dn) for dn in dtypes):
        dn = dtype_name(dtype)
        tol = TOL[dn]
        for n, k in shapes:
            rng = np.random.default_rng(n + k)
            offs = tuple(range(k))  # the stored offsets of banded_model
            data = random_band(torch, offs, n, dtype, rng)
            v, w = (torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                    device="cuda") for _ in range(2))
            main = (((n, k), dn) == timed and timings is not None)
            isz = data.element_size()
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
                timings["sym_dia_spmv" + suffix] = rec
            report(rec)
            if not max(errs) <= tol:
                failed.append(rec)

            del data, v, w
            torch.cuda.empty_cache()
    return failed


#: The entries of csrc/sym_family.cu.  Per entry: input vectors in
#: order (d is inv_diag), scalars, outputs in return order, the dots as pairs
#: of outputs, SpMVs per call, elementwise operations per row, keywords, and
#: the plain PyTorch version beside the wrapper (timed on the card).
FAMILY = {
    "fused_sym_pipe_full_step": (
        "x r w u p s", "a1 beta", "x2 r2 w_out p2 s2 u2",
        ("p2 s2", "r2 s2", "s2 s2", "r2 r2"), 2, 18, {"recompute": True},
        "_pipe_step_plain"),
    "fused_sym_pipe_full_step/no recompute": (
        "x r w u p s", "a1 beta", "x2 r2 w_out p2 s2 u2",
        ("p2 s2", "r2 s2", "s2 s2", "r2 r2"), 1, 18, {"recompute": False},
        "_pipe_step_plain"),
    "fused_sym_hs_matvec_phase": (
        "r p", "beta", "p2 s2", ("p2 s2",), 1, 4, {}, "_hs_phase_plain"),
    "fused_sym_pr_full_step": (
        "x r p s", "a1 beta", "x2 r2 p2 s2",
        ("p2 s2", "r2 s2", "s2 s2", "r2 r2"), 1, 14, {}, "_pr_step_plain"),
    "fused_sym_cgcg_matvec_phase": (
        "x r p s", "a1", "x2 r2 w2", ("r2 r2", "w2 r2"), 1, 8, {},
        "_cgcg_phase_plain"),
    "fused_sym_gv_matvec_phase": (
        "x r w u p s", "a1", "x2 r2 w2 t", ("r2 r2", "w2 r2"), 1, 10, {},
        "_gv_phase_plain"),
    "fused_sym_pr_full_step_prec": (
        "d x r p s rt st", "a1 beta", "x2 r2 rt2 p2 s2 st2",
        ("p2 s2", "r2 st2", "st2 s2", "rt2 r2"), 1, 20, {},
        "_pr_step_prec_plain"),
    "fused_sym_cgcg_matvec_phase_prec": (
        "d x r p s", "a1", "x2 r2 rt2 w2", ("r2 rt2", "w2 rt2"), 1, 12, {},
        "_cgcg_phase_prec_plain"),
    "fused_sym_gv_matvec_phase_prec": (
        "d x r w u p s rt st", "a1", "x2 r2 rt2 w2 wt2 t",
        ("r2 rt2", "w2 rt2"), 1, 16, {}, "_gv_phase_prec_plain"),
    "fused_sym_pipe_full_step_prec": (
        "d x r w u p s rt st wt ut", "a1 beta",
        "x2 r2 w_out p2 s2 u2 rt2 st2 wt_out ut2",
        ("p2 s2", "r2 st2", "st2 s2", "rt2 r2"), 2, 32, {"recompute": True},
        "_pipe_step_prec_plain"),
    "fused_sym_pipe_full_step_prec/no recompute": (
        "d x r w u p s rt st wt ut", "a1 beta",
        "x2 r2 w_out p2 s2 u2 rt2 st2 wt_out ut2",
        ("p2 s2", "r2 st2", "st2 s2", "rt2 r2"), 1, 32, {"recompute": False},
        "_pipe_step_prec_plain"),
}
SCALAR_VALUES = {"a1": 0.37, "beta": 0.61}


#: The full-DIA entries, in FAMILY's layout: those of ops/fused_step.py (the
#: vector phases take no band, 0 SpMVs; the pipe steps are the half-band
#: entries' programs over the full-DIA product) and of ops/fused_family.py
#: (the other families: FAMILY's entries and plain-version names without
#: "sym").
VECTOR_PHASES = {
    "fused_pipe_vector_phase": (
        "x r w u p s", "a1 beta", "x2 r2 w2 p2 s2",
        ("p2 s2", "r2 s2", "s2 s2", "r2 r2"), 0, 18, {},
        "_pipe_vector_phase_plain"),
    "fused_pipe_vector_phase_prec": (
        "x r w u p s rt st wt ut", "a1 beta", "x2 r2 w2 rt2 wt2 p2 s2 st2",
        ("p2 s2", "r2 st2", "st2 s2", "rt2 r2"), 0, 28, {},
        "_pipe_vector_phase_prec_plain"),
}
DIA_STEP = {
    **VECTOR_PHASES,
    **{entry.replace("fused_sym_", "fused_"):
       spec[:-1] + (spec[-1].replace("_pipe_step", "_dia_pipe_full_step"),)
       for entry, spec in FAMILY.items() if "pipe" in entry},
}
DIA_FAMILY = {entry.replace("fused_sym_", "fused_"): spec
              for entry, spec in FAMILY.items() if "pipe" not in entry}
DIA_MAIN_OFFSETS = tuple(range(-(K_BAND - 1), K_BAND))
#: (n, label, offsets) of the full-DIA checks: the main path's band, ragged n,
#: n below one tile, offsets that are not symmetric
DIA_SHAPES = (
    (N, K_BAND, DIA_MAIN_OFFSETS),
    (4099, 8, tuple(range(-7, 8))),
    (100, 8, tuple(range(-7, 8))),
    (4099, "nonsym", (-3, -1, 0, 2, 7)),
)
#: the shape of the dia_wide_f32 path: what the split formulation's kernels
#: (vector phases, SpMV) are given there
WIDE_SHAPE = (WIDE_N, "wide", WIDE_OFFSETS)
#: suffix of a kernel's record (timings, the kernels line) at WIDE_SHAPE
WIDE = " (wide band)"


def family_scales(torch, call, data, names, vecs, scalars):
    """Componentwise scale of each output: the entry run on magnitudes.

    Every update of the family is ``a + c b`` or ``a - a1 b``; on magnitudes
    with ``a1`` negated and ``beta`` positive each becomes ``|a| + |c| |b|``,
    carried through the product with ``|A|`` and the finish with ``d > 0``.
    Only ``x2 = x + a1 p`` adds ``a1``, so its scale is formed here.
    """
    mags = [v.abs().cpu() for v in vecs]
    sc = {k: v.abs().cpu() for k, v in scalars.items()}
    if "a1" in sc:
        sc["a1"] = -sc["a1"]
    out = list(call(data.abs().cpu(), mags, list(sc.values()))[:-1])
    if "x" in names:
        out[0] = mags[names.index("x")] + sc["a1"].abs() * mags[names.index("p")]
    return [o.to(data.device) for o in out]


def check_entries(torch, card, timings, module, table, shapes, make_band,
                  terms_per_value, suffix="", report=emit_check,
                  dtypes=("float32", "float64"), timed_dtype="float32"):
    """Each entry of ``table`` (wrappers of ``module``) against its plain
    version (the wrapper on CPU copies of the same inputs), on each of
    ``shapes`` = (n, label, offsets) with the band ``make_band`` draws, in
    ``dtypes``; the first shape in ``timed_dtype`` is timed when ``timings``
    is a dict, into ``timings[entry + suffix]``.  ``terms_per_value``: operations per stored
    value and SpMV (4 with a mirror term, 2 without).  ``report`` takes each
    check's record.  Returns the failed checks."""
    rate = memory_rate(card)
    failed = []
    for dtype in (getattr(torch, dn) for dn in dtypes):
        dn = dtype_name(dtype)
        tol = TOL[dn]
        for n, k, offs in shapes:
            rng = np.random.default_rng(7 * n + len(offs))
            data = make_band(torch, offs, n, dtype, rng)
            data_cpu = data.cpu()
            main = ((n, k, offs) == shapes[0] and dn == timed_dtype
                    and timings is not None)
            for entry, (ins, scs, outs, dots, nmv, ops, kw,
                        plain_name) in table.items():
                fn = getattr(module, entry.split("/")[0])
                names, onames = ins.split(), outs.split()

                def call(band, vs, scs_, fn=fn, nmv=nmv, kw=kw, offs=offs):
                    # an entry without a product takes no band
                    head = (offs, band) if nmv else ()
                    return fn(*head, *vs, *scs_, **kw)

                vecs = [torch.as_tensor(
                    rng.uniform(0.5, 2.0, n) if nm == "d"
                    else rng.standard_normal(n), dtype=dtype, device="cuda")
                    for nm in names]
                scalars = {nm: torch.tensor(SCALAR_VALUES[nm], dtype=dtype,
                                            device="cuda")
                           for nm in scs.split()}
                got = call(data, vecs, list(scalars.values()))
                torch.cuda.synchronize()
                want = call(data_cpu, [v.cpu() for v in vecs],
                            [v.cpu() for v in scalars.values()])
                want = [w.to("cuda") for w in want[:-1]] + [
                    [w.to("cuda") for w in want[-1]]]
                scales = family_scales(torch, call, data, names, vecs, scalars)
                verrs = [cw_err(torch, g, w, sc)
                         for g, w, sc in zip(got[:-1], want[:-1], scales)]
                by_name = dict(zip(onames, want[:-1]))
                derrs = [dot_err(torch, g, w, *[by_name[v] for v in pr.split()])
                         for g, w, pr in zip(got[-1], want[-1], dots)]
                abs_err = max(float((g - w).abs().max())
                              for g, w in zip(got[:-1], want[:-1]))
                rec = dict(kernel=entry, dtype=dn, n=n, k=k,
                           max_err=max(verrs),
                           err_by_output=dict(zip(onames, verrs)),
                           max_dot_err=max(derrs), max_abs_err=abs_err,
                           tol=tol)
                if main:
                    head = (offs, data) if nmv else ()
                    args = (*head, *vecs, *scalars.values())
                    ms = time_ms(torch, lambda: fn(*args, **kw), 50)
                    plain = getattr(module, plain_name)
                    plain_ms = time_ms(
                        torch, lambda: plain(*args, *kw.values()), 5)
                    ndiag = len(offs) if nmv else 0
                    b_ms, b_by = bound(
                        (ndiag + len(names) + len(onames)) * n
                        * data.element_size(),
                        (terms_per_value * ndiag * nmv + ops) * n, dn, rate)
                    rec.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                               bound_ms=b_ms, bound_by=b_by)
                    timings[entry + suffix] = rec
                report(rec)
                shapes_ok = (len(got) == len(onames) + 1
                             and len(got[-1]) == len(dots))
                if not (shapes_ok and max(verrs) <= tol and max(derrs) <= tol):
                    failed.append(rec)
                del vecs, got, want, scales, by_name
            del data, data_cpu
            torch.cuda.empty_cache()
    return failed


def check_family(torch, card, timings, report=emit_check):
    """The eleven entries of the family kernel against their plain versions
    at SYM_SHAPES; returns the failed checks."""
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    shapes = tuple((n, k, tuple(range(k))) for n, k in SYM_SHAPES)
    return check_entries(torch, card, timings, sf, FAMILY, shapes,
                         random_band, 4, report=report)


def sym_checks(torch, card, timings, report):
    """The checks of both half-band kernels; returns the failed ones."""
    return (check_spmv(torch, card, timings, report)
            + check_family(torch, card, timings, report))


def check_sym(torch, card, timings):
    """Every half-band kernel entry against its plain version; raises after
    all checks ran."""
    failed = sym_checks(torch, card, timings, emit_check)
    if failed:
        raise AssertionError(f"{len(failed)} half-band checks disagree: "
                             f"{failed}")


def staged_against_direct(torch, sp, offs, data, v, w):
    """The SpMV kernel's two forms on a band it would stage: the window in
    shared memory against reads of ``v`` through the read-only cache, timed
    in turns (staged, direct, direct, staged), and whether both give the
    same bits."""
    out = {}
    for key, vecs in (("1 rhs", (v,)), ("2 rhs", (v, w))):
        forms = {
            "staged": lambda vecs=vecs: sp._launch(offs, data, vecs, False,
                                                   staged=True),
            "direct": lambda vecs=vecs: sp._launch(offs, data, vecs, False,
                                                   staged=False)}
        same = all(bool(torch.equal(a, b))
                   for a, b in zip(forms["staged"](), forms["direct"]()))
        ms = {name: [] for name in forms}
        for name in ("staged", "direct", "direct", "staged"):
            ms[name].append(time_ms(torch, forms[name], 50))
        out[key] = dict(ms=ms, same_bits=same)
    return {"staged_against_direct": out}


def check_dia_spmv(torch, card, timings, report=emit_check):
    """The DIA SpMV kernel's entries against their plain versions, in both
    regimes (staged window, direct reads); timed (when ``timings`` is a dict)
    at the shapes of the two full-DIA paths.  ``report`` takes each check's
    record.  Returns the failed checks."""
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp

    rate = memory_rate(card)
    shapes = DIA_SHAPES + (WIDE_SHAPE, (100_003, "wide", WIDE_OFFSETS),
                           (1000, "wide", WIDE_OFFSETS))
    timed = {DIA_SHAPES[0]: "", WIDE_SHAPE: WIDE} if timings is not None else {}
    failed = []
    for dtype in (torch.float32, torch.float64):
        dn = dtype_name(dtype)
        tol = TOL[dn]
        for n, k, offs in shapes:
            rng = np.random.default_rng(n + len(offs))
            data = random_dia(torch, offs, n, dtype, rng)
            h = max(abs(o) for o in offs)
            v, w = (torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                    device="cuda") for _ in range(2))
            # halo-extended right-hand sides [h | n | h], halos not zero
            vx, wx = (torch.as_tensor(rng.standard_normal(n + 2 * h),
                                      dtype=dtype, device="cuda")
                      for _ in range(2))
            got = {"1": sp.dia_spmv(offs, data, v)}
            got["2a"], got["2b"] = sp.dia_spmv2(offs, data, v, w)
            # a shard's band: rows of the interior, no zeros at its edges
            shard = torch.as_tensor(rng.uniform(-1.0, 1.0, (len(offs), n)),
                                    dtype=dtype, device="cuda")
            got["ext"] = sp.dia_spmv_ext(offs, shard, vx)
            got["ext2a"], got["ext2b"] = sp.dia_spmv2_ext(offs, shard, vx, wx)
            torch.cuda.synchronize()
            absd = data.abs()
            want, scale = {}, {}
            for key, x in (("1", v), ("2b", w)):
                want[key] = sp._dia_mv_plain(offs, data, x)
                scale[key] = sp._dia_mv_plain(offs, absd, x.abs())
            for key, x in (("ext", vx), ("ext2b", wx)):
                want[key] = sp._dia_mv_ext_plain(offs, shard, x)
                scale[key] = sp._dia_mv_ext_plain(offs, shard.abs(), x.abs())
            same = {"2a": "1", "ext2a": "ext"}
            errs = {key: cw_err(torch, g, want[same.get(key, key)],
                                scale[same.get(key, key)])
                    for key, g in got.items()}
            abs_err = max(float((g - want[same.get(key, key)]).abs().max())
                          for key, g in got.items())
            rec = dict(kernel="dia_spmv", dtype=dn, n=n, k=k,
                       staged=sp.stages_window(offs), max_err=max(errs.values()),
                       err_by_entry=errs, max_abs_err=abs_err, tol=tol)
            if (n, k, offs) in timed and dtype == torch.float32:
                sfx = timed[(n, k, offs)]
                nd, isz = len(offs), data.element_size()
                ms = time_ms(torch, lambda: sp.dia_spmv(offs, data, v), 50)
                ms2 = time_ms(torch, lambda: sp.dia_spmv2(offs, data, v, w), 50)
                plain_ms = time_ms(torch,
                                   lambda: sp._dia_mv_plain(offs, data, v), 5)
                csr = library_csr(torch, offs, data, mirror=False)
                lib_err = cw_err(torch, csr @ v, want["1"], scale["1"])
                lib_ms = time_ms(torch, lambda: csr @ v, 50)
                vw = torch.stack([v, w], dim=1)
                lib2_ms = time_ms(torch, lambda: csr @ vw, 50)
                plain2_ms = time_ms(
                    torch, lambda: (sp._dia_mv_plain(offs, data, v),
                                    sp._dia_mv_plain(offs, data, w)), 5)
                del csr, vw
                if sp.stages_window(offs):
                    rec.update(staged_against_direct(torch, sp, offs, data,
                                                     v, w))
                b_ms, b_by = bound((nd + 2) * n * isz, 2 * nd * n, dn, rate)
                b2_ms, b2_by = bound((nd + 4) * n * isz, 4 * nd * n, dn, rate)
                rec.update(ms=ms, spmv2_ms=ms2, plain_ms=plain_ms,
                           library_ms=lib_ms, library_err=lib_err,
                           bound_ms=b_ms, bound_by=b_by, spmv2_bound_ms=b2_ms)
                timings["dia_spmv" + sfx] = rec
                # the 2-RHS entry: two plain products; as a library call one
                # cuSPARSE product with the (n, 2) matrix [v | w]
                timings["dia_spmv2" + sfx] = dict(
                    rec, ms=ms2, plain_ms=plain2_ms, library_ms=lib2_ms,
                    bound_ms=b2_ms, bound_by=b2_by)
            report(rec)
            if not max(errs.values()) <= tol:
                failed.append(rec)
            del data, shard, absd, v, w, vx, wx, got, want, scale
            torch.cuda.empty_cache()
    return failed


def dia_checks(torch, card, timings, report):
    """The checks of every full-DIA kernel entry, at the shapes of both
    full-DIA paths; returns the failed ones."""
    from new_cg_variants_tpu_torch.ops import fused_family as ff
    from new_cg_variants_tpu_torch.ops import fused_step as fs

    failed = check_dia_spmv(torch, card, timings, report)
    for module, table, shapes, suffix in (
            (fs, DIA_STEP, DIA_SHAPES, ""), (ff, DIA_FAMILY, DIA_SHAPES, ""),
            (fs, VECTOR_PHASES, (WIDE_SHAPE,), WIDE)):
        failed += check_entries(torch, card, timings, module, table, shapes,
                                random_dia, 2, suffix, report)
    return failed


def check_dia(torch, card, timings):
    """Every full-DIA kernel entry against its plain version; raises after
    all checks ran."""
    failed = dia_checks(torch, card, timings, emit_check)
    if failed:
        raise AssertionError(f"{len(failed)} full-DIA checks disagree: {failed}")


def counted_wrappers():
    from new_cg_variants_tpu_torch.ops import df_spmv as ds
    from new_cg_variants_tpu_torch.ops import ell_spmv as es
    from new_cg_variants_tpu_torch.ops import fused_family as ff
    from new_cg_variants_tpu_torch.ops import fused_step as fs
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp
    from new_cg_variants_tpu_torch.ops import sym_dia as sd
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    return ((sd.sym_dia_spmv, sd.sym_dia_spmv2) + sf.FAMILY_WRAPPERS
            + sp.DIA_WRAPPERS + fs.FUSED_STEP_WRAPPERS
            + ff.FUSED_FAMILY_WRAPPERS + ds.DF_WRAPPERS + es.ELL_WRAPPERS)


def reset_counts():
    for fn in counted_wrappers():
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in counted_wrappers()}


def device_activity(prof):
    """``(busy us, CUDA events, us by name)`` of what a profiler saw on the
    card: the union of its CUDA events' spans (kernels, copies, sets)."""
    from torch.autograd import DeviceType

    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, -1.0
    for a, z in sorted(spans):
        busy += max(0.0, z - max(a, end))
        end = max(end, z)
    return busy, len(spans), by_name


def profile_steps(torch, ctx, step_fn, state):
    """Device busy share and kernel time by name over PROFILE_STEPS steps.

    From ``torch.profiler``'s CUDA kernel events; ``None`` fields where the
    profiler saw no device activity (not measured).
    """
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
    busy, nspans, by_name = device_activity(prof)
    if not nspans:
        return {"steps": PROFILE_STEPS - 1, "device_busy_share": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    steps = PROFILE_STEPS - 1
    return {"steps": steps, "wall_ms_per_iter": wall_us / steps / 1e3,
            "device_busy_ms_per_iter": busy / steps / 1e3,
            "device_busy_share": busy / wall_us,
            "kernels_per_iter": nspans / steps,
            "top_kernels_us_per_iter": {k[:60]: v / steps for k, v in top}}


def bench_protocol(torch, op, b, fused_wrapper, spmv_wrapper):
    """pipe-PR-CG on ``op`` as ``bench.py`` times it, then two timed
    ``solve(norm_type="none")`` runs and a profiled window.  Returns the
    measurements and the launch counts next to what they must be: three
    launches of ``spmv_wrapper`` per init and one of ``fused_wrapper`` per
    iteration, nothing else."""
    from new_cg_variants_tpu_torch import solve
    from new_cg_variants_tpu_torch.solvers.context import Context
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES

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
    want = dict.fromkeys(counts, 0)
    want.update({spmv_wrapper: 3 * inits, fused_wrapper: steps})
    x = res.x
    resid = float(torch.linalg.norm(b - op.mv(x)) / torch.linalg.norm(b))
    return dict(ms_per_iter=ms_per_iter, trial_seconds=times,
                solve_ms_per_iter=solve_ms, profile=profile,
                nu_final=nu_final, rel_residual=resid, x=x, launches=counts,
                expected_launches=want)


def emit_bench(torch, phase, out, x_true, kernel_ms, **fields):
    """Print a bench_protocol result as a phase line and hold it to its
    checks."""
    x = out.pop("x")
    fwd = float(torch.linalg.norm(x.double().cpu() - torch.from_numpy(x_true))
                / np.linalg.norm(x_true))
    emit(phase, variant="pipe_pr_cg", n=N, k=K_BAND, fused_kernel_ms=kernel_ms,
         fused_kernel_share_of_step=kernel_ms / out["ms_per_iter"],
         rel_forward_error=fwd, **fields, **out)
    nu_final, counts = out["nu_final"], out["launches"]
    if not (np.isfinite(nu_final) and nu_final > 0):
        raise AssertionError(f"nu at the end is {nu_final}: diverged")
    if counts != out["expected_launches"]:
        raise AssertionError(
            f"launch counts {counts} != {out['expected_launches']}")
    if not (np.isfinite(out["rel_residual"]) and bool(torch.isfinite(x).all())):
        raise AssertionError("non-finite solution")
    return counts


def model_f32(torch, fmt):
    """The full-width model problem in float32 on the card."""
    from new_cg_variants_tpu_torch import banded_model

    op64, b64, x_true = banded_model(N, k=K_BAND, fmt=fmt, device="cpu")
    op = op64.astype(torch.float32).to("cuda")
    b = torch.as_tensor(b64, dtype=torch.float32, device="cuda")
    return op, b, x_true


def main_path_f32(torch, timings):
    op, b, x_true = model_f32(torch, "symdia")
    out = bench_protocol(torch, op, b, "fused_sym_pipe_full_step",
                         "sym_dia_spmv")
    timings["main_f32"] = {"ms_per_iter": out["ms_per_iter"]}
    return emit_bench(torch, "main_f32", out, x_true,
                      timings["fused_sym_pipe_full_step"]["ms"])


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


#: the fused entry each name launches once per iteration, and its SpMV
#: launches in init
VARIANT_ENTRY = {
    "hs_cg": ("fused_sym_hs_matvec_phase", 2),
    "hs_pcg": ("fused_sym_hs_matvec_phase", 2),
    "cg_cg": ("fused_sym_cgcg_matvec_phase", 3),
    "cg_pcg": ("fused_sym_cgcg_matvec_phase_prec", 3),
    "gv_cg": ("fused_sym_gv_matvec_phase", 3),
    "gv_pcg": ("fused_sym_gv_matvec_phase_prec", 3),
    "pr_cg": ("fused_sym_pr_full_step", 2),
    "pr_pcg": ("fused_sym_pr_full_step_prec", 2),
    "m_cg": ("fused_sym_pr_full_step", 2),
    "m_pcg": ("fused_sym_pr_full_step_prec", 2),
    "pipe_p_pcg": ("fused_sym_pipe_full_step_prec/no recompute", 3),
    "pipe_pr_pcg": ("fused_sym_pipe_full_step_prec", 3),
    "pipe_p_m_pcg": ("fused_sym_pipe_full_step_prec/no recompute", 3),
    "pipe_pr_m_pcg": ("fused_sym_pipe_full_step_prec", 3),
    "pipe_p_cg": ("fused_sym_pipe_full_step/no recompute", 3),
    "pipe_p_m_cg": ("fused_sym_pipe_full_step/no recompute", 3),
    "pipe_pr_m_cg": ("fused_sym_pipe_full_step", 3),
}


def sym_expected(name, iters):
    """Launches a name makes on half-band storage: its own fused entry once
    per iteration, the SpMV in init only.  Returns ``(counts by wrapper,
    kernel entry)``."""
    entry, init_spmvs = VARIANT_ENTRY[name]
    return {"sym_dia_spmv": init_spmvs, entry.split("/")[0]: iters}, entry


def dia_expected(name, iters):
    """Launches a name makes on a ``DiaOperator`` whose band the family
    kernel takes: as on half-band storage, its own fused entry once per
    iteration and the SpMV in init only."""
    entry, init_spmvs = VARIANT_ENTRY.get(
        name, ("fused_sym_pipe_full_step", 3))  # pipe_pr_cg
    entry = entry.replace("fused_sym_", "fused_")
    return {"dia_spmv": init_spmvs, entry.split("/")[0]: iters}, entry


#: SpMV launches in init of each family's generic body (one per iteration)
GENERIC_INIT_SPMVS = {"hs": 2, "cg": 3, "gv": 3, "pr": 2, "m": 2}


def split_expected(name, iters):
    """Launches a name makes on a ``DiaOperator`` on which the family kernel
    does not apply (a wide band; for ``pipe_*_pcg`` also a preconditioner
    other than Jacobi).  Pipe names take the split formulation: the vector
    phase (``_pcg``: its preconditioned twin), then one SpMV launch (2
    right-hand sides with recompute); every other name its generic body, one
    SpMV per iteration."""
    base = name.rsplit("_", 1)[0]
    if base in GENERIC_INIT_SPMVS:
        return {"dia_spmv": GENERIC_INIT_SPMVS[base] + iters}, "dia_spmv"
    recompute = base in ("pipe_pr", "pipe_pr_m")
    phase = ("fused_pipe_vector_phase" if name.endswith("_cg")
             else "fused_pipe_vector_phase_prec")
    counts = {"dia_spmv": 3 + (0 if recompute else iters), phase: iters}
    if recompute:
        counts["dia_spmv2"] = iters
    return counts, phase


def jacobi_for_pcg(name, op):
    """The preconditioner of a smoke run: Jacobi for the ``_pcg`` names."""
    return ("jacobi", "jacobi") if name.endswith("pcg") else (None, None)


def solve_names(torch, phase, op, b, x_true, names, expected,
                precond=jacobi_for_pcg, iters=VARIANT_ITERS, dtype=None,
                plain_op=None, **fields):
    """Each name through ``solve(norm_type="none")`` for ``iters``
    iterations (in ``dtype``), preconditioned by ``precond(name, op)`` =
    (label, what ``solve`` takes): ms/iter, a finite solution and launch
    counts equal to ``expected(name, iterations)``; the residual is formed
    with ``plain_op`` (default ``op``).  Returns the launches by wrapper and
    by kernel entry, summed over the runs, and the failed runs."""
    from new_cg_variants_tpu_torch import solve

    plain_op = op if plain_op is None else plain_op
    bnorm = float(torch.linalg.norm(b))
    xt = torch.as_tensor(x_true, dtype=b.dtype, device="cuda")
    launches, failed = {}, []
    for name in names:
        pre, spec = precond(name, op)
        kw = dict(variant=name, preconditioner=spec, norm_type="none",
                  dtype=dtype)
        solve(op, b, max_iter=5, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = solve(op, b, max_iter=iters, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        by_wrapper, entry = expected(name, iters)
        want.update(by_wrapper)
        for key, val in counts.items():
            # a wrapper's launches go to the entry of it that this name runs
            dest = entry if key == entry.split("/")[0] else key
            launches[dest] = launches.get(dest, 0) + val
        r = b - plain_op.mv(res.x)
        # the true residual's nu = r.M^-1 r (the recurrence's own nu
        # underflows to 0 once a Jacobi run has converged, and freezes)
        nu = float(torch.dot(r, r / plain_op.diagonal() if pre else r))
        rec = dict(variant=name, preconditioner=pre, iterations=res.iterations,
                   ms_per_iter=seconds / iters * 1e3, nu_final=nu,
                   rel_residual=float(torch.linalg.norm(r)) / bnorm,
                   rel_forward_error=float(torch.linalg.norm(res.x - xt)
                                           / torch.linalg.norm(xt)),
                   launches={k: v for k, v in counts.items() if v},
                   expected_launches={k: v for k, v in want.items() if v})
        emit(phase, **fields, **rec)
        ok = (np.isfinite(nu) and nu > 0 and counts == want
              and res.iterations == iters
              and bool(torch.isfinite(res.x).all()))
        if not ok:
            failed.append(rec)
    return launches, failed


def variants_f32(torch):
    """The 16 names beside the main path's, at full width.  Returns the
    launches of each kernel entry, summed over the runs."""
    from new_cg_variants_tpu_torch import solve

    op, b, x_true = model_f32(torch, "symdia")
    launches, failed = solve_names(torch, "variants_f32", op, b, x_true,
                                   VARIANT_ENTRY, sym_expected, n=N, k=K_BAND)

    # the generic body: the norm rides the dot batch, so no fused phase
    reset_counts()
    t0 = time.perf_counter()
    res = solve(op, b, variant="pipe_pr_pcg", preconditioner="jacobi",
                norm_type="unpreconditioned", rtol=0.0,
                max_iter=GENERIC_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    want = dict.fromkeys(counts, 0)
    want.update(sym_dia_spmv=3, sym_dia_spmv2=res.iterations)
    rec = dict(variant="pipe_pr_pcg", preconditioner="jacobi",
               norm_type="unpreconditioned", path="generic",
               iterations=res.iterations,
               ms_per_iter=seconds / max(res.iterations, 1) * 1e3,
               norm=res.norm, launches={k: v for k, v in counts.items() if v},
               expected_launches={k: v for k, v in want.items() if v})
    emit("variants_f32", n=N, k=K_BAND, **rec)
    if not (counts == want and res.iterations == GENERIC_ITERS
            and np.isfinite(res.norm)):
        failed.append(rec)
    if failed:
        raise AssertionError(f"{len(failed)} variant runs failed: {failed}")
    return launches


def dia_path_f32(torch, timings):
    """The full-DIA path at full width: pipe-PR-CG under the bench protocol,
    then the other 17 names, then one run of the split formulation.  Returns
    the launches by wrapper and entry."""
    from new_cg_variants_tpu_torch import VARIANT_NAMES

    op, b, x_true = model_f32(torch, "dia")
    out = bench_protocol(torch, op, b, "fused_pipe_full_step", "dia_spmv")
    launches = dict(emit_bench(torch, "dia_f32", out, x_true,
                               timings["fused_pipe_full_step"]["ms"],
                               fmt="dia", ndiag=len(op.offsets)))
    names = [nm for nm in VARIANT_NAMES if nm != "pipe_pr_cg"]
    more, failed = solve_names(torch, "dia_f32", op, b, x_true, names,
                               dia_expected, n=N, k=K_BAND, fmt="dia")
    # a preconditioner the family kernel cannot apply itself (here the
    # inverse diagonal as a function): the split formulation at this width,
    # preconditioned vector phase + the 2-right-hand-side SpMV
    inv = 1.0 / op.diagonal()
    split, failed2 = solve_names(
        torch, "dia_f32", op, b, x_true, ("pipe_pr_pcg",), split_expected,
        lambda name, op: ("inverse diagonal, as a function", lambda v: inv * v),
        n=N, k=K_BAND, fmt="dia", path="split")
    failed += failed2
    for part in (more, split):
        for key, val in part.items():
            launches[key] = launches.get(key, 0) + val
    if failed:
        raise AssertionError(f"{len(failed)} full-DIA runs failed: {failed}")
    return launches


def grid_operator(torch, dtype):
    """The 5-point Laplacian of a 2048 x 2048 grid, shifted by 1e-3, as a
    5-diagonal ``DiaOperator`` on the card: diagonal 4 + 1e-3, couplings -1
    at distances 1 and 2048, none across a grid row's end."""
    from new_cg_variants_tpu_torch import DiaOperator

    n, far = WIDE_N, WIDE_OFFSETS[-1]
    i = torch.arange(n, device="cuda")
    data = torch.full((5, n), -1.0, dtype=dtype, device="cuda")
    data[2] = 4.0 + 1e-3
    data[0, :far] = 0.0                 # A[i, i - far], i >= far
    data[4, n - far:] = 0.0             # A[i, i + far], i < n - far
    data[1, i % far == 0] = 0.0         # A[i, i - 1]: none at a row's start
    data[3, i % far == far - 1] = 0.0   # A[i, i + 1]: none at a row's end
    return DiaOperator(WIDE_OFFSETS, data)


def dia_wide_f32(torch):
    """A band too wide for the family kernel and for a staged window: the
    pipe names take the split formulation (vector-phase kernel + direct
    SpMV), another name its generic body."""
    from new_cg_variants_tpu_torch.ops import fused_step, spmv_dia

    op = grid_operator(torch, torch.float32)
    if fused_step.supports_full_step(op.offsets) or \
            spmv_dia.stages_window(op.offsets):
        raise AssertionError("the wide band took a narrow-band path")
    x_true = np.ones(op.n, dtype=np.float32)
    b = op.mv(torch.ones(op.n, dtype=torch.float32, device="cuda"))
    launches, failed = solve_names(
        torch, "dia_wide_f32", op, b, x_true,
        ("pipe_pr_cg", "pipe_pr_pcg", "pr_cg"), split_expected,
        n=op.n, offsets=list(op.offsets))
    if failed:
        raise AssertionError(f"{len(failed)} wide-band runs failed: {failed}")
    return launches


def scaled_band(torch, n, k, seed=0, eps=1e-3):
    """``D^1/2 T D^1/2`` in half-band storage: ``T`` a diagonally dominant
    Toeplitz band (condition number near 2 / eps), ``D`` random in
    [1, 100], so Jacobi leaves ``T`` and no variant converges in 25 steps."""
    from new_cg_variants_tpu_torch import SymDiaOperator

    rng = np.random.default_rng(seed)
    c = -rng.uniform(0.5, 1.0, k - 1)
    dsc = np.sqrt(rng.uniform(1.0, 100.0, n))
    data = np.zeros((k, n))
    data[0] = 2.0 * np.abs(c).sum() * (1.0 + eps) * dsc * dsc
    for d in range(1, k):
        data[d, : n - d] = c[d - 1] * dsc[: n - d] * dsc[d:]
    op = SymDiaOperator(tuple(range(k)), torch.from_numpy(data))
    return op, op.mv(torch.ones(n, dtype=torch.float64)).numpy()


def compare_f64(torch, phase, cases, expected, dtype="float64"):
    """Card against CPU in float64 (or ``dtype="f32x2"``) over F64_ITERS
    iterations: ``cases`` = (name, operator on the CPU, b, problem label); nu
    and alpha histories to F64_RTOL and launch counts equal to
    ``expected(name, iterations)``."""
    from new_cg_variants_tpu_torch import run

    failed = []
    for name, op, b, problem in cases:
        prec = name.endswith("pcg")
        kw = dict(max_iter=F64_ITERS + 1, probes=("nu", "alpha"),
                  preconditioner="jacobi" if prec else None,
                  dtype=torch.float64 if dtype == "float64" else dtype)
        reset_counts()
        gpu = run(name, op, b, device="cuda", **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        cpu = run(name, op, b, device="cpu", **kw)
        errs = {p: float(np.max(np.abs(gpu[p] - cpu[p]) / np.abs(cpu[p])))
                for p in ("nu", "alpha")}
        want = dict.fromkeys(counts, 0)
        want.update(expected(name, F64_ITERS)[0])
        rec = dict(variant=name, problem=problem, n=op.n, dtype=dtype,
                   iterations=F64_ITERS, max_rel_diff=errs, rtol=F64_RTOL,
                   nu_last_over_first=float(cpu["nu"][-1] / cpu["nu"][0]),
                   launches={k: v for k, v in counts.items() if v})
        emit(phase, **rec)
        if not (max(errs.values()) <= F64_RTOL and counts == want):
            failed.append(rec)
    if failed:
        raise AssertionError(f"{len(failed)} f64 comparisons failed: {failed}")


def variants_f64(torch):
    """Card against CPU in float64, one name per family entry."""
    from new_cg_variants_tpu_torch import banded_model

    n = VARIANTS_F64_N
    model = banded_model(n, k=K_BAND, fmt="symdia", device="cpu")[:2]
    band = scaled_band(torch, n, K_BAND)
    names = ("hs_cg", "cg_cg", "gv_cg", "pr_cg", "hs_pcg", "pr_pcg", "cg_pcg",
             "gv_pcg", "pipe_pr_pcg", "pipe_p_pcg")
    compare_f64(torch, "variants_f64",
                [(nm, *(band if nm.endswith("pcg") else model),
                  "scaled_band" if nm.endswith("pcg") else "banded_model")
                 for nm in names], sym_expected)


def dia_f64(torch):
    """Card against CPU in float64 on full-DIA storage, and one run on a
    dense operator (no kernel: the matrix product is torch's)."""
    from new_cg_variants_tpu_torch import DiaOperator, as_operator, banded_model

    n = VARIANTS_F64_N
    model = banded_model(n, k=K_BAND, fmt="dia", device="cpu")[:2]
    sym, b_band = scaled_band(torch, n, K_BAND)
    offsets, full = sym.todia_host()  # both triangles, exactly
    band = (DiaOperator(offsets, torch.from_numpy(full)), b_band)
    cases = [(nm, *model, "banded_model")
             for nm in ("pipe_pr_cg", "pipe_p_cg", "hs_cg", "cg_cg", "gv_cg",
                        "pr_cg")]
    cases += [(nm, *band, "scaled_band")
              for nm in ("pipe_pr_pcg", "pipe_p_pcg", "hs_pcg", "pr_pcg",
                         "cg_pcg", "gv_pcg")]
    compare_f64(torch, "dia_f64", cases, dia_expected)

    dense = as_operator(dense_spd(torch, DENSE_N), device="cpu")
    compare_f64(torch, "dia_f64",
                [("pipe_pr_cg", dense, dense.todense() @ np.ones(DENSE_N),
                  "dense_spd")], lambda name, iters: ({}, None))


def dense_spd(torch, n, seed=0, device="cpu"):
    """A dense SPD matrix (float64 numpy) with eigenvalues spread
    geometrically over [1e-4, 1]: Q diag(l) Q^T, Q from the QR of a random
    matrix made with numpy (factored on ``device``)."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, n)))
    q, _ = torch.linalg.qr(g.to(device))
    lam = torch.logspace(-4, 0, n, dtype=torch.float64, device=device)
    a = (q * lam) @ q.T
    return ((a + a.T) / 2.0).cpu().numpy()


# ---------------------------------------------------------------------------
# The double-word mode (dtype="f32x2"): kernel rows 9-11
# ---------------------------------------------------------------------------

#: float32 operations per second outside the tensor cores counting no fused
#: multiply-add (the double-word kernels may use none): 132 SMs x 128 lanes x
#: 1.98 GHz
PEAK_F32_NO_FMA = 132 * 128 * 1.98e9
#: float32 operations per stored value and right-hand side: row 9 (error-free
#: product 25, renormalisation 3, double-word addition 20), row 10 (product
#: 25, one tree addition 20); per row of the vector phase (5 products of 26,
#: 5 additions of 20, 2 negations, 4 dot terms of 23, 4 tree additions of 20)
DF_OPS = {"dia": 48, "dense": 45, "pipe": 5 * 26 + 5 * 20 + 4 + 4 * 23 + 80}
#: (n, label, offsets) of the double-word DIA checks: the path's band, the
#: wide grid band, ragged n, n below one tile, offsets not symmetric
DF_DIA_SHAPES = (DIA_SHAPES[0], WIDE_SHAPE) + DIA_SHAPES[1:]
#: dense checks: the dense path's n, n = 8192 (timed too), ragged n, n below
#: the 256 threads of a row
DF_DENSE_NS = (4096, 8192, 1000, 300, 5, 1)
DF_DENSE_N = 4096
#: vector-phase checks: n = 655,360 gives 2560 tiles of 256 rows (not a power
#: of two), 4,194,304 gives 16,384; then 3, 5, 6, 7 and 1 tiles, and the
#: dense path's n (16)
DF_PIPE_NS = (N, WIDE_N, 3 * 256, 5 * 256 - 7, 6 * 256, 7 * 256 - 1, 100,
              DF_DENSE_N)
#: suffix of the records at the dense path's shape
DENSE = " (dense path)"
DF_DOT_TOL = 1e-12
DF_OTHER_ITERS = 20
DF_DENSE_ITERS = 100
DF_CPU_N = 65_536
DF_ACCURACY_N = 65_536
DF_ACCURACY_ITERS = 300


def df_vec(torch, rng, n):
    """A random double-word vector on the card, as a word pair."""
    from new_cg_variants_tpu_torch import df_split

    v = df_split(rng.standard_normal(n), device="cuda")
    return v.hi, v.lo


def df_scalar(x):
    from new_cg_variants_tpu_torch import df_split

    v = df_split(np.float64(x), device="cuda")
    return v.hi, v.lo


def bitwise_err(pairs_got, pairs_want):
    """Largest |difference| over all words, and whether all are equal."""
    errs = [float((g - w).abs().max()) for gp, wp in zip(pairs_got, pairs_want)
            for g, w in zip(gp, wp)]
    return max(errs), all(e == 0.0 for e in errs)


def df_bound(nbytes, ops, rate):
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / PEAK_F32_NO_FMA * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)


def check_df_dia(torch, card, timings, report):
    """Row 9 against its plain version: every word equal."""
    from new_cg_variants_tpu_torch import df_split3
    from new_cg_variants_tpu_torch.ops import df_spmv as ds
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp

    rate = memory_rate(card)
    failed = []
    for n, k, offs in DF_DIA_SHAPES:
        rng = np.random.default_rng(3 * n + len(offs))
        data = random_dia(torch, offs, n, torch.float64, rng)
        band = df_split3(data.cpu().numpy(), device="cuda")
        v, w = df_vec(torch, rng, n), df_vec(torch, rng, n)
        got1 = ds.df_dia_spmv(offs, *band, v)
        got2 = ds.df_dia_spmv2(offs, *band, v, w)
        torch.cuda.synchronize()
        want = [ds._df_dia_mv_plain(offs, *band, *x) for x in (v, w)]
        err, same = bitwise_err([got1, *got2], [want[0], *want])
        rec = dict(kernel="df_dia_spmv", n=n, k=k, ndiag=len(offs),
                   staged=sp.stages_window(offs), max_abs_err=err,
                   bitwise=same, tol=0.0)
        if timings is not None and (n, k, offs) == DF_DIA_SHAPES[0]:
            nd = len(offs)
            ms = time_ms(torch, lambda: ds.df_dia_spmv(offs, *band, v), 20)
            ms2 = time_ms(torch, lambda: ds.df_dia_spmv2(offs, *band, v, w),
                          20)
            plain_ms = time_ms(
                torch, lambda: ds._df_dia_mv_plain(offs, *band, *v), 3)
            plain2_ms = time_ms(torch, lambda: [
                ds._df_dia_mv_plain(offs, *band, *x) for x in (v, w)], 3)
            v64, w64 = (torch.randn(n, dtype=torch.float64, device="cuda")
                        for _ in range(2))
            f64_ms = time_ms(torch, lambda: sp.dia_spmv(offs, data, v64), 20)
            f64_2_ms = time_ms(
                torch, lambda: sp.dia_spmv2(offs, data, v64, w64), 20)
            common = dict(n=n, k=k, max_abs_err=err, library_ms=None,
                          f64_counterpart="dia_spmv / dia_spmv2 on the "
                          "float64 band (not the same function)")
            timings["df_dia_spmv"] = dict(
                common, ms=ms, plain_ms=plain_ms, f64_counterpart_ms=f64_ms,
                **df_bound((3 * nd + 4) * n * 4, DF_OPS["dia"] * nd * n,
                           rate))
            timings["df_dia_spmv2"] = dict(
                common, ms=ms2, plain_ms=plain2_ms,
                f64_counterpart_ms=f64_2_ms,
                **df_bound((3 * nd + 8) * n * 4, DF_OPS["dia"] * nd * 2 * n,
                           rate))
            rec.update(ms=ms, spmv2_ms=ms2, plain_ms=plain_ms,
                       plain2_ms=plain2_ms, f64_ms=f64_ms, f64_2_ms=f64_2_ms,
                       **{key: timings["df_dia_spmv2"][key] for key in (
                           "bound_ms", "bound_by", "bound_bytes_ms",
                           "bound_ops_ms")})
            del v64, w64
        report(rec)
        if not same:
            failed.append(rec)
        del data, band, v, w, got1, got2, want
        torch.cuda.empty_cache()
    return failed


def check_df_dense(torch, card, timings, report):
    """Row 10 against its plain version: every word equal."""
    from new_cg_variants_tpu_torch import df_split3
    from new_cg_variants_tpu_torch.ops import df_spmv as ds

    rate = memory_rate(card)
    failed = []
    for n in DF_DENSE_NS:
        rng = np.random.default_rng(n)
        a64 = rng.uniform(-1.0, 1.0, (n, n))
        mats = df_split3(a64, device="cuda")
        v, w = df_vec(torch, rng, n), df_vec(torch, rng, n)
        got1 = ds.df_dense_spmv(*mats, v)
        got2 = ds.df_dense_spmv2(*mats, v, w)
        torch.cuda.synchronize()
        want = [ds._df_dense_mv_plain(*mats, *x) for x in (v, w)]
        err, same = bitwise_err([got1, *got2], [want[0], *want])
        rec = dict(kernel="df_dense_spmv", n=n, max_abs_err=err, bitwise=same,
                   tol=0.0)
        if timings is not None and n in (4096, 8192):
            ms = time_ms(torch, lambda: ds.df_dense_spmv(*mats, v), 20)
            ms2 = time_ms(torch, lambda: ds.df_dense_spmv2(*mats, v, w), 20)
            plain_ms = time_ms(torch,
                               lambda: ds._df_dense_mv_plain(*mats, *v), 3)
            plain2_ms = time_ms(torch, lambda: [
                ds._df_dense_mv_plain(*mats, *x) for x in (v, w)], 3)
            a_dev = torch.from_numpy(a64).cuda()
            x64 = torch.randn(n, dtype=torch.float64, device="cuda")
            f64_ms = time_ms(torch, lambda: torch.mv(a_dev, x64), 20)
            x2 = torch.randn(n, 2, dtype=torch.float64, device="cuda")
            f64_2_ms = time_ms(torch, lambda: a_dev @ x2, 20)
            del a_dev
            b1 = df_bound((3 * n * n + 4 * n) * 4, DF_OPS["dense"] * n * n,
                          rate)
            b2 = df_bound((3 * n * n + 8 * n) * 4,
                          DF_OPS["dense"] * 2 * n * n, rate)
            rec.update(ms=ms, spmv2_ms=ms2, plain_ms=plain_ms,
                       plain2_ms=plain2_ms, f64_mv_ms=f64_ms,
                       f64_mm2_ms=f64_2_ms, bound=b1, spmv2_bound=b2)
            if n == DF_DENSE_N:
                common = dict(n=n, max_abs_err=err, library_ms=None,
                              f64_counterpart="torch.mv / torch.matmul on "
                              "the float64 matrix (not the same function)")
                timings["df_dense_spmv"] = dict(
                    common, ms=ms, plain_ms=plain_ms,
                    f64_counterpart_ms=f64_ms, **b1)
                timings["df_dense_spmv2"] = dict(
                    common, ms=ms2, plain_ms=plain2_ms,
                    f64_counterpart_ms=f64_2_ms, **b2)
        report(rec)
        if not same:
            failed.append(rec)
        del mats, v, w, got1, got2, want
        torch.cuda.empty_cache()
    return failed


def tile_order_dots(torch, r2, p2, s2):
    """Row 11's four dots in its kernel's order, from the word pairs of r2, p2
    and s2: each row's term as the plain version forms it, the double-word
    halving tree over each tile of KERNEL_TILE rows (rows past n are zero
    pairs), then over the tiles' partials padded with zero pairs to a power
    of two.  Returns (hi, lo) pairs of 0-d tensors."""
    from new_cg_variants_tpu_torch.ops import compensated as tc
    from new_cg_variants_tpu_torch.ops._kernels import KERNEL_TILE

    n = r2[0].shape[0]
    tiles = -(-n // KERNEL_TILE)
    dots = []
    for a, b in ((p2, s2), (r2, s2), (s2, s2), (r2, r2)):
        ph, e = tc.two_prod(a[0], b[0])
        e = e + (a[0] * b[1] + a[1] * b[0] + a[1] * b[1])
        words = [torch.nn.functional.pad(w, (0, tiles * KERNEL_TILE - n))
                 .reshape(tiles, KERNEL_TILE) for w in (ph, e)]
        dots.append(tc._df_tree_sum(*tc._df_sum_axis1(*words)))
    return dots


def launches_per_call(torch, fn):
    """Device kernels one call of ``fn`` launches, from ``torch.profiler``;
    ``None`` where the profiler saw no device activity (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events()) or None


def check_df_pipe(torch, card, timings, report):
    """Row 11 against its plain version: the ten vector words equal, the four
    dots within DF_DOT_TOL of float64 (in units of sum |a_i b_i|) and equal
    to the kernel's tile order (tile_order_dots).  Two calls back to back on
    different data are both held so (a ticket counter left set, or a combine
    that reads stale partials, fails the second), and a third call on the
    first data must repeat its dots bit for bit.  A call on the second data
    on a side stream, free to run at the same time as the first call on the
    current one, must give the second call's bits (each stream has its own
    ticket counter)."""
    from new_cg_variants_tpu_torch.ops import df_spmv as ds
    from new_cg_variants_tpu_torch.ops import fused_step as fs

    rate = memory_rate(card)
    failed = []
    a1, beta = df_scalar(0.3712345678901234), df_scalar(0.1298765432109876)
    for n in DF_PIPE_NS:
        rng = np.random.default_rng(n + 11)
        vecs = [df_vec(torch, rng, n) for _ in range(6)]
        others = [df_vec(torch, rng, n) for _ in range(6)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got_side = ds.df_pipe_vector_phase(*others, a1, beta)
        got = ds.df_pipe_vector_phase(*vecs, a1, beta)
        got_b = ds.df_pipe_vector_phase(*others, a1, beta)
        again = ds.df_pipe_vector_phase(*vecs, a1, beta)
        torch.cuda.synchronize()
        side_same = (bitwise_err(got_side[:5], got_b[:5])[1]
                     and bitwise_err(got_side[5], got_b[5])[1])
        errs, dot_errs, in_order = [], [], []
        for out, ins in ((got, vecs), (got_b, others)):
            want = ds._df_pipe_vector_phase_plain(*ins, a1, beta)
            errs.append(bitwise_err(out[:5], want[:5]))
            _, r2, _, p2, s2 = (hi.double() + lo.double()
                                for hi, lo in out[:5])
            for (gh, gl), (a, b) in zip(out[5], ((p2, s2), (r2, s2),
                                                 (s2, s2), (r2, r2))):
                dot_errs.append(float((gh.double() + gl.double()
                                       - torch.dot(a, b)).abs()
                                      / torch.dot(a.abs(), b.abs())))
            model = tile_order_dots(torch, want[1], want[3], want[4])
            in_order.append(bitwise_err(out[5], model)[1])
            del want, r2, p2, s2
        same = all(e[1] for e in errs)
        repeat = bitwise_err(again[5], got[5])[1]
        rec = dict(kernel="df_pipe_vector_phase", n=n,
                   tiles=-(-n // 256), max_abs_err=max(e[0] for e in errs),
                   bitwise=same, max_dot_err=max(dot_errs),
                   dots_in_tile_order=all(in_order),
                   back_to_back_held=errs[1][1] and in_order[1]
                   and max(dot_errs[4:]) <= DF_DOT_TOL,
                   repeat_same_bits=repeat, side_stream_same_bits=side_same,
                   tol=0.0, dot_tol=DF_DOT_TOL)
        key = {N: "df_pipe_vector_phase",
               DF_DENSE_N: "df_pipe_vector_phase" + DENSE}.get(n)
        if timings is not None and key:
            def call():
                return ds.df_pipe_vector_phase(*vecs, a1, beta)

            ms = time_ms(torch, call, 50)
            plain_ms = time_ms(torch, lambda: ds._df_pipe_vector_phase_plain(
                *vecs, a1, beta), 3)
            x64 = [torch.randn(n, dtype=torch.float64, device="cuda")
                   for _ in range(6)]
            c64 = [torch.tensor(c, dtype=torch.float64, device="cuda")
                   for c in (0.37, 0.13)]
            f64_ms = time_ms(
                torch, lambda: fs.fused_pipe_vector_phase(*x64, *c64), 50)
            per_call = launches_per_call(torch, call)
            timings[key] = dict(
                n=n, max_abs_err=rec["max_abs_err"], ms=ms, plain_ms=plain_ms,
                library_ms=None, f64_counterpart_ms=f64_ms,
                f64_counterpart="fused_pipe_vector_phase in float64 (not the "
                "same function)", launches_per_call=per_call,
                **df_bound(22 * n * 4, DF_OPS["pipe"] * n, rate))
            rec.update(ms=ms, plain_ms=plain_ms, f64_ms=f64_ms,
                       bound=timings[key]["bound_ms"],
                       launches_per_call=per_call)
            del x64
        report(rec)
        if not (same and max(dot_errs) <= DF_DOT_TOL and all(in_order)
                and repeat and side_same
                and rec.get("launches_per_call") in (None, 1)):
            failed.append(rec)
        del vecs, others, got, got_b, again, got_side
        torch.cuda.empty_cache()
    return failed


def df_checks(torch, card, timings, report):
    """Every double-word kernel entry against its plain version; returns the
    failed checks."""
    return (check_df_dia(torch, card, timings, report)
            + check_df_dense(torch, card, timings, report)
            + check_df_pipe(torch, card, timings, report))


def check_df(torch, card, timings):
    failed = df_checks(torch, card, timings, emit_check)
    if failed:
        raise AssertionError(
            f"{len(failed)} double-word checks disagree: {failed}")


def df_expected(name, iters, product="df_dia_spmv"):
    """Launches a name makes in the double-word mode: every fused phase
    declines, so the generic bodies' products (``product``, and its 2-RHS
    entry for the pipe names that recompute), and the vector-phase kernel
    for the unpreconditioned pipe names."""
    base = name.rsplit("_", 1)[0]
    counts = {product: GENERIC_INIT_SPMVS.get(base, 3)}
    if base in ("pipe_pr", "pipe_pr_m"):
        counts[product + "2"] = iters
    else:
        counts[product] += iters
    if base.startswith("pipe") and name.endswith("_cg"):
        counts["df_pipe_vector_phase"] = iters
    return counts, product


def df_f32x2(torch):
    """The double-word path at full width: pipe-PR-CG in f32x2 on the model
    problem built in float64 (expanded to 63 diagonals, split exactly), 300
    iterations, launches asserted, the profiler's launches per iteration;
    the other 17 names for DF_OTHER_ITERS iterations; plain-float64
    pipe-PR-CG on the same problem beside it."""
    from new_cg_variants_tpu_torch import (
        VARIANT_NAMES,
        DiaOperator,
        banded_model,
        df_operator,
    )
    from new_cg_variants_tpu_torch.ops.doublefloat import (
        DoubleFloatContext,
        df_split,
    )
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES

    sym, b64, x_true = banded_model(N, k=K_BAND, device="cpu")  # float64
    t0 = time.perf_counter()
    dop = df_operator(sym, device="cuda")
    split_s = time.perf_counter() - t0
    offsets, full = sym.todia_host()
    op64 = DiaOperator(offsets, torch.from_numpy(full).cuda())
    del full
    b = torch.from_numpy(b64).cuda()
    emit("df_f32x2", n=N, ndiag=len(dop.inner.offsets), split_seconds=split_s,
         word_bytes=3 * dop.inner.data.numel() * 4)
    launches, failed = solve_names(
        torch, "df_f32x2", dop, b, x_true, ("pipe_pr_cg",), df_expected,
        iters=VARIANT_ITERS, dtype="f32x2", plain_op=op64, n=N, k=K_BAND)
    init_fn, step_fn = FAMILIES["pipe_pr"]
    ctx = DoubleFloatContext(dop)
    state = init_fn(ctx, df_split(b64, device="cuda"),
                    df_split(np.zeros(N), device="cuda"))
    emit("df_f32x2", variant="pipe_pr_cg", profile=profile_steps(
        torch, ctx, step_fn, state))
    del state, ctx
    names = [nm for nm in VARIANT_NAMES if nm != "pipe_pr_cg"]
    more, failed2 = solve_names(
        torch, "df_f32x2", dop, b, x_true, names, df_expected,
        iters=DF_OTHER_ITERS, dtype="f32x2", plain_op=op64, n=N, k=K_BAND)
    f64, failed3 = solve_names(
        torch, "df_f32x2", op64, b, x_true, ("pipe_pr_cg",), dia_expected,
        n=N, k=K_BAND, dtype=torch.float64, path="plain float64, beside")
    failed += failed2 + failed3
    for key, val in more.items():
        launches[key] = launches.get(key, 0) + val
    if failed:
        raise AssertionError(f"{len(failed)} f32x2 runs failed: {failed}")
    return launches


def df_dense_f32x2(torch):
    """pipe-PR-CG in f32x2 on a dense SPD operator (n = 4096): row 10 (2
    right-hand sides) and row 11 once per iteration; the profiler's launches
    per iteration."""
    from new_cg_variants_tpu_torch import DenseOperator, df_operator
    from new_cg_variants_tpu_torch.ops.doublefloat import (
        DoubleFloatContext,
        df_split,
    )
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES

    a = dense_spd(torch, DF_DENSE_N, device="cuda")
    dop = df_operator(a, device="cuda")
    op64 = DenseOperator(torch.from_numpy(a).cuda())
    x_true = np.ones(DF_DENSE_N)
    b = op64.mv(torch.ones(DF_DENSE_N, dtype=torch.float64, device="cuda"))
    launches, failed = solve_names(
        torch, "df_dense_f32x2", dop, b, x_true, ("pipe_pr_cg",),
        lambda name, iters: df_expected(name, iters, "df_dense_spmv"),
        iters=DF_DENSE_ITERS, dtype="f32x2", plain_op=op64, n=DF_DENSE_N)
    if failed:
        raise AssertionError(f"dense f32x2 run failed: {failed}")
    init_fn, step_fn = FAMILIES["pipe_pr"]
    ctx = DoubleFloatContext(dop)
    state = init_fn(ctx, df_split(b.cpu().numpy(), device="cuda"),
                    df_split(np.zeros(DF_DENSE_N), device="cuda"))
    emit("df_dense_f32x2", variant="pipe_pr_cg", profile=profile_steps(
        torch, ctx, step_fn, state))
    return launches


def df_card_vs_cpu(torch):
    """f32x2 on the card (kernels) against the CPU (plain versions) on the
    same words, 25 iterations: collapsed nu and alpha to rtol 1e-10; and the
    one-shot check that the error words survive, on the card."""
    from new_cg_variants_tpu_torch import as_operator, banded_model
    from new_cg_variants_tpu_torch.solvers import api

    api._DF_CHECKED.discard("cuda")
    api._df_selfcheck(torch.device("cuda"))
    emit("df_card_vs_cpu", selfcheck="passed on the card")
    sym, b64, _ = banded_model(DF_CPU_N, k=K_BAND, device="cpu")
    band = scaled_band(torch, DF_CPU_N, K_BAND)
    cases = [(nm, sym, b64, "banded_model")
             for nm in ("pipe_pr_cg", "pipe_p_cg", "pr_cg", "gv_cg")]
    cases += [(nm, *band, "scaled_band") for nm in ("pipe_pr_pcg", "hs_pcg")]
    compare_f64(torch, "df_card_vs_cpu", cases, df_expected, dtype="f32x2")
    dense = as_operator(dense_spd(torch, DENSE_N), device="cpu")
    compare_f64(torch, "df_card_vs_cpu",
                [("pipe_pr_cg", dense, dense.todense() @ np.ones(DENSE_N),
                  "dense_spd")],
                lambda name, iters: df_expected(name, iters, "df_dense_spmv"),
                dtype="f32x2")


def df_accuracy(torch):
    """The outcome the mode exists for: on the diagonal model spectrum at
    kappa = 1e6 (n = 65,536, rho = 0.5) float32 stalls near 1e-5 relative
    A-norm error, f32x2 reaches 1e-10."""
    from new_cg_variants_tpu_torch import model_spectrum, run

    op, b, x_true = model_spectrum(DF_ACCURACY_N, kappa=1e6, rho=0.5,
                                   device="cpu")
    kw = dict(max_iter=DF_ACCURACY_ITERS, probes=("error_A_norm",),
              x_true=x_true, device="cuda")
    best = {}
    for label, o, dt in (("float32", op.astype(torch.float32), None),
                         ("f32x2", op, "f32x2"), ("float64", op, None)):
        t0 = time.perf_counter()
        out = run("pipe_pr_cg", o, b, dtype=dt, **kw)
        rel = out["error_A_norm"] / out["error_A_norm"][0]
        best[label] = dict(best_rel_A_err=float(np.nanmin(rel)),
                           at_iteration=int(np.nanargmin(rel)),
                           seconds=time.perf_counter() - t0)
    emit("df_accuracy", n=DF_ACCURACY_N, kappa=1e6, iterations=DF_ACCURACY_ITERS,
         **best)
    if not (best["f32x2"]["best_rel_A_err"] <= 1e-10
            and best["float32"]["best_rel_A_err"] >= 1e-7):
        raise AssertionError(f"f32x2 accuracy outcome not met: {best}")


# ---------------------------------------------------------------------------
# General sparse input: kernel row 12 and the format layer
# ---------------------------------------------------------------------------

#: HPCG's standard local grid: the 27-point operator on 104^3 points
HPCG_GRID = 104
#: the 27-point operator of sparse_f64 (small enough for the CPU side)
HPCG_SMALL_GRID = 32
#: seed of the symmetric permutation that stands in for an unstructured
#: mesh's numbering
PERM_SEED = 2024
ELL_ITERS = 300
ELL_RTOL = 1e-6
ELL_MAX_ITER = 3000
FORMATS_ITERS = 300
SPARSE_F64_N = 65_536
#: (label, n, row lengths) of the small ELL checks: ragged rows of 0..9
#: entries (rows of padding only among them), n below one block, L = 1
ELL_SMALL = (("ragged", 4099, (0, 10)), ("n=100", 100, (1, 6)),
             ("L=1", 1000, (1, 2)))
#: suffix of the timings at HPCG's pattern in natural order (the path's
#: shape is the permuted one)
NATURAL = " (natural order)"


def stencil27(grid, perm_seed=None):
    """HPCG's operator as scipy CSR (float64): the 27-point stencil on a
    grid^3, diagonal 26, -1 to every neighbour, Dirichlet boundary.
    ``perm_seed``: rows and columns under one seeded random permutation."""
    import scipy.sparse as sp

    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(grid, grid),
                 format="csr")
    a = (27.0 * sp.eye(grid ** 3, format="csr")
         - sp.kron(sp.kron(t, t), t, format="csr")).tocsr()
    return permuted(a, perm_seed)


def permuted(a, perm_seed):
    """``P A P^T`` for a seeded random permutation (``None``: ``a``), CSR
    with sorted indices."""
    if perm_seed is not None:
        p = np.random.default_rng(perm_seed).permutation(a.shape[0])
        a = a[p][:, p].tocsr()
    a.sort_indices()
    return a


def model_csr(n, perm_seed=None):
    """The PETSc model problem (k = 32) as scipy CSR, float64, permuted or
    not; with ``b = A 1`` in the same order."""
    from new_cg_variants_tpu_torch import banded_model

    op, _, _ = banded_model(n, k=K_BAND, fmt="dia", device="cpu")
    a = permuted(op.tocsr(), perm_seed)
    return a, a @ np.ones(n)


def ell_arrays(torch, a, rng, dtype):
    """The padded-ELL arrays of ``a``'s pattern with O(1) random values on
    its entries (padding stays 0), on the card: ``(val, idx)`` as ``(n, L)``
    views of slot-major storage, and the same matrix as a CUDA CSR tensor
    (the library's yardstick)."""
    from new_cg_variants_tpu_torch.ops.operators import build_ell, coo_from_scipy

    val, idx, _ = build_ell(coo_from_scipy(a))
    real = val.T != 0.0
    val_t = np.zeros(val.T.shape)
    val_t[real] = rng.uniform(-1.0, 1.0, int(real.sum()))
    vt = torch.from_numpy(val_t).to(device="cuda", dtype=dtype)
    it = torch.from_numpy(np.ascontiguousarray(idx.T)).cuda()
    rows = np.broadcast_to(np.arange(a.shape[0]), val_t.shape)[real]
    order = np.lexsort((idx.T[real], rows))
    counts = np.bincount(rows, minlength=a.shape[0])
    crow = np.concatenate([[0], np.cumsum(counts)])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(crow).cuda(),
        torch.from_numpy(idx.T[real][order].astype(np.int64)).cuda(),
        torch.from_numpy(val_t[real][order]).to(device="cuda", dtype=dtype),
        size=a.shape)
    return vt.T, it.T, csr


def small_pattern(n, lens, rng):
    """A random pattern of ``n`` rows with lengths in ``range(*lens)``, as
    scipy CSR (the values are replaced by ell_arrays)."""
    import scipy.sparse as sp

    counts = rng.integers(lens[0], lens[1], n)
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, n, counts.sum())
    return sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))


def locality_order(a):
    """The order an ``EllOperator`` keeps for ``a`` (``from_coo``'s rule:
    RCM where it narrows the band), or ``None`` for the given order."""
    from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy, ell_order

    perm = ell_order(coo_from_scipy(a))
    return None if perm is None else np.asarray(perm)


def check_ell_shape(torch, label, a, rng, dtype, rate, timings, report,
                    perm=None, sfx=None):
    """Both ELL entries against their plain versions on one pattern, in the
    given order and, with ``perm``, in that locality order (storage
    reordered, gather in, scatter out): the locality order's products must
    equal the given order's bit for bit, and its gather in ``v[perm]``.
    Timed (with the plain versions, cuSPARSE and the bound) when
    ``timings``, into records named with ``sfx`` (default: none for a
    permuted pattern, NATURAL else)."""
    from new_cg_variants_tpu_torch.ops import ell_spmv as es

    val, idx, csr = ell_arrays(torch, a, rng, dtype)
    n, L = val.shape
    v, w = (torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                            device="cuda") for _ in range(2))
    y = es.ell_spmv(val, idx, v)
    y2, z2 = es.ell_spmv2(val, idx, v, w)
    yp, zp = (es._ell_mv_plain(val, idx, x) for x in (v, w))
    ys, zs = (es._ell_mv_plain(val.abs(), idx, x.abs()) for x in (v, w))
    got = [(y, yp, ys), (y2, yp, ys), (z2, zp, zs)]
    dn = dtype_name(dtype)
    rec = dict(kernel="ell_spmv", shape=label, dtype=dn, n=n, L=L,
               nnz=int(csr.values().numel()), orders=["given"])
    ok = True
    if perm is not None:
        p = es.check_perm(torch.from_numpy(perm).cuda(), n)
        bval_t, bidx_t = es.reorder(val.T, idx.T, p)
        bval, bidx = bval_t.T, bidx_t.T
        ry = es.ell_spmv(bval, bidx, v, p)
        ry2, rz2 = es.ell_spmv2(bval, bidx, v, w, p)
        gathered, gather_want = es.ell_gather(p, [v]), v[p.long()]
        got += [(ry, yp, ys), (ry2, yp, ys), (rz2, zp, zs)]
        same = all(bool(torch.equal(g, want)) for g, want in (
            (ry, y), (ry2, y2), (rz2, z2)))
        gather_err = float((gathered - gather_want).abs().max())
        gather_same = bool(torch.equal(gathered, gather_want))
        rec.update(orders=["given", "locality"], same_bits_as_given=same,
                   gather_bitwise=gather_same)
        ok = same and gather_same
    torch.cuda.synchronize()
    errs = [cw_err(torch, g, want, sc) for g, want, sc in got]
    abs_err = max(float((g - want).abs().max()) for g, want, _ in got)
    rec.update(max_err=max(errs), max_abs_err=abs_err, tol=TOL[dn])
    if timings is not None:
        isz = val.element_size()
        b_ms, b_by = bound(n * L * (isz + 4) + 2 * n * isz, 2 * n * L, dn,
                           rate)
        b2_ms, b2_by = bound(n * L * (isz + 4) + 4 * n * isz, 4 * n * L, dn,
                             rate)
        given = dict(
            ms=time_ms(torch, lambda: es.ell_spmv(val, idx, v), 50),
            spmv2_ms=time_ms(torch, lambda: es.ell_spmv2(val, idx, v, w), 50))
        plain_ms = time_ms(torch, lambda: es._ell_mv_plain(val, idx, v), 5)
        plain2_ms = time_ms(torch,
                            lambda: es._ell_mv2_plain(val, idx, v, w), 5)
        vw = torch.stack([v, w], dim=1)
        lib_err = cw_err(torch, csr @ v, yp, ys)
        lib_ms = time_ms(torch, lambda: csr @ v, 50)
        lib2_ms = time_ms(torch, lambda: csr @ vw, 50)
        common = dict(n=n, L=L, max_abs_err=abs_err,
                      library="cuSPARSE CSR through torch (csr @ v, "
                      "csr @ [v w])")
        rec.update(given_order_ms=given["ms"],
                   given_order_spmv2_ms=given["spmv2_ms"], plain_ms=plain_ms,
                   plain2_ms=plain2_ms, library_ms=lib_ms,
                   library2_ms=lib2_ms, library_err=lib_err, bound_ms=b_ms,
                   bound_by=b_by, spmv2_bound_ms=b2_ms)
        if perm is None:
            ms, ms2 = given["ms"], given["spmv2_ms"]
        else:
            ms = time_ms(torch, lambda: es.ell_spmv(bval, bidx, v, p), 50)
            ms2 = time_ms(torch, lambda: es.ell_spmv2(bval, bidx, v, w, p),
                          50)
            plain_ms = time_ms(
                torch, lambda: es._ell_reordered_plain(bval, bidx, p, [v]), 5)
            plain2_ms = time_ms(torch, lambda: es._ell_reordered_plain(
                bval, bidx, p, [v, w]), 5)
            g_ms = time_ms(torch, lambda: es.ell_gather(p, [v]), 50)
            g2_ms = time_ms(torch, lambda: es.ell_gather(p, [v, w]), 50)
            g_plain_ms = time_ms(torch, lambda: es._ell_gather_plain(p, [v]),
                                 50)
            g_lib_ms = time_ms(torch, lambda: torch.index_select(v, 0, p), 50)
            g_ms_bound, g_by = bound(n * (4 + 2 * isz), 0, dn, rate)
            rec.update(ms=ms, spmv2_ms=ms2, locality_plain_ms=plain_ms,
                       locality_plain2_ms=plain2_ms, gather_ms=g_ms,
                       gather2_ms=g2_ms)
            timings["ell_gather" + (sfx or "")] = dict(
                n=n, max_abs_err=gather_err,
                ms=g_ms, ms_2rhs=g2_ms, plain_ms=g_plain_ms,
                library_ms=g_lib_ms, library="torch.index_select(v, 0, perm)",
                bound_ms=g_ms_bound, bound_by=g_by)
            common["given_order"] = given
            del bval, bidx, p
        if sfx is None:
            sfx = "" if "permuted" in label else NATURAL
        timings["ell_spmv" + sfx] = dict(
            common, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by)
        timings["ell_spmv2" + sfx] = dict(
            common, ms=ms2, plain_ms=plain2_ms, library_ms=lib2_ms,
            bound_ms=b2_ms, bound_by=b2_by)
        del vw
    report(rec)
    del val, idx, csr, v, w
    torch.cuda.empty_cache()
    return [] if ok and max(errs) <= TOL[dn] else [rec]


def ell_checks(torch, card, timings, report):
    """Row 12 (``ell_spmv``, ``ell_spmv2`` and the gather in) against its
    plain version on the card in float32 and float64, every value in units
    of its own scale ``(|A| |v|)_i``: HPCG's pattern at full size in natural
    order (which the operator keeps) and permuted (in the RCM order the
    operator takes, and in the given one: timed in float32), then the small
    shapes in the given order and in a locality order (RCM, or a random one
    where RCM does not narrow the band).  Returns the failed checks."""
    rate = memory_rate(card)
    failed = []
    grid = f"27-point {HPCG_GRID}^3"
    for label, seed in ((grid, None), (grid + " permuted", PERM_SEED)):
        a = stencil27(HPCG_GRID, seed)
        perm = locality_order(a)
        for dtype in (torch.float32, torch.float64):
            failed += check_ell_shape(
                torch, label, a, np.random.default_rng(12), dtype, rate,
                timings if timings is not None and dtype == torch.float32
                else None, report, perm)
        del a
    for label, n, lens in ELL_SMALL:
        rng = np.random.default_rng(n)
        a = small_pattern(n, lens, rng)
        perm = locality_order(a)
        if perm is None:
            perm = rng.permutation(n)
        for dtype in (torch.float32, torch.float64):
            failed += check_ell_shape(torch, label, a, rng, dtype, rate, None,
                                      report, perm)
    return failed


def check_ell(torch, card, timings):
    failed = ell_checks(torch, card, timings, emit_check)
    if failed:
        raise AssertionError(f"{len(failed)} ELL checks disagree: {failed}")


def ell_expected(name, iters):
    """Launches a name makes on an ``EllOperator`` in a locality order (as
    both ELL phases build it): every fused phase declines, so the generic
    body: ``ell_spmv2`` once per iteration for the pipe names that
    recompute, else ``ell_spmv`` once per product (and the products of
    init), each after one gather in (``ell_gather``)."""
    split, _ = split_expected(name, iters)
    counts = {"ell_spmv": split["dia_spmv"]}
    if "dia_spmv2" in split:
        counts["ell_spmv2"] = split["dia_spmv2"]
    counts["ell_gather"] = sum(counts.values())
    return counts, "ell_spmv"


def ell_f32(torch):
    """HPCG's operator (27-point, 104^3) under a random symmetric
    permutation, handed over as scipy CSR in float32: the auto route must
    pick ELL (with its warning); all 18 names on the one operator, each
    product one row-12 launch; one solve that converges."""
    import warnings

    from new_cg_variants_tpu_torch import (
        VARIANT_NAMES,
        EllOperator,
        as_operator,
        solve,
    )
    from new_cg_variants_tpu_torch.solvers.context import Context
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES

    t0 = time.perf_counter()
    a = stencil27(HPCG_GRID, PERM_SEED).astype(np.float32)
    matrix_s = time.perf_counter() - t0
    n = a.shape[0]
    x_true = np.ones(n, dtype=np.float32)
    b = torch.from_numpy(a @ x_true).cuda()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        op = as_operator(a, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warned = any("gather-ELL" in str(c.message) for c in caught)
    is_ell = isinstance(op, EllOperator)
    reordered = is_ell and op.perm is not None
    emit("ell_f32", n=n, nnz=int(a.nnz), operator=type(op).__name__,
         L=int(op.val_t.shape[0]) if is_ell else None, warned=warned,
         locality_order=reordered, matrix_host_seconds=matrix_s,
         build_host_seconds=build_s)
    if not (reordered and warned):
        raise AssertionError(f"auto route gave {type(op).__name__}, "
                             f"warned={warned}, reordered={reordered}: "
                             "expected ELL in RCM order with a warning")
    launches, failed = solve_names(
        torch, "ell_f32", op, b, x_true, ("pipe_pr_cg",), ell_expected,
        iters=ELL_ITERS, n=n)
    init_fn, step_fn = FAMILIES["pipe_pr"]
    ctx = Context(op)
    emit("ell_f32", variant="pipe_pr_cg", profile=profile_steps(
        torch, ctx, step_fn, init_fn(ctx, b, torch.zeros_like(b))))
    names = [nm for nm in VARIANT_NAMES if nm != "pipe_pr_cg"]
    more, failed2 = solve_names(torch, "ell_f32", op, b, x_true, names,
                                ell_expected, iters=GENERIC_ITERS, n=n)
    failed += failed2
    for key, val in more.items():
        launches[key] = launches.get(key, 0) + val
    t0 = time.perf_counter()
    res = solve(op, b, variant="pipe_pr_cg", rtol=ELL_RTOL,
                max_iter=ELL_MAX_ITER)
    torch.cuda.synchronize()
    xt = torch.from_numpy(x_true).cuda()
    rec = dict(variant="pipe_pr_cg", rtol=ELL_RTOL, converged=res.converged,
               iterations=res.iterations, norm=res.norm,
               seconds=time.perf_counter() - t0,
               rel_forward_error=float(torch.linalg.norm(res.x - xt)
                                       / torch.linalg.norm(xt)),
               rel_residual=float(torch.linalg.norm(b - op.mv(res.x))
                                  / torch.linalg.norm(b)))
    emit("ell_f32", **rec)
    if not (res.converged and np.isfinite(rec["rel_forward_error"])):
        failed.append(rec)
    if failed:
        raise AssertionError(f"{len(failed)} ELL runs failed: {failed}")
    return launches


def host_residual(a, b, x):
    """||b - A x|| / ||b|| on the host in float64 (scipy)."""
    x64 = x.double().cpu().numpy()
    return float(np.linalg.norm(b - a @ x64) / np.linalg.norm(b))


def no_kernel(name, iters):
    return {}, None


def formats_f32(torch):
    """(a) The PETSc model problem as scipy CSR under a random symmetric
    permutation: the auto route must pick the block-banded packing (RCM
    recovers the band); pipe-PR-CG for 300 iterations, ``x`` back in the
    original order, its residual within 10x of the half-band path's on the
    unpermuted problem.  (b) The same problem unpermuted: the auto route must
    pick the stencil; it and ``banded_model(fmt="stencil")`` for 300
    iterations.  No path here reaches a kernel."""
    from new_cg_variants_tpu_torch import (
        BandedStencilOperator,
        as_operator,
        banded_model,
        solve,
    )
    from new_cg_variants_tpu_torch.ops.block_banded import (
        PermutedBlockBandedOperator,
    )

    failed = []

    def timed(op, b, label, a_host, b_host, kernels=False, **fields):
        """pipe-PR-CG for FORMATS_ITERS iterations; without ``kernels`` no
        kernel may launch."""
        reset_counts()
        solve(op, b, variant="pipe_pr_cg", max_iter=5, norm_type="none")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(op, b, variant="pipe_pr_cg", max_iter=FORMATS_ITERS,
                    norm_type="none")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        rec = dict(variant="pipe_pr_cg", operator=label, n=op.n,
                   iterations=res.iterations,
                   ms_per_iter=seconds / FORMATS_ITERS * 1e3,
                   rel_residual=host_residual(a_host, b_host, res.x),
                   launches=counts, **fields)
        emit("formats_f32", **rec)
        if (counts and not kernels) or not np.isfinite(rec["rel_residual"]):
            failed.append(rec)
        return rec

    a, b64 = model_csr(N)
    sym, _, _ = model_f32(torch, "symdia")
    b = torch.from_numpy(b64).to(device="cuda", dtype=torch.float32)
    half = timed(sym, b, "SymDiaOperator (unpermuted, the main path)", a,
                 b64, kernels=True)
    del sym

    t0 = time.perf_counter()
    op = as_operator(a, dtype=torch.float32, device="cuda")
    build_s = time.perf_counter() - t0
    if not isinstance(op, BandedStencilOperator):
        failed.append(dict(operator=type(op).__name__, expected="stencil"))
    timed(op, b, "auto route, unpermuted scipy CSR", a, b64,
          built=type(op).__name__, build_host_seconds=build_s)
    st, _, _ = banded_model(N, k=K_BAND, fmt="stencil", device="cpu")
    timed(st.astype(torch.float32).to("cuda"), b,
          "banded_model(fmt='stencil')", a, b64)
    del op, st

    ap, bp64 = model_csr(N, PERM_SEED)
    bp = torch.from_numpy(bp64).to(device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    op = as_operator(ap, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not (isinstance(op, PermutedBlockBandedOperator)
            and op.inner.bs == 128):
        failed.append(dict(operator=type(op).__name__,
                           expected="block_banded, bs = 128"))
    else:
        rec = timed(op, bp, "auto route, permuted scipy CSR", ap, bp64,
                    built=type(op).__name__, bs=op.inner.bs,
                    block_bytes=op.inner.a_blk.numel() * 4,
                    build_host_seconds=build_s,
                    half_band_rel_residual=half["rel_residual"])
        if not rec["rel_residual"] <= 10 * half["rel_residual"]:
            failed.append(rec)
    if failed:
        raise AssertionError(f"{len(failed)} format runs failed: {failed}")


def sparse_f64(torch):
    """Card against CPU in float64 over 25 iterations on the three new
    operator kinds (one name per family and a Jacobi ``_pcg`` name on
    each), and pipe-PR-CG in f32x2 on an ELL inner."""
    from new_cg_variants_tpu_torch import (
        DiaOperator,
        as_operator,
        banded_model,
        df_operator,
        from_coo,
    )
    from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy

    names = ("hs_cg", "cg_cg", "gv_cg", "pr_cg", "pipe_pr_cg", "pipe_p_cg")
    a27 = stencil27(HPCG_SMALL_GRID, PERM_SEED)
    b27 = a27 @ np.ones(a27.shape[0])
    t0 = time.perf_counter()
    ell = from_coo(coo_from_scipy(a27), fmt="ell", device="cpu")
    emit("sparse_f64", operator="EllOperator", n=ell.n,
         locality_order=ell.perm is not None,
         build_host_seconds=time.perf_counter() - t0)
    compare_f64(torch, "sparse_f64",
                [(nm, ell, b27, "27-point 32^3 permuted, ELL")
                 for nm in names + ("pipe_pr_pcg",)], ell_expected)

    n = SPARSE_F64_N
    bb = as_operator(model_csr(n, PERM_SEED)[0], device="cpu")
    band, _ = scaled_band(torch, n, K_BAND)
    offsets, full = band.todia_host()
    band_csr = permuted(DiaOperator(offsets, torch.from_numpy(full)).tocsr(),
                        PERM_SEED)
    bb_pcg = as_operator(band_csr, device="cpu")
    _, bp = model_csr(n, PERM_SEED)
    cases = [(nm, bb, bp, "model problem permuted, block-banded")
             for nm in names]
    cases.append(("pipe_pr_pcg", bb_pcg, band_csr @ np.ones(n),
                  "scaled band permuted, block-banded"))
    st, b_st, _ = banded_model(n, k=K_BAND, fmt="stencil", device="cpu")
    # Jacobi leaves kappa near 100 here (1 + 62 c = 0.008, diagonal >= 1);
    # on the model problem it converges in six iterations
    st_j, b_j, _ = banded_model(n, k=K_BAND, off_value=-0.016, kappa=10.0,
                                fmt="stencil", device="cpu")
    cases += [(nm, st, b_st, "model problem, stencil") for nm in names]
    cases.append(("pipe_pr_pcg", st_j, b_j,
                  "band of -0.016, stencil"))
    compare_f64(torch, "sparse_f64", cases, no_kernel)

    dell = df_operator(coo_from_scipy(a27), fmt="ell", device="cpu")
    compare_f64(torch, "sparse_f64",
                [("pipe_pr_cg", dell, b27, "27-point 32^3 permuted, "
                  "f32x2 on an ELL inner")],
                lambda name, iters: ({"df_pipe_vector_phase": iters}, None),
                dtype="f32x2")


# ---------------------------------------------------------------------------
# The convergence-measurement layer: figure_gen, the post-hoc probes, the
# command line and the trace parser on the card.

#: (a) HPCG's operator on 32^3 under PERM_SEED: the auto route in float64
#: picks ELL (at 24^3 it picks the block-banded packing)
CONV_GRID = 32
CONV_BAND_N = 65_536
#: (a): 1e-5 at iteration 35 (this phase's rows); the depth leaves the
#: oracle room to exit and the variants room to reach their rounding floor
CONV_ITERS = 150
#: (b): 1e-5 at iteration 154 (this phase's rows); 600 reach the floor
CONV_BAND_ITERS = 600
#: card against CPU on (a) with Jacobi at CONV_ITERS, rows compared twice.
#: Before the rounding floor (the histories cut after CONV_CMP_ITERS) the two
#: converge alike: iterations within CONV_ITER_SLACK, log10 of the best error
#: within CONV_LOG10_TOL.  At the floor the best error is the least of
#: rounding noise, which two summation orders draw differently.  The limits
#: are the largest gaps read, with a margin: `chip_study.py floors` (card
#: against CPU, three permutations, both preconditioners: at most 0.224, and
#: 1.371 for the names the paper finds to lose accuracy, CONV_NOISY) and
#: `tests/torch_floor_gaps.py` (the port against the JAX package on the
#: CPU: 0.385 and 1.464); PERF.md has the readings.  A kernel that falls to
#: float32 leaves its floor above CONV_FLOOR_MAX (the card's highest read:
#: -12.38).
CONV_CMP_ITERS = 50
CONV_ITER_SLACK = 1
CONV_LOG10_TOL = 0.05
CONV_NOISY = ("gv_pcg", "pipe_p_pcg", "pipe_p_m_pcg")
CONV_FLOOR_TOL = 0.5
CONV_NOISY_FLOOR_TOL = 2.0
CONV_FLOOR_MAX = -11.0
#: the post-hoc probes' run: hs_pcg (M = I) on HPCG's operator on 24^3 as
#: ELL (n = 13,824: Lanczos densifies A to 1.5 GB on the host; on 32^3 to
#: 8.6 GB, and the sparse LU's fill, which grows faster than n on a 3-D
#: grid, makes it many times slower)
POSTHOC_GRID = 24
POSTHOC_ITERS = 40
POSTHOC_CHECK_ITERS = (0, 19, 39)
POSTHOC_RTOL = 1e-10
#: suffixes of the kernel records at this slice's float64 shapes
F64_ELL = " (f64, 27-point 32^3 permuted)"
F64_ELL_POSTHOC = " (f64, 27-point 24^3 permuted)"
F64_SYM = " (f64, n=65,536)"
#: the family entries the _pcg names of DEFAULT_VARIANTS take under Jacobi
CONV_SYM_ENTRIES = ("fused_sym_hs_matvec_phase",
                    "fused_sym_cgcg_matvec_phase_prec",
                    "fused_sym_pr_full_step_prec",
                    "fused_sym_gv_matvec_phase_prec",
                    "fused_sym_pipe_full_step_prec",
                    "fused_sym_pipe_full_step_prec/no recompute")
CLI_SCALING_VARIANTS = ("hs_cg", "cg_cg", "gv_cg", "pr_cg", "pipe_pr_cg")
CLI_ITERS = 300
CLI_REPEATS = 3
CLI_SCALING_ITERS = 1500
CLI_TRIALS = 3
TRACE_STEPS = 200
TRACE_BUSY_RTOL = 0.10
#: each ``__global__`` of ``csrc/*.cu`` and the bucket of utils.trace_analysis
#: its time belongs in: a product, fused or not, in spmv; a vector phase in
#: vector
KERNEL_PHASES = {
    "sym_dia_kernel": "spmv", "sym_family_kernel": "spmv",
    "dia_spmv_kernel": "spmv", "dia_family_kernel": "spmv",
    "df_dia_kernel": "spmv", "df_dense_kernel": "spmv",
    "ell_spmv_kernel": "spmv", "ell_gather_kernel": "spmv",
    "pipe_vector_kernel": "vector", "df_pipe_kernel": "vector",
}


def add_counts(total, counts):
    """Add ``counts`` into ``total`` by key; returns ``total``."""
    for key, val in counts.items():
        total[key] = total.get(key, 0) + val
    return total


def probe_products(rows, product):
    """Launches the error_A_norm and residual_2_norm probes add to a
    history run of ``rows`` rows: one product each a row (``product``: the
    counts of one product)."""
    return {key: 2 * rows * val for key, val in product.items()}


def run_expected(expected, product, name, iters):
    """Launches of one history run of ``name``: ``iters`` rows (``iters - 1``
    steps) with the PROBES; ``expected(name, steps)`` as in solve_names.
    Returns ``(counts by wrapper, kernel entry)``."""
    counts, entry = expected(name, iters - 1)
    return add_counts(dict(counts), probe_products(iters, product)), entry


def by_entry(counts, entry):
    """One name's launch counts by wrapper mapped to kernel entries: a
    wrapper's launches go to the entry of it that the name runs."""
    return {(entry if key == entry.split("/")[0] else key): val
            for key, val in counts.items()}


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def conv_checks(torch, card, timings, a_conv, a_posthoc):
    """The kernels of convergence_f64 against their plain versions at its
    float64 shapes, timed: row 12 on both ELL patterns in their RCM order,
    row 1 and the family entries the Jacobi runs take at n = 65,536, k =
    32.  Raises after all ran."""
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    rate = memory_rate(card)
    failed = []
    for label, a, sfx in (("27-point 32^3 permuted", a_conv, F64_ELL),
                          ("27-point 24^3 permuted", a_posthoc,
                           F64_ELL_POSTHOC)):
        failed += check_ell_shape(
            torch, label, a, np.random.default_rng(12), torch.float64, rate,
            timings, emit_check, locality_order(a), sfx=sfx)
    shape = (CONV_BAND_N, K_BAND)
    failed += check_spmv(torch, card, timings, shapes=(shape,),
                         dtypes=("float64",), timed=(shape, "float64"),
                         suffix=F64_SYM)
    failed += check_entries(
        torch, card, timings, sf,
        {e: FAMILY[e] for e in CONV_SYM_ENTRIES},
        ((CONV_BAND_N, K_BAND, tuple(range(K_BAND))),), random_band, 4,
        suffix=F64_SYM, dtypes=("float64",), timed_dtype="float64")
    if failed:
        raise AssertionError(f"{len(failed)} float64 checks disagree: "
                             f"{failed}")


def row_compare(hc, card_dir, cpu_dir, title, prec, names,
                cut=CONV_CMP_ITERS):
    """The card's table row against the CPU's on the same matrix: before the
    rounding floor (cut after ``cut`` iterations) and at it (whole
    histories).  Returns ``(record, faults)``; the oracle's numbers must be
    identical."""
    rec, faults = {}, {}
    for label, iters in (("pre_floor", cut), ("floor", None)):
        card, cpu = (table_numbers(hc, d, title, prec, names, iters)
                     for d in (card_dir, cpu_dir))
        diffs = {k: dict(iters=card[k][0] - cpu[k][0],
                         log10=card[k][1] - cpu[k][1], card=card[k][1],
                         cpu=cpu[k][1]) for k in names}
        rec[label] = diffs
        for k, v in diffs.items():
            tol = (0.0 if k == "exact_pcg" else CONV_LOG10_TOL if iters
                   else CONV_NOISY_FLOOR_TOL if k in CONV_NOISY
                   else CONV_FLOOR_TOL)
            if (abs(v["iters"]) > (0 if k == "exact_pcg" else CONV_ITER_SLACK)
                    or abs(v["log10"]) > tol
                    or not iters and v["cpu"] <= CONV_FLOOR_MAX < v["card"]):
                faults[f"{label} {k}"] = v
    return rec, faults


def table_numbers(hc, data_dir, title, prec, names, iters=None):
    """``{name: (iterations to 1e-5, log10 best error, seconds)}`` of one
    table row's trial files, from the histories cut after ``iters``
    iterations (None: whole); seconds None where the file has none (the JAX
    package's)."""
    import pathlib

    out = {}
    for name in names:
        trial = np.load(pathlib.Path(data_dir) / f"{title}_{prec}"
                        / f"{name}.npy", allow_pickle=True).item()
        err = trial["error_A_norm"][: None if iters is None else iters + 1]
        out[name] = (*hc.trial_summary(dict(error_A_norm=err)),
                     trial.get("seconds"))
    return out


def convergence_f64(torch, card, timings, launches):
    """figure_gen on the card in float64: two matrices written with
    write_mtx, the suite over DEFAULT_VARIANTS with the oracle on the host,
    its table rows, the card against the CPU before the rounding floor, the
    launch counts of each run, and the post-hoc probes of one card run."""
    import pathlib
    import platform
    import tempfile
    import warnings

    import scipy.sparse.linalg as spla

    from new_cg_variants_tpu_torch import from_coo, read_mtx, run, write_mtx
    from new_cg_variants_tpu_torch.harness import convergence as hc
    from new_cg_variants_tpu_torch.ops.operators import (
        choose_format,
        coo_from_scipy,
    )
    from new_cg_variants_tpu_torch.probes import posthoc

    a = stencil27(CONV_GRID, PERM_SEED)
    a24 = stencil27(POSTHOC_GRID, PERM_SEED)
    conv_checks(torch, card, timings, a, a24)

    ld = np.finfo(np.longdouble)
    host = dict(machine=platform.machine(), longdouble_eps=float(ld.eps),
                longdouble_bits=np.dtype(np.longdouble).itemsize * 8)
    names = hc.DEFAULT_VARIANTS
    table = names + ("exact_pcg",)
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        t0 = time.perf_counter()
        band, _ = scaled_band(torch, CONV_BAND_N, K_BAND)
        write_mtx(str(d / "hpcg27.mtx"), coo_from_scipy(a), symmetric=True)
        write_mtx(str(d / "scaled_band.mtx"), coo_from_scipy(band.tocsr()),
                  symmetric=True)
        write_s = time.perf_counter() - t0
        # the suite's route of each file; its launch counts below show the
        # kernels of that route ran
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # ELL's warning, expected here
            routes = {name: choose_format(read_mtx(str(d / f"{name}.mtx")),
                                          dtype=torch.float64)
                      for name in ("hpcg27",)}
        routes["scaled_band"] = choose_format(coo_from_scipy(band.tocsr()),
                                              dtype=torch.float64)
        emit("convergence_f64", matrices={
            "hpcg27": dict(n=a.shape[0], nnz=int(a.nnz),
                           route=routes["hpcg27"]),
            "scaled_band": dict(n=CONV_BAND_N, k=K_BAND,
                                route=routes["scaled_band"])},
             write_host_seconds=write_s, host=host)
        if routes != {"hpcg27": "ell", "scaled_band": "symdia"}:
            raise AssertionError(f"auto routes {routes}, expected ell and "
                                 "symdia")

        suite = dict(variants=names, table_variants=table, matrix_dir=d,
                     make_plots=False, verbose=False, fig_dir=d / "figures")
        ell_product = {"ell_spmv": 1, "ell_gather": 1}
        failed, path = [], {}

        def run_suite(label, configs, expected, product, **kw):
            """The suite on ``configs``; the launches of each history run
            read around the harness's own ``run`` call, held to
            ``expected`` (None: no launch) and added to ``path``; none may
            fall outside the history runs."""
            runs, stray, inner = [], {}, hc.run

            def counted(variant, *args, **kwargs):
                add_counts(stray, nonzero(read_counts()))
                reset_counts()
                out = inner(variant, *args, **kwargs)
                runs.append((variant, kwargs["max_iter"],
                             nonzero(read_counts())))
                reset_counts()
                return out

            reset_counts()
            t0 = time.perf_counter()
            hc.run = counted
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    hc.run_convergence_suite(configs=configs,
                                             **{**suite, **kw})
            finally:
                hc.run = inner
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            add_counts(stray, nonzero(read_counts()))
            total = {}
            for name, iters, counts in runs:
                add_counts(total, counts)
                want, entry = ({}, None) if expected is None else \
                    run_expected(expected, product, name, iters)
                if counts != want:
                    failed.append(dict(run=label, variant=name,
                                       launches=counts,
                                       expected_launches=want))
                if entry is not None:
                    add_counts(path, by_entry(counts, entry))
            if len(runs) != len(names) * len(configs) or stray:
                failed.append(dict(run=label, history_runs=len(runs),
                                   outside_history_runs=stray))
            return seconds, total

        # (a) and (b) at their full depth on the card; the table
        data = d / "data"
        sec_a, counts_a = run_suite(
            "hpcg27", [("hpcg27", CONV_ITERS, "jacobi"),
                       ("hpcg27", CONV_ITERS, None)],
            ell_expected, ell_product, data_dir=data, include_exact=True,
            device="cuda")
        sec_b, counts_b = run_suite(
            "scaled_band", [("scaled_band", CONV_BAND_ITERS, "jacobi")],
            sym_expected, {"sym_dia_spmv": 1}, data_dir=data,
            table_variants=names, device="cuda")
        for title, prec, cols in (("hpcg27", "jacobi", table),
                                  ("hpcg27", None, table),
                                  ("scaled_band", "jacobi", names)):
            emit("convergence_f64", matrix=title, preconditioner=prec,
                 iterations=CONV_ITERS if title == "hpcg27"
                 else CONV_BAND_ITERS,
                 row=(data / f"{title}_{prec}" / "convergence.txt"
                      ).read_text().strip(),
                 by_variant={k: dict(zip(("iters_to_1e-5", "log10_best",
                                          "seconds"), v))
                             for k, v in table_numbers(hc, data, title, prec,
                                                       cols).items()})
        emit("convergence_f64", suite_seconds={"hpcg27": sec_a,
                                               "scaled_band": sec_b},
             launches={"hpcg27": counts_a, "scaled_band": counts_b},
             table=(d / "figures" / "convergence_table_data.tex").read_text())

        # (a) with Jacobi on the CPU at the same depth; its row against the
        # card's, before the rounding floor and at it
        cpu = d / "cpu"
        run_suite("hpcg27 cpu", [("hpcg27", CONV_ITERS, "jacobi")], None,
                  ell_product, data_dir=cpu, include_exact=True, device="cpu")
        rec, bad = row_compare(hc, data, cpu, "hpcg27", "jacobi", table)
        emit("convergence_f64", compare="card against CPU",
             iterations=CONV_ITERS, cut_at=CONV_CMP_ITERS,
             card_row=(data / "hpcg27_jacobi" / "convergence.txt"
                       ).read_text().strip(),
             cpu_row=(cpu / "hpcg27_jacobi" / "convergence.txt"
                      ).read_text().strip(),
             **rec, faults=bad,
             tol=dict(iters=CONV_ITER_SLACK, log10_pre_floor=CONV_LOG10_TOL,
                      floor=CONV_FLOOR_TOL, floor_noisy=CONV_NOISY_FLOOR_TOL,
                      noisy=CONV_NOISY, floor_max=CONV_FLOOR_MAX))
        if bad:
            failed.append(dict(compare=bad))

    # the post-hoc probes of one card run (hs_pcg, M = I, 24^3 as ELL)
    op24 = from_coo(coo_from_scipy(a24), fmt="ell", device="cuda")
    n24 = a24.shape[0]
    b24 = a24 @ (np.ones(n24) / np.sqrt(n24))
    reset_counts()
    out = run("hs_pcg", op24, b24, max_iter=POSTHOC_ITERS,
              probes=("save_r", "alpha", "beta"), device="cuda")
    torch.cuda.synchronize()
    counts = nonzero(read_counts())
    want, entry = ell_expected("hs_pcg", POSTHOC_ITERS - 1)
    launches["posthoc_f64"] = by_entry(counts, entry)
    t0 = time.perf_counter()
    ue = posthoc.updated_error_A_norm(op24, out)
    ue_s = time.perf_counter() - t0
    ks = list(POSTHOC_CHECK_ITERS)
    r = out["save_r"][ks]
    ref = np.sqrt(np.einsum("nt,tn->t", spla.spsolve(a24.tocsc(), r.T), r))
    t0 = time.perf_counter()
    posthoc.lanczos_recurrence(op24, out)
    lz_s = time.perf_counter() - t0
    three = float(np.nanmax(out["lanczos_3_term_error"][1:-1]))
    orth = float(np.max(out["lanczos_orthogonality"][:5]))
    rec = dict(posthoc="hs_pcg", n=n24, iterations=POSTHOC_ITERS,
               operator=type(op24).__name__,
               locality_order=op24.perm is not None, launches=counts,
               expected_launches=want,
               updated_error_A_norm=dict(
                   seconds=ue_s, at=ks, values=ue[ks].tolist(),
                   spsolve=ref.tolist(),
                   max_rel_diff=float(np.max(np.abs(ue[ks] - ref) / ref)),
                   rtol=POSTHOC_RTOL),
               lanczos=dict(seconds=lz_s, max_3_term_error=three,
                            bound_3_term=1e-6, max_orthogonality_first5=orth,
                            bound_orthogonality=1e-8), host=host)
    emit("convergence_f64", **rec)
    if not (counts == want and op24.perm is not None
            and np.allclose(ue[ks], ref, rtol=POSTHOC_RTOL, atol=0.0)
            and three < 1e-6 and orth < 1e-8):
        failed.append(rec)
    launches["convergence_f64"] = path
    if failed:
        raise AssertionError(f"{len(failed)} convergence checks failed: "
                             f"{failed}")


def cli_f32(torch, timings, launches):
    """``python -m new_cg_variants_tpu_torch`` in-process at the main path's
    width (n = 655,360, k = 32, float32): ``solve`` (pipe-PR-CG, no norm,
    300 iterations, 3 repeats) and ``scaling`` over five names, their
    output files and launch counts; ``solve --devices 2`` must raise, and
    ``solve --dtype bf16`` reach the kernels' refusal of bf16 data."""
    import contextlib
    import io
    import json as js
    import pathlib
    import tempfile

    from new_cg_variants_tpu_torch import cli
    from new_cg_variants_tpu_torch.harness.scaling import MULTI_DEVICE_MESSAGE

    common = ["-n", str(N), "-k", str(K_BAND), "--dtype", "f32"]
    failed, path = [], {}

    def main(argv):
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        return rc, buf.getvalue().splitlines(), nonzero(read_counts()), \
            time.perf_counter() - t0

    rc, lines, counts, seconds = main(
        ["solve", *common, "--ksp-type", "pipe_pr_cg", "--ksp-norm-type",
         "none", "--max-iter", str(CLI_ITERS), "--num-repeat",
         str(CLI_REPEATS)])
    want = {"sym_dia_spmv": 3 * CLI_REPEATS,
            "fused_sym_pipe_full_step": CLI_ITERS * CLI_REPEATS}
    fields = dict(kv.split("=", 1) for ln in lines[:3] for kv in ln.split()
                  if "=" in kv)
    fwd = float(fields.get("forward_error", "nan"))
    rec = dict(command="solve", rc=rc, lines=lines, forward_error=fwd,
               seconds=seconds, launches=counts, expected_launches=want)
    emit("cli_f32", **rec)
    if not (rc == 0 and len(lines) == 4 and np.isfinite(fwd)
            and counts == want):
        failed.append(rec)
    add_counts(path, counts)

    with tempfile.TemporaryDirectory() as tmp:
        rc, lines, counts, seconds = main(
            ["scaling", *common, "--variants", ",".join(CLI_SCALING_VARIANTS),
             "--mesh-sizes", "1", "--max-iter", str(CLI_SCALING_ITERS),
             "--trials", str(CLI_TRIALS), "--data-dir", tmp])
        runs = CLI_TRIALS + 1  # the warm-up trial too
        want = {}
        for name in CLI_SCALING_VARIANTS:
            entry, init = VARIANT_ENTRY.get(name,
                                            ("fused_sym_pipe_full_step", 3))
            add_counts(want, {"sym_dia_spmv": init * runs,
                              entry: CLI_SCALING_ITERS * runs})
        files = {p.name: js.loads(p.read_text())
                 for p in sorted(pathlib.Path(tmp).glob("*_p1_n*.json"))}
        env = js.loads((pathlib.Path(tmp) / "env_info.json").read_text())
        has_call = (pathlib.Path(tmp) / "scaling.call").exists()
    ms = {d["variant"]: d["time_per_iter"] * 1e3 for d in files.values()}
    rec = dict(command="scaling", rc=rc, seconds=seconds,
               ms_per_iter=ms, main_f32_bench_ms_per_iter=timings[
                   "main_f32"]["ms_per_iter"],
               forward_error={d["variant"]: d["error"]
                              for d in files.values()},
               files=sorted(files), env_nvidia_smi=env.get("nvidia_smi"),
               env_devices=env.get("devices"), call_file=has_call,
               launches=counts, expected_launches=want)
    emit("cli_f32", **rec)
    if not (rc == 0 and len(files) == len(CLI_SCALING_VARIANTS)
            and env.get("nvidia_smi") and has_call and counts == want
            and all(np.isfinite(v) for v in ms.values())):
        failed.append(rec)
    add_counts(path, counts)

    try:
        cli.main(["solve", *common, "--devices", "2", "--max-iter", "5"])
    except NotImplementedError as exc:
        refused = str(exc)
    else:
        refused = None
    emit("cli_f32", command="solve --devices 2", raised=refused)
    if refused != MULTI_DEVICE_MESSAGE:
        failed.append(dict(devices=2, raised=refused))
    # bf16 storage reaches the kernels' refusal, with no cast on the way
    try:
        cli.main(["solve", "-n", "4096", "-k", str(K_BAND), "--dtype",
                  "bf16", "--max-iter", "5"])
    except TypeError as exc:
        refused = str(exc)
    else:
        refused = None
    emit("cli_f32", command="solve --dtype bf16", raised=refused)
    if refused is None or "bf16" not in refused:
        failed.append(dict(dtype="bf16", raised=refused))
    launches["cli_f32"] = path
    if failed:
        raise AssertionError(f"{len(failed)} CLI runs failed: {failed}")


def trace_f32(torch, launches):
    """TRACE_STEPS steps of the main path under ``utils.profiling.trace``,
    parsed by ``utils.trace_analysis``: the half-band family kernel in the
    spmv bucket, every kernel of the port in its bucket of
    ``KERNEL_PHASES``, and the parsed device
    time within TRACE_BUSY_RTOL of the profiler's own busy time over the
    same steps."""
    import tempfile

    from new_cg_variants_tpu_torch.solvers.context import Context
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES
    from new_cg_variants_tpu_torch.utils import profiling
    from new_cg_variants_tpu_torch.utils import trace_analysis as ta

    op, b, _ = model_f32(torch, "symdia")
    init_fn, step_fn = FAMILIES["pipe_pr"]
    ctx = Context(op)
    state = step_fn(ctx, init_fn(ctx, b, torch.zeros_like(b)))
    torch.cuda.synchronize()
    port = re.compile(r"(?<!\w)(" + "|".join(KERNEL_PHASES) + r")(?!\w)")
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        with profiling.trace(tmp) as prof:
            for _ in range(TRACE_STEPS):
                state = step_fn(ctx, state)
        counts = nonzero(read_counts())
        seconds = time.perf_counter() - t0
        busy_us, nspans, _ = device_activity(prof)
        events = ta.load_trace_events(tmp)
        bd = ta.phase_breakdown(events)
        rows = ta.op_breakdown(events, top=10_000)
    ported = {r["name"][:80]: (ta.phase_of(r["name"]),
                               KERNEL_PHASES[port.search(r["name"])[1]])
              for r in rows if port.search(r["name"])}
    family = [r for r in rows if "sym_family_kernel" in r["name"]]
    want = {"fused_sym_pipe_full_step": TRACE_STEPS}
    rel = abs(bd["total_us"] - busy_us) / busy_us if busy_us else None
    rec = dict(steps=TRACE_STEPS, seconds=seconds,
               device_us_parsed=bd["total_us"], device_events=bd["events"],
               busy_us_profiler=busy_us, profiler_events=nspans,
               rel_diff=rel, rtol=TRACE_BUSY_RTOL,
               phases={k: v["frac"] for k, v in bd["phases"].items()},
               table=ta.format_table(bd), port_kernels=ported,
               family_kernel_phase=[ta.phase_of(r["name"]) for r in family],
               top={r["name"][:60]: r["total_us"] / TRACE_STEPS
                    for r in rows[:6]},
               launches=counts, expected_launches=want)
    emit("trace_f32", **rec)
    launches["trace_f32"] = counts
    if not (family and all(ta.phase_of(r["name"]) == "spmv" for r in family)
            and all(got == table for got, table in ported.values())
            and counts == want
            and rel is not None and rel <= TRACE_BUSY_RTOL):
        raise AssertionError(f"trace analysis failed: {rec}")


def kernel_records(timings, launches):
    """The ``kernels`` line: one record per kernel entry and shape a driven
    path gives it, with the entry's launches on the paths of that shape
    (``launches``: path -> entry -> count)."""
    jax_ops = "new_cg_variants_tpu/ops/"
    sym = ("main_f32", "variants_f32", "cli_f32", "trace_f32")
    records = {
        "sym_dia_spmv": ("sym_dia.cu", "sym_dia.py:47", sym),
        **{entry: ("sym_family.cu", "sym_fused.py:184", sym)
           for entry in FAMILY},
    }
    for sfx, path in (("", "dia_f32"), (WIDE, "dia_wide_f32")):
        records.update({
            "dia_spmv" + sfx: ("dia_spmv.cu", "spmv_pallas.py:58", (path,)),
            "dia_spmv2" + sfx: ("dia_spmv.cu", "spmv_pallas.py:58", (path,)),
            "fused_pipe_vector_phase_prec" + sfx: (
                "pipe_vector.cu", "fused_step.py:160", (path,)),
        })
    # at the full-width band the unpreconditioned pipe names take the
    # whole-iteration entry, so this one runs on the wide band only
    records["fused_pipe_vector_phase" + WIDE] = (
        "pipe_vector.cu", "fused_step.py:76", ("dia_wide_f32",))
    for entry in DIA_STEP:
        if entry not in VECTOR_PHASES:
            line = "483" if "_prec" in entry else "329"
            records[entry] = ("dia_family.cu", "fused_step.py:" + line,
                              ("dia_f32",))
    records.update({entry: ("dia_family.cu", "fused_family.py:189",
                            ("dia_f32",)) for entry in DIA_FAMILY})
    records.update({
        "df_dia_spmv": ("df_spmv.cu", "df_spmv.py:43", ("df_f32x2",)),
        "df_dia_spmv2": ("df_spmv.cu", "df_spmv.py:43", ("df_f32x2",)),
        "df_pipe_vector_phase": ("df_pipe.cu", "df_spmv.py:326",
                                 ("df_f32x2",)),
        "df_dense_spmv": ("df_spmv.cu", "df_spmv.py:192",
                          ("df_dense_f32x2",)),
        "df_dense_spmv2": ("df_spmv.cu", "df_spmv.py:192",
                           ("df_dense_f32x2",)),
        "df_pipe_vector_phase" + DENSE: ("df_pipe.cu", "df_spmv.py:326",
                                         ("df_dense_f32x2",)),
        "ell_spmv": ("ell_spmv.cu", "ell_pallas.py:44", ("ell_f32",)),
        "ell_spmv2": ("ell_spmv.cu", "ell_pallas.py:44", ("ell_f32",)),
        # the gather in of a product in a locality order (part of row 12)
        "ell_gather": ("ell_spmv.cu", "ell_pallas.py:44", ("ell_f32",)),
    })
    # convergence_f64's float64 shapes (and its post-hoc run's)
    conv = ("convergence_f64",)
    records.update({
        "sym_dia_spmv" + F64_SYM: ("sym_dia.cu", "sym_dia.py:47", conv),
        **{entry + F64_SYM: ("sym_family.cu", "sym_fused.py:184", conv)
           for entry in CONV_SYM_ENTRIES},
        **{entry + F64_ELL: ("ell_spmv.cu", "ell_pallas.py:44", conv)
           for entry in ("ell_spmv", "ell_spmv2", "ell_gather")},
        **{entry + F64_ELL_POSTHOC: ("ell_spmv.cu", "ell_pallas.py:44",
                                     ("posthoc_f64",))
           for entry in ("ell_spmv", "ell_gather")},
    })
    kernels = []
    for name, (source, replaces, paths) in records.items():
        t = timings[name]
        entry = name.split(" (")[0]
        extra = {key: t[key] for key in ("f64_counterpart_ms",
                                         "f64_counterpart", "bound_bytes_ms",
                                         "bound_ops_ms", "L", "library",
                                         "given_order", "ms_2rhs",
                                         "launches_per_call")
                 if key in t}
        if name + NATURAL in timings:
            extra["natural_order"] = {
                key: timings[name + NATURAL][key]
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append(dict(
            name=name, route="cuda",
            source="new_cg_variants_tpu_torch/csrc/" + source,
            replaces=jax_ops + replaces, n=t["n"], paths=list(paths),
            launches=sum(launches[p].get(entry, 0) for p in paths),
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], **extra))
    return kernels


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
                        if "registers" in ln or "spill" in ln
                        or "Compiling" in ln),
              file=sys.stderr)

    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    timings, launches = {}, {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        emit("seconds", of=name, seconds=time.perf_counter() - t0)
        if isinstance(out, dict):
            launches[name] = out  # the path's launches by kernel entry
        return out

    phase("check_sym", check_sym, torch, card, timings)
    phase("check_dia", check_dia, torch, card, timings)
    phase("check_df", check_df, torch, card, timings)
    phase("main_f32", main_path_f32, torch, timings)
    phase("main_f64", main_path_f64, torch)
    phase("variants_f32", variants_f32, torch)
    phase("variants_f64", variants_f64, torch)
    phase("dia_f32", dia_path_f32, torch, timings)
    phase("dia_wide_f32", dia_wide_f32, torch)
    phase("dia_f64", dia_f64, torch)
    phase("df_f32x2", df_f32x2, torch)
    phase("df_dense_f32x2", df_dense_f32x2, torch)
    phase("df_card_vs_cpu", df_card_vs_cpu, torch)
    phase("df_accuracy", df_accuracy, torch)
    phase("check_ell", check_ell, torch, card, timings)
    phase("ell_f32", ell_f32, torch)
    phase("formats_f32", formats_f32, torch)
    phase("sparse_f64", sparse_f64, torch)
    phase("convergence_f64", convergence_f64, torch, card, timings, launches)
    phase("cli_f32", cli_f32, torch, timings, launches)
    phase("trace_f32", trace_f32, torch, launches)

    kernels = kernel_records(timings, launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    unlaunched = [k["name"] for k in kernels if k["launches"] < 1]
    if unlaunched:
        raise AssertionError(f"no launch on its driven path: {unlaunched}")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
