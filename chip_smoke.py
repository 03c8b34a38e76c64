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
   also at the shape of 10 (n = 4,194,304), timed there too, and the
   unpreconditioned vector phase (row 4) at HPCG's n = 104^3 = 1,124,864,
   where the pipe step of 18 (ELL in its RCM basis) runs it, timed there;
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
    512 x 512 operator (row 4 once per iteration);
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
    whose results must equal the given order's bit for bit; and, on the
    reordered storage with no order (the product a solve in the
    operator's basis runs), the gathered vectors' product, which must be
    the given order's results permuted, bit for bit (``ell_spmv_basis``
    lines, also in bf16 under ``check_bf16``).  Timed in float32 at HPCG's
    pattern (permuted: the basis's product, the locality order's and the
    given order's beside it), with the plain versions, cuSPARSE CSR
    through torch, ``torch.index_select`` beside the gather and the
    bound;
18. ``ell_f32`` — general sparse input through the auto route: HPCG's
    operator (27-point, 104^3; diagonal 26, -1 to each neighbour) under a
    random symmetric permutation, handed over as scipy CSR in float32; the
    route must pick ELL in the RCM order and warn; pipe-PR-CG for 300
    iterations (launches, the profiler's kernels per iteration and busy
    share of the step on the stored ``B``), the other 17 names for 100
    (each solved in the operator's basis: row 12 once per product of each
    generic body with no gather, two gathers a solve, row 4 once per
    iteration of the unpreconditioned pipe names), one solve to rtol
    1e-6 that converges; the host seconds of the operator's build;
19. ``formats_f32`` — the model problem of 4 as scipy CSR: permuted, the
    auto route must pick the block-banded packing (bs = 128); unpermuted,
    the stencil (and ``banded_model(fmt="stencil")``); pipe-PR-CG for 300
    iterations on each, no kernel launched but row 4 once per iteration
    (the vector phase), the block-banded residual (in
    the original order) within 10x of the half-band path's;
20. ``sparse_f64`` — card against CPU in float64 over 25 iterations on ELL
    (the permuted 27-point operator on 32^3), block-banded (the permuted
    model problem, n = 65,536) and stencil operators, one name per family
    and a Jacobi ``_pcg`` name on each (row 4 once per iteration of the
    unpreconditioned pipe names); pipe-PR-CG in f32x2 on an ELL inner;
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
    12 once per product of each generic body and each probe product, in
    the operator's basis, and three gathers a run; each name's family entry
    once per step; nothing on the CPU); then ``updated_error_A_norm``
    (against ``spsolve``) and ``lanczos_recurrence`` on a card run of
    ``hs_pcg`` on 24^3.  Row 12 and
    the half-band kernels are checked and timed in float64 at these shapes
    first;
22. ``cli_f32`` — ``cli.main`` in-process at the main path's width:
    ``solve`` (pipe-PR-CG, 300 iterations, 3 repeats) and ``scaling`` (five
    names, 1500 iterations, 3 trials; its result files, ``env_info.json``
    with the ``nvidia-smi`` line, ``scaling.call``), with launch counts;
    ``solve --devices 2`` must raise the ``ValueError`` that names
    ``torchrun`` (one process); ``solve --dtype bf16`` (kappa 100) must
    converge through the half-band kernels' bf16 entries;
23. ``trace_f32`` — 200 steps of the main path under
    ``utils.profiling.trace``, parsed by ``utils.trace_analysis``: the
    family kernel in the spmv bucket, no kernel of the port in "other", the
    parsed device time within 10% of the profiler's busy time;
24. the bf16 storage tier (the matrix in bf16; vectors, scalars, dots and
    arithmetic in float32): ``check_bf16`` (after ``check_ell``) holds
    every ``_bf16`` entry of rows 1, 2, 2b, 3, 6, 7, 8 and 12 at the shapes
    of 3, 8 and 17 to its plain version (1e-5 of each value's scale) and,
    bit for bit, to the float32 entry on the widened data, timed beside it
    with its bound (2 bytes a band value); ``ell_bf16`` (after
    ``ell_f32``): that operator ``.astype(torch.bfloat16)``, pipe-PR-CG and
    hs-PCG with Jacobi in its basis, one row-12 launch a product and two
    gathers a solve, and
    what the auto route picks for it in bf16; ``main_bf16``: main_f32's
    problem with its band in bf16, pipe-PR-CG and hs-CG under the bench
    protocol (kernels per iteration equal to main_f32's), the other 17
    names for 100 iterations, and a solve that takes less device memory
    than a float32 copy of the band; ``dia_bf16``: the same in 63
    diagonals, all 18 names and one split-path run; ``bf16_accuracy``:
    ``tests/test_bf16_storage.py``'s floor on the card (n = 8192, k = 8,
    kappa = 100, hs-PCG with Jacobi, 200 iterations: the best relative
    A-norm error < 5e-3, float32 storage 100 times deeper), card against
    CPU on the same bf16 data (half-band, full DIA, dense and block-banded
    at n = 4096): the same iteration to the floor, histories within rtol
    1e-4 through iteration 15;
25. the row-partitioned distributed layer (``parallel/``) at world size 1,
    in a process group made from the environment ``torchrun`` sets
    (NCCL for the card, gloo for the CPU; destroyed at the end, a failed
    check included): ``check_dist`` holds the kernels at the shapes the
    row partition gives them to their plain versions (the half-band SpMV
    on the extended slice of m + 2h = 655,422 rows, the DIA ``_ext``
    entries at 63 diagonals with halo-extended vectors; the vector phases
    run on check_dia's n = 655,360 rows), timed with the plain versions
    and cuSPARSE; ``dist_f32``: pipe_pr_cg, hs_cg (model problem) and
    pipe_pr_pcg with Jacobi (scaled band) on half-band and full DIA at
    n = 655,360 in float32, ``dist_run`` against the single-device ``run``
    (nu, alpha to rtol 1e-4 through iteration 15), the launches, the
    all-reduces (hs 2, pipe_pr 1) and halo exchanges (1) per iteration,
    the kernels per iteration by entry and the device busy share, and
    ``dist_solve`` ms/iter beside ``solve``'s; pipe_pr_cg on half-band
    under the bench protocol of 4 with 1000-iteration chunks,
    single-device and row contexts replayed in turns, the row context
    eagerly;
    ``dist_f64``: the same names and storages at n = 65,536 in float64,
    the card against the CPU over 25 iterations (rtol 1e-10).  ``ell_f32``
    also times the padded-ELL packing (``build_ell`` against the native
    ``pack_ell``, the same bits), and ``convergence_f64`` ``read_mtx`` on
    its 32^3 file through the native reader and the Python parser (the
    same entries).  The rest of the distributed layer, in the same world
    of one: ``check_dist`` also holds row 9's ``_ext`` entries
    (``df_dia_spmv_ext`` / ``df_dia_spmv2_ext``: 63 diagonals on m =
    655,360 and 4096 rows, words halo-extended) to their plain version bit
    for bit, timed against the bound and float64 ``dia_spmv_ext``, and row
    12 on the ELL context's shards (``ell_spmv_cache`` /
    ``ell_spmv2_cache``: HPCG 104^3 in natural order planned by
    ``plan_ell_exchange`` at 2 and 4 ranks, the first and another rank's
    rows and caches; the whole permuted operator at one rank) to theirs
    (1e-5 / 1e-12), timed against the bound and cuSPARSE on the (m, c)
    shard; ``dist_ell_f32``: pipe_pr_cg on the ELL row context (ell_f32's
    operator, solved in its basis: ``B``'s storage, the cache gathered
    whole) against the single-device run (1e-4 through iteration 15), row
    12 once per product with no gather, one all-gather a matvec phase, one
    all-reduce a sync phase (hs_cg too); ``dist_f32x2``: pipe_pr_cg
    and hs_cg in f32x2 on the double-word row context (n = 655,360, 63
    diagonals, 100 iterations) against the single-device f32x2 run (1e-5),
    the ``_ext`` entries once per product, one all-gather a sync phase;
    ``dist_formats_f32``: pipe_pr_cg on the block-banded (formats_f32's
    permuted operator), stencil and column contexts (a dense SPD n = 8192,
    packed and unpacked, and every family's collective totals) against
    their single-device runs; ``dist_scaling``: ``time_variant`` on the
    mesh (row and column partitions, 500-iteration chunks),
    ``scaling_run``'s file keys, ``cli solve --devices 1 --partition
    row``, and ``--devices 2`` raising the error that names ``torchrun``.
    Each prints its collectives and kernels per iteration and ms/iter
    beside the single-device run.  The mesh loops replay captured CUDA
    graphs with the NCCL collectives inside (``dist_run``, ``dist_solve``,
    ``time_variant(mesh=)``, ``cli solve --devices``): every pair of
    ``dist_case`` holds them to an eager witness (``parallel/dist.py``'s
    private bodies with no runner) in bits, launches, collectives, and
    kernels and collectives per iteration, and times ``dist_solve``
    captured, eagerly and the single-device ``solve`` in turns, and the
    replays alone against the single-device loop's; ``dist_f64`` holds
    the captured run to its eager witness too;
26. the compiled loop (``solvers/graphs.py``): ``run`` / ``solve`` take
    ``use_jit=True`` by default, which on the card replays captured CUDA
    graphs of chunks of steps, so every phase above that calls them runs
    captured; launch counts count a captured launch once for each replay
    of its graph (``install_graph_counts``).  The ``jit_*`` phases run each
    path with ``use_jit=True`` and ``use_jit=False`` and hold ``x``, every
    probe history, and for tolerance solves the iterations and the norm,
    to the same bits, and the same launches (a tolerance solve's replays
    may add those of the steps a chunk ran past its stop): ``jit_main_f32``
    (the main path), ``jit_variants_f32`` (the 18 names on half-band
    storage; gv's replacement hook under capture), ``jit_solve`` (tolerance
    solves, natural norm, a ``_pcg`` name, the generic body, ``norm_type=
    "none"``), ``jit_dia_f32`` / ``jit_dia_wide_f32`` (full DIA, the split
    formulations), ``jit_f32x2`` / ``jit_df_dense`` (rows 9-11),
    ``jit_ell_f32`` (row 12 in the operator's basis, an object
    preconditioner in the original order whose gather runs inside the
    graph, a tolerance solve that stops inside a chunk), ``jit_bf16``
    (bf16 storage on half-band, DIA and ELL) and ``jit_convergence_f64``
    (``convergence_f64``'s table through ``run``); the entries only the
    row partition runs are also each captured alone once at their shapes
    (``capture_dist``), and collective calls, like launches, count once
    for each replay of a captured graph.  The
    main paths are timed both ways under the bench protocol (ELL with
    2000-iteration chunks, f32x2 and each name with 200; the eager times of
    main_f32, dia_f32 and main_bf16 from those phases' own benches), with
    ms/iter, the device busy share,
    CUDA events per iteration and the capture's and instantiation's host
    seconds;
27. ``kernels`` — one JSON line over all kernel entries: one record per entry
    and shape that a driven path gives it, with the entry's launches on the
    paths of that shape and inside captured graphs (``graph_launches``; a
    record whose path runs has at least one of each; the row partition's
    records also ``mesh_graph_launches``, those of the mesh phases' own
    captured loops, at least one but for ``ell_gather``, which runs
    outside the loop) (bf16 entries with the float32 entry's time from the
    same call beside theirs).

Every phase prints one JSON line.  Any failed check raises, and the script
exits nonzero; it also exits nonzero, printing no result, when no CUDA device
is available.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import os
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
MAX_TRIALS = 5
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
TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 1e-5}
# Data-sheet peaks (NVIDIA H100, dense, no tensor cores); bf16 storage
# computes in float32
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}
#: suffix of a bf16-storage kernel's record (timings, the kernels line)
BF16 = " (bf16)"


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


def vector_dtype(torch, dtype):
    """The vectors' dtype that goes with data stored as ``dtype``: bf16 is a
    storage-only tier (float32 vectors, scalars and arithmetic)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def same_bits(torch, got, want):
    """Whether every tensor of ``got`` equals its ``want`` bit for bit."""
    return all(bool(torch.equal(g, w)) for g, w in zip(got, want))


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
    dtype), into ``timings["sym_dia_spmv" + suffix]``.  bf16 data (with
    float32 vectors) is also held to the float32 entry on the widened data,
    bit for bit, and timed beside it.  ``report`` takes each check's
    record.  Returns the failed checks."""
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
            v, w = (torch.as_tensor(rng.standard_normal(n),
                                    dtype=vector_dtype(torch, dtype),
                                    device="cuda") for _ in range(2))
            main = (((n, k), dn) == timed and timings is not None)
            isz, vsz = data.element_size(), v.element_size()
            y = sd.sym_dia_spmv(offs, data, v)
            y2, z2 = sd.sym_dia_spmv2(offs, data, v, w)
            same = True
            if dtype == torch.bfloat16:
                wide = data.float()
                same = same_bits(torch, (y, y2, z2), (
                    sd.sym_dia_spmv(offs, wide, v),
                    *sd.sym_dia_spmv2(offs, wide, v, w)))
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
            if dtype == torch.bfloat16:
                rec["same_bits_as_f32_entry"] = same
            if main:
                ms = time_ms(torch, lambda: sd.sym_dia_spmv(offs, data, v), 50)
                ms2 = time_ms(torch,
                              lambda: sd.sym_dia_spmv2(offs, data, v, w), 50)
                plain_ms = time_ms(torch, lambda: sd._mv_plain(offs, data, v), 5)
                b_ms, b_by = bound(k * n * isz + 2 * n * vsz, 4 * k * n, dn,
                                   rate)
                b2_ms, b2_by = bound(k * n * isz + 4 * n * vsz, 8 * k * n,
                                     dn, rate)
                plain2_ms = time_ms(
                    torch, lambda: (sd._mv_plain(offs, data, v),
                                    sd._mv_plain(offs, data, w)), 5)
                rec.update(ms=ms, spmv2_ms=ms2, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, spmv2_bound_ms=b2_ms)
                lib2_ms = None
                if dtype == torch.bfloat16:
                    # no PyTorch call multiplies bf16 storage into a float32
                    # vector without a cast: the float32 entry on the
                    # widened band beside it, in the same call
                    rec.update(library_ms=None, f32_ms=time_ms(
                        torch, lambda: sd.sym_dia_spmv(offs, wide, v), 50),
                        f32_spmv2_ms=time_ms(
                        torch, lambda: sd.sym_dia_spmv2(offs, wide, v, w),
                        50))
                else:
                    csr = library_csr(torch, offs, data)
                    rec.update(library_err=cw_err(torch, csr @ v, yp, ys),
                               library_ms=time_ms(torch, lambda: csr @ v, 50))
                    vw = torch.stack([v, w], dim=1)
                    lib2_ms = time_ms(torch, lambda: csr @ vw, 50)
                    del csr, vw
                timings["sym_dia_spmv" + suffix] = rec
                # the 2-RHS entry: two plain products; as a library call one
                # cuSPARSE product with the (n, 2) matrix [v | w]
                timings["sym_dia_spmv2" + suffix] = dict(
                    rec, ms=ms2, plain_ms=plain2_ms, library_ms=lib2_ms,
                    bound_ms=b2_ms, bound_by=b2_by,
                    **({"f32_ms": rec["f32_spmv2_ms"]} if "f32_ms" in rec
                       else {}))
            report(rec)
            if not (max(errs) <= tol and same):
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
    value and SpMV (4 with a mirror term, 2 without).  bf16 data (with
    float32 vectors and scalars) is also held to the float32 entry on the
    widened data, every output and dot bit for bit, and timed beside it.
    ``report`` takes each check's record.  Returns the failed checks."""
    rate = memory_rate(card)
    failed = []
    for dtype in (getattr(torch, dn) for dn in dtypes):
        dn = dtype_name(dtype)
        tol = TOL[dn]
        vdt = vector_dtype(torch, dtype)
        for n, k, offs in shapes:
            rng = np.random.default_rng(7 * n + len(offs))
            data = make_band(torch, offs, n, dtype, rng)
            data_cpu = data.cpu()
            wide = data.float() if dtype == torch.bfloat16 else None
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
                    else rng.standard_normal(n), dtype=vdt, device="cuda")
                    for nm in names]
                scalars = {nm: torch.tensor(SCALAR_VALUES[nm], dtype=vdt,
                                            device="cuda")
                           for nm in scs.split()}
                got = call(data, vecs, list(scalars.values()))
                same = True
                if wide is not None:
                    ref = call(wide, vecs, list(scalars.values()))
                    same = (same_bits(torch, got[:-1], ref[:-1])
                            and same_bits(torch, got[-1], ref[-1]))
                    del ref
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
                if wide is not None:
                    rec["same_bits_as_f32_entry"] = same
                if main:
                    head = (offs, data) if nmv else ()
                    args = (*head, *vecs, *scalars.values())
                    ms = time_ms(torch, lambda: fn(*args, **kw), 50)
                    plain = getattr(module, plain_name)
                    plain_ms = time_ms(
                        torch, lambda: plain(*args, *kw.values()), 5)
                    ndiag = len(offs) if nmv else 0
                    b_ms, b_by = bound(
                        ndiag * n * data.element_size()
                        + (len(names) + len(onames)) * n * vecs[0].element_size(),
                        (terms_per_value * ndiag * nmv + ops) * n, dn, rate)
                    rec.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                               bound_ms=b_ms, bound_by=b_by)
                    if wide is not None:
                        wargs = (offs, wide, *vecs, *scalars.values())
                        rec["f32_ms"] = time_ms(
                            torch, lambda: fn(*wargs, **kw), 50)
                    timings[entry + suffix] = rec
                report(rec)
                shapes_ok = (len(got) == len(onames) + 1
                             and len(got[-1]) == len(dots))
                if not (shapes_ok and same and max(verrs) <= tol
                        and max(derrs) <= tol):
                    failed.append(rec)
                del vecs, got, want, scales, by_name
            del data, data_cpu, wide
            torch.cuda.empty_cache()
    return failed


def check_family(torch, card, timings, report=emit_check):
    """The eleven entries of the family kernel against their plain versions
    at SYM_SHAPES; returns the failed checks."""
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    shapes = tuple((n, k, tuple(range(k))) for n, k in SYM_SHAPES)
    return check_entries(torch, card, timings, sf, FAMILY, shapes,
                         random_band, 4, report=report)


#: the pipe entry with its scalar epilogue (ops/sym_fused.py:
#: fused_sym_pipe_full_step_scalars; csrc/sym_family.cu:Scalars), the entry
#: of the unpreconditioned pipe names on half-band storage: its wrapper (the
#: key of its launches and of its records on the kernels line), and the
#: previous state's nu, delta, gamma and alpha it starts from
EPILOGUE = "fused_sym_pipe_full_step_scalars"
EPILOGUE_PREV = (1.0, 0.5, 3.0, 0.37)
#: suffix of its float64 records: main_f64's shape
F64_MAIN = f" (f64, n={N:,})"
#: suffix of its records by the band's dtype
EPILOGUE_SUFFIX = {"float32": "", "float64": F64_MAIN, "bfloat16": BF16}


def check_sym_epilogue(torch, card, timings, report=emit_check):
    """The pipe entry with its scalar epilogue, for PR and Meurant
    prediction with and without recompute, in float32, float64 and a bf16
    band, at (N, K_BAND) and n = 1000: against the torch epilogue on the
    same step (the entry without it, torch's sum of the partials and its
    scalar kernels) the same vectors and beta bit for bit, the dots within
    TOL of their terms' magnitudes, alpha the torch formula's bits on the
    kernel's own dots; against the plain version the vectors within TOL of
    their scales and the dots within TOL; a second launch the same bits;
    one launch a call, counted on its own wrapper and none on the entry
    without it.  PR prediction at (N, K_BAND) is timed in each dtype, with
    and without recompute, in turns with the torch epilogue, into
    ``timings[EPILOGUE + ("/no recompute") + EPILOGUE_SUFFIX[dtype]]`` (a
    bf16 band also on the widened float32 band, ``f32_ms``).  Returns the
    failed checks."""
    from new_cg_variants_tpu_torch.ops import sym_fused as sf
    from new_cg_variants_tpu_torch.ops.scalars import predict_nu, safe_div

    rate = memory_rate(card)
    offs = tuple(range(K_BAND))
    names = "x r w u p s".split()
    failed = []
    for dn in ("float32", "float64", "bfloat16"):
        dtype = getattr(torch, dn)
        vdt = vector_dtype(torch, dtype)
        tol = TOL[dn]
        for n in (N, 1000):
            rng = np.random.default_rng(11 * n + len(dn))
            data = random_band(torch, offs, n, dtype, rng)
            wide = data.float() if dtype == torch.bfloat16 else None
            vecs = [torch.as_tensor(rng.standard_normal(n), dtype=vdt,
                                    device="cuda") for _ in names]
            prev = [torch.tensor(v, dtype=vdt, device="cuda")
                    for v in EPILOGUE_PREV]
            nu, delta, gamma, a1 = prev
            for meurant in (False, True):
                for recompute in (True, False):
                    def epilogue(band=data, meurant=meurant,
                                 recompute=recompute):
                        return sf.fused_sym_pipe_full_step_scalars(
                            offs, band, *vecs, *prev, meurant=meurant,
                            recompute=recompute)

                    def torch_epilogue(meurant=meurant, recompute=recompute):
                        beta = safe_div(
                            predict_nu(nu, delta, gamma, a1, meurant), nu)
                        *out, dots = sf.fused_sym_pipe_full_step(
                            offs, data, *vecs, a1, beta, recompute=recompute)
                        return (*out, dots, safe_div(dots[3], dots[0]), beta)

                    def entry(band, vs, scs, recompute=recompute):
                        return sf.fused_sym_pipe_full_step(
                            offs, band, *vs, *scs, recompute=recompute)

                    before = (sf.fused_sym_pipe_full_step_scalars.launches,
                              sf.fused_sym_pipe_full_step.launches)
                    got, again = epilogue(), epilogue()
                    launches = (sf.fused_sym_pipe_full_step_scalars.launches
                                - before[0]) / 2
                    others = sf.fused_sym_pipe_full_step.launches - before[1]
                    want = torch_epilogue()
                    plain = sf._pipe_step_scalars_plain(
                        offs, data.cpu(), *[v.cpu() for v in vecs],
                        *[v.cpu() for v in prev], meurant, recompute)
                    plain = [v.to("cuda") for v in plain[:6]] + [
                        [v.to("cuda") for v in plain[6]]]
                    torch.cuda.synchronize()
                    scales = family_scales(torch, entry, data, names, vecs,
                                           {"a1": a1, "beta": want[8]})
                    verrs = [cw_err(torch, g, w, sc)
                             for g, w, sc in zip(got[:6], plain[:6], scales)]
                    r2, p2, s2 = want[1], want[3], want[4]
                    pairs = ((p2, s2), (r2, s2), (s2, s2), (r2, r2))
                    derrs = [dot_err(torch, g, w, a, b)
                             for g, w, (a, b) in zip(got[6], want[6], pairs)]
                    perrs = [dot_err(torch, g, w, a, b)
                             for g, w, (a, b) in zip(got[6], plain[6], pairs)]
                    name = (EPILOGUE + ("" if recompute else "/no recompute")
                            + EPILOGUE_SUFFIX[dn])
                    rec = dict(
                        kernel=name, dtype=dn, n=n, k=K_BAND,
                        meurant=meurant, recompute=recompute,
                        max_err=max(verrs), max_dot_err=max(derrs),
                        max_plain_dot_err=max(perrs),
                        max_abs_err=max(float((g - w).abs().max())
                                        for g, w in zip(got[:6], plain[:6])),
                        same_vectors_as_torch_epilogue=same_bits(
                            torch, got[:6], want[:6]),
                        same_beta=bool(torch.equal(got[8], want[8])),
                        alpha_of_its_dots=bool(torch.equal(
                            got[7], safe_div(got[6][3], got[6][0]))),
                        repeats_its_bits=same_bits(
                            torch, [*got[:6], *got[6], *got[7:]],
                            [*again[:6], *again[6], *again[7:]]),
                        launches_per_call=launches,
                        launches_without_epilogue=others, tol=tol)
                    if n == N and not meurant and timings is not None:
                        ms = {"epilogue": [], "torch": []}
                        for turn in ("epilogue", "torch", "torch",
                                     "epilogue"):
                            fn = epilogue if turn == "epilogue" \
                                else torch_epilogue
                            ms[turn].append(time_ms(torch, fn, 50))
                        plain_ms = time_ms(torch, lambda: (
                            sf._pipe_step_scalars_plain(
                                offs, data, *vecs, *prev, False, recompute)),
                            5)
                        nmv = 2 if recompute else 1
                        b_ms, b_by = bound(
                            K_BAND * n * data.element_size()
                            + 12 * n * vecs[0].element_size(),
                            (4 * K_BAND * nmv + 18) * n, dn, rate)
                        rec.update(ms=float(np.median(ms["epilogue"])),
                                   torch_epilogue_ms=float(
                                       np.median(ms["torch"])),
                                   ms_in_turns=ms, plain_ms=plain_ms,
                                   library_ms=None, bound_ms=b_ms,
                                   bound_by=b_by)
                        if wide is not None:
                            rec["f32_ms"] = time_ms(
                                torch, lambda: epilogue(band=wide), 50)
                        timings[name] = rec
                    report(rec)
                    if not (rec["same_vectors_as_torch_epilogue"]
                            and rec["same_beta"] and rec["alpha_of_its_dots"]
                            and rec["repeats_its_bits"] and launches == 1
                            and others == 0
                            and max(verrs) <= tol and max(derrs) <= tol
                            and max(perrs) <= tol):
                        failed.append(rec)
                    del got, again, want, plain, scales
            del data, wide, vecs, prev
            torch.cuda.empty_cache()
    return failed


def sym_checks(torch, card, timings, report):
    """The checks of both half-band kernels; returns the failed ones."""
    return (check_spmv(torch, card, timings, report)
            + check_family(torch, card, timings, report))


def check_sym(torch, card, timings):
    """Every half-band kernel entry against its plain version; raises after
    all checks ran."""
    failed = (sym_checks(torch, card, timings, emit_check)
              + check_sym_epilogue(torch, card, timings))
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


def dia_spmv_all(sp, offs, data, shard, v, w, vx, wx):
    """Every entry of the DIA SpMV kernel once: the whole matrix's with 1
    and 2 right-hand sides, a shard's (``_ext``) with 1 and 2."""
    got = {"1": sp.dia_spmv(offs, data, v)}
    got["2a"], got["2b"] = sp.dia_spmv2(offs, data, v, w)
    got["ext"] = sp.dia_spmv_ext(offs, shard, vx)
    got["ext2a"], got["ext2b"] = sp.dia_spmv2_ext(offs, shard, vx, wx)
    return got


def check_dia_spmv(torch, card, timings, report=emit_check,
                   dtypes=("float32", "float64"), suffix=""):
    """The DIA SpMV kernel's entries against their plain versions, in both
    regimes (staged window, direct reads), in ``dtypes``; timed (when
    ``timings`` is a dict) in the first dtype at the shapes of the two
    full-DIA paths (bf16: at the full-width band's, which its path runs),
    into records named with ``suffix``.  bf16 data is also held to the
    float32 entries on the widened data, bit for bit.  ``report`` takes
    each check's record.  Returns the failed checks."""
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp

    rate = memory_rate(card)
    shapes = DIA_SHAPES + (WIDE_SHAPE, (100_003, "wide", WIDE_OFFSETS),
                           (1000, "wide", WIDE_OFFSETS))
    timed = {DIA_SHAPES[0]: ""}
    if dtypes[0] != "bfloat16":
        timed[WIDE_SHAPE] = WIDE
    if timings is None:
        timed = {}
    failed = []
    for dtype in (getattr(torch, dn) for dn in dtypes):
        dn = dtype_name(dtype)
        tol = TOL[dn]
        vdt = vector_dtype(torch, dtype)
        for n, k, offs in shapes:
            rng = np.random.default_rng(n + len(offs))
            data = random_dia(torch, offs, n, dtype, rng)
            h = max(abs(o) for o in offs)
            v, w = (torch.as_tensor(rng.standard_normal(n), dtype=vdt,
                                    device="cuda") for _ in range(2))
            # halo-extended right-hand sides [h | n | h], halos not zero
            vx, wx = (torch.as_tensor(rng.standard_normal(n + 2 * h),
                                      dtype=vdt, device="cuda")
                      for _ in range(2))
            # a shard's band: rows of the interior, no zeros at its edges
            shard = torch.as_tensor(rng.uniform(-1.0, 1.0, (len(offs), n)),
                                    dtype=dtype, device="cuda")
            got = dia_spmv_all(sp, offs, data, shard, v, w, vx, wx)
            bits_ok = True
            if dtype == torch.bfloat16:
                wide = data.float()
                ref = dia_spmv_all(sp, offs, wide, shard.float(), v, w, vx,
                                   wx)
                bits_ok = same_bits(torch, [got[key] for key in ref],
                                 list(ref.values()))
                del ref
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
            if dtype == torch.bfloat16:
                rec["same_bits_as_f32_entry"] = bits_ok
            if (n, k, offs) in timed and dn == dtypes[0]:
                sfx = timed[(n, k, offs)] + suffix
                nd, isz, vsz = len(offs), data.element_size(), v.element_size()
                ms = time_ms(torch, lambda: sp.dia_spmv(offs, data, v), 50)
                ms2 = time_ms(torch, lambda: sp.dia_spmv2(offs, data, v, w), 50)
                plain_ms = time_ms(torch,
                                   lambda: sp._dia_mv_plain(offs, data, v), 5)
                plain2_ms = time_ms(
                    torch, lambda: (sp._dia_mv_plain(offs, data, v),
                                    sp._dia_mv_plain(offs, data, w)), 5)
                lib_ms = lib2_ms = None
                if dtype == torch.bfloat16:
                    # no library call takes bf16 storage with float32
                    # vectors: the float32 entries on the widened band
                    rec.update(
                        f32_ms=time_ms(
                            torch, lambda: sp.dia_spmv(offs, wide, v), 50),
                        f32_spmv2_ms=time_ms(
                            torch, lambda: sp.dia_spmv2(offs, wide, v, w),
                            50))
                else:
                    csr = library_csr(torch, offs, data, mirror=False)
                    rec["library_err"] = cw_err(torch, csr @ v, want["1"],
                                                scale["1"])
                    lib_ms = time_ms(torch, lambda: csr @ v, 50)
                    vw = torch.stack([v, w], dim=1)
                    lib2_ms = time_ms(torch, lambda: csr @ vw, 50)
                    del csr, vw
                    if sp.stages_window(offs):
                        rec.update(staged_against_direct(torch, sp, offs,
                                                         data, v, w))
                b_ms, b_by = bound(nd * n * isz + 2 * n * vsz, 2 * nd * n, dn,
                                   rate)
                b2_ms, b2_by = bound(nd * n * isz + 4 * n * vsz, 4 * nd * n,
                                     dn, rate)
                rec.update(ms=ms, spmv2_ms=ms2, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                           spmv2_bound_ms=b2_ms)
                timings["dia_spmv" + sfx] = rec
                # the 2-RHS entry: two plain products; as a library call one
                # cuSPARSE product with the (n, 2) matrix [v | w]
                timings["dia_spmv2" + sfx] = dict(
                    rec, ms=ms2, plain_ms=plain2_ms, library_ms=lib2_ms,
                    bound_ms=b2_ms, bound_by=b2_by,
                    **({"f32_ms": rec["f32_spmv2_ms"]} if "f32_ms" in rec
                       else {}))
            report(rec)
            if not (max(errs.values()) <= tol and bits_ok):
                failed.append(rec)
            del data, shard, absd, v, w, vx, wx, got, want, scale
            torch.cuda.empty_cache()
    return failed


def dia_checks(torch, card, timings, report):
    """The checks of every full-DIA kernel entry, at the shapes of both
    full-DIA paths, and of row 4 at the ELL path's; returns the failed
    ones."""
    from new_cg_variants_tpu_torch.ops import fused_family as ff
    from new_cg_variants_tpu_torch.ops import fused_step as fs

    failed = check_dia_spmv(torch, card, timings, report)
    for module, table, shapes, suffix in (
            (fs, DIA_STEP, DIA_SHAPES, ""), (ff, DIA_FAMILY, DIA_SHAPES, ""),
            (fs, VECTOR_PHASES, (WIDE_SHAPE,), WIDE),
            (fs, {"fused_pipe_vector_phase":
                  VECTOR_PHASES["fused_pipe_vector_phase"]},
             (HPCG_VECTOR_SHAPE,), HPCG_VEC)):
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
            + (sf.fused_sym_pipe_full_step_scalars,) + sp.DIA_WRAPPERS
            + fs.FUSED_STEP_WRAPPERS
            + ff.FUSED_FAMILY_WRAPPERS + ds.DF_WRAPPERS + es.ELL_WRAPPERS)


def reset_counts():
    for fn in counted_wrappers():
        fn.launches = 0
    for tally in GRAPH.values():
        tally.clear()


def read_counts():
    """Launches by wrapper since reset_counts: the eager ones, and each
    launch of a captured graph once for every replay of that graph (a
    wrapper counts a capture's launch once, when it is captured)."""
    return {name: n - GRAPH["captured"].get(name, 0)
            + GRAPH["replayed"].get(name, 0)
            for name, n in raw_counts().items()}


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


def protocol_ms(begin, advance, read_nu, chunk_iters, max_trials):
    """bench.py's protocol over a loop: ``begin(scale)`` restarts from the
    right-hand side scaled by ``scale``, ``advance(m)`` chains m steps,
    ``read_nu()`` reads nu back (a sync).  A warm-up chunk, then trials of
    REPEATS chained chunks until the two fastest agree within 5%.  Returns
    (ms/iter, trial seconds, nu at the end)."""
    begin(1.0)
    advance(chunk_iters)
    read_nu()
    times = []
    for trial in range(max_trials):
        begin(1.0 + 1e-6 * (trial + 1))
        read_nu()  # drain the restart before the timer
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            advance(chunk_iters)
        nu_final = read_nu()
        times.append(time.perf_counter() - t0)
        if len(times) >= MIN_TRIALS:
            t1, t2 = sorted(times)[:2]
            if t2 <= 1.05 * t1:
                break
    return min(times) / (REPEATS * chunk_iters) * 1e3, times, nu_final


def profile_window(torch, advance, steps=PROFILE_STEPS):
    """Device busy share, CUDA events and kernel time by name over
    ``advance(steps)`` (a warm-up call of one step first): the six longest
    kernels as ``[name, us a step]`` pairs, each name cut to 160
    characters (cut to 60 as the keys of a dict, two template instances
    of one kernel collided and the shorter hid the longer)."""
    from torch.profiler import ProfilerActivity, profile

    advance(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        advance(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, nspans, by_name = device_activity(prof)
    if not nspans:
        return {"steps": steps, "device_busy_share": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": steps, "wall_ms_per_iter": wall_us / steps / 1e3,
            "device_busy_ms_per_iter": busy / steps / 1e3,
            "device_busy_share": busy / wall_us,
            "kernels_per_iter": nspans / steps,
            "top_kernels_us_per_iter": [[k[:160], v / steps]
                                        for k, v in top]}


def profile_steps(torch, ctx, step_fn, state, steps=PROFILE_STEPS):
    """Device busy share and kernel time by name over ``steps`` steps
    (default PROFILE_STEPS): one step, then ``steps - 1`` profiled
    (profile_window)."""
    _, advance, _ = eager_loop(ctx, None, step_fn, None, None, state)
    return profile_window(torch, advance, steps - 1)


def eager_loop(ctx, init_fn, step_fn, b, x0, state=None):
    """``(begin, advance, read_nu)`` of the eager step loop (protocol_ms's
    arguments): ``begin(scale)`` starts from the right-hand side scaled by
    ``scale`` (or ``state``), ``advance(m)`` chains m steps, ``read_nu()``
    reads nu back."""
    from new_cg_variants_tpu_torch.ops.doublefloat import collapse

    st = {"s": state}

    def begin(scale):
        st["s"] = init_fn(ctx, b * scale, x0)

    def advance(m):
        for _ in range(m):
            st["s"] = step_fn(ctx, st["s"])

    return begin, advance, lambda: float(collapse(st["s"]["nu"]))


def chained_ms(torch, ctx, init_fn, step_fn, b, chunk_iters=ITERS_PER_CHUNK):
    """ms/iter of ``step_fn`` over ``ctx`` as ``bench.py`` times it: 2 x
    5000 (``chunk_iters``) chained iterations per trial, each trial
    restarting on a perturbed right-hand side, until the two fastest trials
    agree within 5%.  Returns ``(ms/iter, trial seconds, nu at the end,
    inits)``."""
    ms, times, nu_final = protocol_ms(
        *eager_loop(ctx, init_fn, step_fn, b, torch.zeros_like(b)),
        chunk_iters, MAX_TRIALS)
    return ms, times, nu_final, 1 + len(times)


def bench_protocol(torch, op, b, fused_wrapper, spmv_wrapper,
                   variant="pipe_pr_cg", init_spmvs=3):
    """``variant`` (default pipe-PR-CG; an unpreconditioned name) on ``op``
    as ``bench.py`` times it, then two timed ``solve(norm_type="none")``
    runs and a profiled window.  Returns the measurements and the launch
    counts next to what they must be: ``init_spmvs`` launches of
    ``spmv_wrapper`` per init and one of ``fused_wrapper`` per iteration,
    nothing else."""
    from new_cg_variants_tpu_torch import solve
    from new_cg_variants_tpu_torch.solvers.context import Context
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES

    init_fn, step_fn = FAMILIES[variant.rsplit("_", 1)[0]]
    ctx = Context(op)
    reset_counts()
    ms_per_iter, times, nu_final, inits = chained_ms(torch, ctx, init_fn,
                                                     step_fn, b)
    solve_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(op, b, variant=variant, max_iter=SOLVE_ITERS,
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
    want.update({spmv_wrapper: init_spmvs * inits, fused_wrapper: steps})
    x = res.x
    resid = float(torch.linalg.norm(b - op.mv(x)) / torch.linalg.norm(b))
    return dict(variant=variant, ms_per_iter=ms_per_iter, trial_seconds=times,
                solve_ms_per_iter=solve_ms, profile=profile,
                nu_final=nu_final, rel_residual=resid, x=x, launches=counts,
                expected_launches=want)


def emit_bench(torch, phase, out, x_true, kernel_ms, **fields):
    """Print a bench_protocol result as a phase line and hold it to its
    checks."""
    x = out.pop("x")
    fwd = float(torch.linalg.norm(x.double().cpu() - torch.from_numpy(x_true))
                / np.linalg.norm(x_true))
    emit(phase, n=N, k=K_BAND, fused_kernel_ms=kernel_ms,
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
    out = bench_protocol(torch, op, b, EPILOGUE, "sym_dia_spmv")
    timings["main_f32"] = {"ms_per_iter": out["ms_per_iter"],
                           "profile": out["profile"]}
    return emit_bench(torch, "main_f32", out, x_true, timings[EPILOGUE]["ms"])


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
    if counts["sym_dia_spmv"] != 3 or counts[EPILOGUE] != F64_ITERS or \
            counts["fused_sym_pipe_full_step"] != 0:
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
    "pipe_p_cg": (EPILOGUE + "/no recompute", 3),
    "pipe_p_m_cg": (EPILOGUE + "/no recompute", 3),
    "pipe_pr_m_cg": (EPILOGUE, 3),
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
    iteration and the SpMV in init only (the unpreconditioned pipe names:
    the entry without the scalar epilogue, which torch forms there)."""
    entry, init_spmvs = VARIANT_ENTRY.get(name, (EPILOGUE, 3))  # pipe_pr_cg
    entry = entry.replace("fused_sym_", "fused_").replace("_scalars", "")
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

    # the generic body: the norm rides the dot batch, so no fused phase.
    # The eager loop's launches: replayed, the tolerance loop runs its last
    # chunk past max_iter and takes it back (jit_solve holds that run)
    reset_counts()
    t0 = time.perf_counter()
    res = solve(op, b, variant="pipe_pr_pcg", preconditioner="jacobi",
                norm_type="unpreconditioned", rtol=0.0,
                max_iter=GENERIC_ITERS, use_jit=False)
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
    timings["dia_f32"] = {"ms_per_iter": out["ms_per_iter"],
                          "profile": out["profile"]}
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
    dense operator (the matrix product is torch's; the vector phase row 4's,
    on the columns of the 2-RHS product)."""
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
                  "dense_spd")], vector_phase_expected)


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


def df_f32x2(torch, built):
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
    built["df_model"] = (dop, b)  # jit_f32x2's operator
    return launches


def df_dense_f32x2(torch, built):
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
    built["df_dense"] = (dop, b)  # jit_df_dense's operator
    return launches


def df_card_vs_cpu(torch):
    """f32x2 on the card (kernels) against the CPU (plain versions) on the
    same words, 25 iterations: collapsed nu and alpha to rtol 1e-10; and the
    one-shot check that the error words survive, on the card."""
    from new_cg_variants_tpu_torch import as_operator, banded_model
    from new_cg_variants_tpu_torch.solvers import api

    api._DF_CHECKED.discard("cuda")
    api.df_selfcheck(torch.device("cuda"))
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
#: (n, label, offsets) of row 4's check at the shape ell_f32's pipe step
#: gives it (the offsets draw a band the vector phase does not read)
HPCG_VECTOR_SHAPE = (HPCG_GRID ** 3, "hpcg", (0,))
#: suffix of row 4's record (timings, the kernels line) at that shape
HPCG_VEC = " (HPCG 104^3)"
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
#: the float64 shapes of convergence_f64 (HPCG 32^3 permuted) and of its
#: post-hoc run (24^3), checked by check_ell too
ELL_F64_GRIDS = (32, 24)
#: row 12 as the parent design ran it, one slot a step (each slot's value
#: and index loads, gather and term in turn): built by main() from this
#: checkout's source with chunks of one slot (build_ell_witness), it is the
#: witness whose bits every product of the committed kernel must give
ELL_WITNESS = {}


def build_ell_witness():
    """Row 12's source with ``kEllChunk = 1``, built from this checkout's
    ``csrc/`` into the package's ignored ``_build/ell-witness/``; returns
    ``{source: library}`` for ``_kernels.using``."""
    import shutil

    from new_cg_variants_tpu_torch.ops import _kernels

    root = _kernels.BUILD_ROOT / "ell-witness"
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for f in _kernels.CSRC.glob("*.cuh"):
        shutil.copy(f, csrc / f.name)
    text, count = re.subn(r"constexpr int kEllChunk = \d+;",
                          "constexpr int kEllChunk = 1;",
                          (_kernels.CSRC / "ell_spmv.cu").read_text())
    if count != 1:
        raise RuntimeError("ell_spmv.cu: no single kEllChunk to set to 1")
    (csrc / "ell_spmv.cu").write_text(text)
    path = _kernels.build(csrc=csrc, build_root=root / "_build")["ell_spmv.cu"]
    return {"ell_spmv.cu": _kernels.load("ell_spmv.cu", path)}


def witness_same(torch, calls, got):
    """Whether ``got`` equals, bit for bit, what ``calls()`` returns on the
    witness build of row 12 (``None`` where main() built none)."""
    if not ELL_WITNESS:
        return None
    from new_cg_variants_tpu_torch.ops import _kernels

    with _kernels.using(ELL_WITNESS):
        want = calls()
    return same_bits(torch, got, want)


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
    equal the given order's bit for bit, and its gather in ``v[perm]``;
    every product also the witness's (``ELL_WITNESS``, where built).  With
    ``perm`` also the product a solve in the operator's basis runs (an
    ``ell_spmv_basis`` line): ``B`` with no order on ``v[perm]`` (and
    ``w[perm]``), the given order's results permuted, bit for bit.  Timed
    (with the plain versions, cuSPARSE and the bound) when ``timings``,
    into records named with ``sfx`` (default: none for a permuted pattern,
    NATURAL else): the basis's product where there is an order (the
    locality order's, gather and scatter included, and the given order's
    beside it).  bf16 values (with float32 vectors) are also held to the
    float32 entries on the widened values, bit for bit in both orders, and
    timed beside them (no library call)."""
    from new_cg_variants_tpu_torch.ops import ell_spmv as es

    val, idx, csr = ell_arrays(torch, a, rng, dtype)
    n, L = val.shape
    bf16 = dtype == torch.bfloat16
    v, w = (torch.as_tensor(rng.standard_normal(n),
                            dtype=vector_dtype(torch, dtype), device="cuda")
            for _ in range(2))
    y = es.ell_spmv(val, idx, v)
    y2, z2 = es.ell_spmv2(val, idx, v, w)
    witness = witness_same(torch, lambda: (
        es.ell_spmv(val, idx, v), *es.ell_spmv2(val, idx, v, w)), (y, y2, z2))
    bits_ok = True
    if bf16:
        wide = val.T.float().T
        bits_ok = same_bits(torch, (y, y2, z2), (
            es.ell_spmv(wide, idx, v), *es.ell_spmv2(wide, idx, v, w)))
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
        if witness is not None:
            witness = witness and witness_same(torch, lambda: (
                es.ell_spmv(bval, bidx, v, p),
                *es.ell_spmv2(bval, bidx, v, w, p)), (ry, ry2, rz2))
        if bf16:
            bwide = bval.T.float().T
            bits_ok = bits_ok and same_bits(torch, (ry, ry2, rz2), (
                es.ell_spmv(bwide, bidx, v, p),
                *es.ell_spmv2(bwide, bidx, v, w, p)))
        gathered, gather_want = es.ell_gather(p, [v]), v[p.long()]
        got += [(ry, yp, ys), (ry2, yp, ys), (rz2, zp, zs)]
        same = all(bool(torch.equal(g, want)) for g, want in (
            (ry, y), (ry2, y2), (rz2, z2)))
        gather_err = float((gathered - gather_want).abs().max())
        gather_same = bool(torch.equal(gathered, gather_want))
        rec.update(orders=["given", "locality"], same_bits_as_given=same,
                   gather_bitwise=gather_same)
        # the product a solve in the operator's basis runs: B with no order
        # on v[perm] gives the given order's y[perm], the same terms in the
        # same slot order
        bv, bw = gather_want, w[p.long()]
        basis_same = same_bits(torch, (
            es.ell_spmv(bval, bidx, bv), *es.ell_spmv2(bval, bidx, bv, bw)),
            (y[p.long()], y2[p.long()], z2[p.long()]))
        report(dict(kernel="ell_spmv_basis", shape=label, dtype=dn, n=n, L=L,
                    same_bits_as_given_permuted=basis_same))
        ok = same and gather_same and basis_same
    torch.cuda.synchronize()
    errs = [cw_err(torch, g, want, sc) for g, want, sc in got]
    abs_err = max(float((g - want).abs().max()) for g, want, _ in got)
    rec.update(max_err=max(errs), max_abs_err=abs_err, tol=TOL[dn])
    if bf16:
        rec["same_bits_as_f32_entry"] = bits_ok
        ok = ok and bits_ok
    if witness is not None:
        rec["same_bits_as_witness"] = witness
        ok = ok and witness
    if timings is not None:
        isz, vsz = val.element_size(), v.element_size()
        b_ms, b_by = bound(n * L * (isz + 4) + 2 * n * vsz, 2 * n * L, dn,
                           rate)
        b2_ms, b2_by = bound(n * L * (isz + 4) + 4 * n * vsz, 4 * n * L, dn,
                             rate)
        given = dict(
            ms=time_ms(torch, lambda: es.ell_spmv(val, idx, v), 50),
            spmv2_ms=time_ms(torch, lambda: es.ell_spmv2(val, idx, v, w), 50))
        plain_ms = time_ms(torch, lambda: es._ell_mv_plain(val, idx, v), 5)
        plain2_ms = time_ms(torch,
                            lambda: es._ell_mv2_plain(val, idx, v, w), 5)
        common = dict(n=n, L=L, max_abs_err=abs_err)
        if bf16:
            # no library call takes bf16 values with float32 vectors
            lib_ms = lib2_ms = None
        else:
            vw = torch.stack([v, w], dim=1)
            rec["library_err"] = cw_err(torch, csr @ v, yp, ys)
            lib_ms = time_ms(torch, lambda: csr @ v, 50)
            lib2_ms = time_ms(torch, lambda: csr @ vw, 50)
            common["library"] = ("cuSPARSE CSR through torch (csr @ v, "
                                 "csr @ [v w])")
            del vw
        rec.update(given_order_ms=given["ms"],
                   given_order_spmv2_ms=given["spmv2_ms"], plain_ms=plain_ms,
                   plain2_ms=plain2_ms, library_ms=lib_ms,
                   library2_ms=lib2_ms, bound_ms=b_ms,
                   bound_by=b_by, spmv2_bound_ms=b2_ms)
        if perm is None:
            ms, ms2 = given["ms"], given["spmv2_ms"]
            if bf16:
                f32 = (wide, idx, v, w)
        else:
            # the record is the product a solve runs, B's in the basis; the
            # product of A from B's storage (gather in, scatter out) and the
            # given order beside it
            ms = time_ms(torch, lambda: es.ell_spmv(bval, bidx, bv), 50)
            ms2 = time_ms(torch, lambda: es.ell_spmv2(bval, bidx, bv, bw),
                          50)
            locality = dict(
                ms=time_ms(torch, lambda: es.ell_spmv(bval, bidx, v, p), 50),
                spmv2_ms=time_ms(
                    torch, lambda: es.ell_spmv2(bval, bidx, v, w, p), 50),
                plain_ms=time_ms(torch, lambda: es._ell_reordered_plain(
                    bval, bidx, p, [v]), 5))
            if bf16:
                f32 = (bwide, bidx, bv, bw)
            else:
                bcsr = device_csr(torch, bval.T, bidx.T, n)
                bvw = torch.stack([bv, bw], dim=1)
                lib_ms = time_ms(torch, lambda: bcsr @ bv, 50)
                lib2_ms = time_ms(torch, lambda: bcsr @ bvw, 50)
                common["library"] = ("cuSPARSE CSR of B through torch "
                                     "(csr @ v[perm], csr @ [v w][perm])")
                rec.update(library_ms=lib_ms, library2_ms=lib2_ms)
                del bcsr, bvw
            plain_ms = time_ms(
                torch, lambda: es._ell_mv_plain(bval, bidx, bv), 5)
            plain2_ms = time_ms(
                torch, lambda: es._ell_mv2_plain(bval, bidx, bv, bw), 5)
            g_ms = time_ms(torch, lambda: es.ell_gather(p, [v]), 50)
            g2_ms = time_ms(torch, lambda: es.ell_gather(p, [v, w]), 50)
            g_plain_ms = time_ms(torch, lambda: es._ell_gather_plain(p, [v]),
                                 50)
            g_lib_ms = time_ms(torch, lambda: torch.index_select(v, 0, p), 50)
            g_ms_bound, g_by = bound(n * (4 + 2 * isz), 0, dn, rate)
            rec.update(ms=ms, spmv2_ms=ms2, basis_plain_ms=plain_ms,
                       basis_plain2_ms=plain2_ms, locality_ms=locality["ms"],
                       locality_spmv2_ms=locality["spmv2_ms"],
                       gather_ms=g_ms, gather2_ms=g2_ms)
            timings["ell_gather" + (sfx or "")] = dict(
                n=n, max_abs_err=gather_err,
                ms=g_ms, ms_2rhs=g2_ms, plain_ms=g_plain_ms,
                library_ms=g_lib_ms, library="torch.index_select(v, 0, perm)",
                bound_ms=g_ms_bound, bound_by=g_by)
            common["given_order"] = given
            common["locality_order"] = locality
        f32_ms = {}
        if bf16:
            fv, fi, fx, fy = f32
            f32_ms = dict(
                f32_ms=time_ms(torch, lambda: es.ell_spmv(fv, fi, fx), 50),
                f32_spmv2_ms=time_ms(
                    torch, lambda: es.ell_spmv2(fv, fi, fx, fy), 50))
            rec.update(f32_ms)
            del f32, fv, fi, fx, fy
        if perm is not None:
            del bval, bidx, p, bv, bw
        if sfx is None:
            sfx = "" if "permuted" in label else NATURAL
        timings["ell_spmv" + sfx] = dict(
            common, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by,
            **({"f32_ms": f32_ms["f32_ms"]} if bf16 else {}))
        timings["ell_spmv2" + sfx] = dict(
            common, ms=ms2, plain_ms=plain2_ms, library_ms=lib2_ms,
            bound_ms=b2_ms, bound_by=b2_by,
            **({"f32_ms": f32_ms["f32_spmv2_ms"]} if bf16 else {}))
    report(rec)
    del val, idx, csr, v, w
    torch.cuda.empty_cache()
    return [] if ok and max(errs) <= TOL[dn] else [rec]


@functools.lru_cache(maxsize=2)
def hpcg_case(perm_seed):
    """HPCG's pattern at full size (``stencil27(HPCG_GRID, perm_seed)``) and
    the locality order its operator keeps, built once for every check that
    takes them (the host's RCM takes seconds)."""
    a = stencil27(HPCG_GRID, perm_seed)
    return a, locality_order(a)


def ell_checks(torch, card, timings, report, dtypes=("float32", "float64"),
               suffix=""):
    """Row 12 (``ell_spmv``, ``ell_spmv2`` and the gather in) against its
    plain version on the card in ``dtypes``, every value in units of its
    own scale ``(|A| |v|)_i``: HPCG's pattern at full size in natural order
    (which the operator keeps) and permuted (in the RCM order the operator
    takes, and in the given one: timed in the first dtype, into records
    named with ``suffix``), then the small shapes in the given order and in
    a locality order (RCM, or a random one where RCM does not narrow the
    band) and, in float64, convergence_f64's shapes (HPCG 32^3 and 24^3
    permuted, in their RCM order).  Returns the failed checks."""
    rate = memory_rate(card)
    failed = []
    grid = f"27-point {HPCG_GRID}^3"
    for label, seed in ((grid, None), (grid + " permuted", PERM_SEED)):
        a, perm = hpcg_case(seed)
        sfx = suffix + ("" if seed is not None else NATURAL)
        for dn in dtypes:
            failed += check_ell_shape(
                torch, label, a, np.random.default_rng(12),
                getattr(torch, dn), rate,
                timings if timings is not None and dn == dtypes[0] else None,
                report, perm, sfx=sfx)
    for label, n, lens in ELL_SMALL:
        rng = np.random.default_rng(n)
        a = small_pattern(n, lens, rng)
        perm = locality_order(a)
        if perm is None:
            perm = rng.permutation(n)
        for dn in dtypes:
            failed += check_ell_shape(torch, label, a, rng,
                                      getattr(torch, dn), rate, None, report,
                                      perm)
    if "float64" in dtypes:
        for g in ELL_F64_GRIDS:
            a = stencil27(g, PERM_SEED)
            failed += check_ell_shape(
                torch, f"27-point {g}^3 permuted", a,
                np.random.default_rng(12), torch.float64, rate, None, report,
                locality_order(a))
    return failed


def check_ell(torch, card, timings):
    failed = ell_checks(torch, card, timings, emit_check)
    if failed:
        raise AssertionError(f"{len(failed)} ELL checks disagree: {failed}")


def ell_expected(name, iters, moved=2):
    """Launches a name makes on an ``EllOperator`` in a locality order (as
    both ELL phases build it): the solve runs in the operator's basis
    (``solver_basis``), on its stored ``B`` with no order, and every fused
    phase that reads the band declines, so the generic body: ``ell_spmv2``
    once per iteration for the pipe names that recompute, else ``ell_spmv``
    once per product (and the products of init), none of them gathering;
    the unpreconditioned pipe step (``pipe_*_cg``) takes the vector-phase
    kernel (row 4) once per iteration; ``ell_gather`` once for each of the
    ``moved`` vectors taken into the basis (``b`` and ``x0``; ``x_true``
    too under an error probe)."""
    split, _ = split_expected(name, iters)
    counts = {"ell_spmv": split["dia_spmv"]}
    if "dia_spmv2" in split:
        counts["ell_spmv2"] = split["dia_spmv2"]
    counts.update(vector_phase_expected(name, iters)[0])
    counts["ell_gather"] = moved
    return counts, "ell_spmv"


def read_mtx_seconds(path):
    """Host seconds of ``read_mtx`` on ``path`` through the native reader
    (built first, its seconds apart) and through the Python parser; the two
    CooMatrix must be the same, entry for entry."""
    from new_cg_variants_tpu_torch import read_mtx
    from new_cg_variants_tpu_torch.matio import _native
    from new_cg_variants_tpu_torch.matio.matrix_market import NATIVE_MIN_NNZ

    t0 = time.perf_counter()
    _native.build()
    build_s = time.perf_counter() - t0
    seconds = {}
    for native in (True, False):
        t0 = time.perf_counter()
        seconds[native] = (read_mtx(path, native=native),
                           time.perf_counter() - t0)
    (got, native_s), (want, python_s) = seconds[True], seconds[False]
    same = all(np.array_equal(getattr(got, f), getattr(want, f))
               for f in ("row", "col", "val"))
    rec = dict(read_mtx_native_seconds=native_s,
               read_mtx_python_seconds=python_s,
               native_build_seconds=build_s, file_nnz=int(want.nnz),
               native_route=want.nnz > NATIVE_MIN_NNZ,
               native_same_coo=same)
    if not same:
        raise AssertionError(f"native and Python readers differ: {rec}")
    return rec


def ell_pack_seconds(a):
    """Host seconds of the padded-ELL packing of scipy matrix ``a``:
    ``build_ell`` (the stable (row, col) sort, then the native
    ``pack_ell``) against the same sort then the vectorised numpy packing
    it replaced; the same bits required."""
    from new_cg_variants_tpu_torch.matio import _native
    from new_cg_variants_tpu_torch.ops.operators import (
        _build_ell_numpy,
        build_ell,
        coo_from_scipy,
    )

    coo = coo_from_scipy(a)
    _native.build()
    seconds, out = {}, {}
    for name, fn in (("build_ell_native", build_ell),
                     ("build_ell_numpy", _build_ell_numpy)):
        t0 = time.perf_counter()
        out[name] = fn(coo)
        seconds[name + "_seconds"] = time.perf_counter() - t0
    (got_val, got_idx, _), (want_val, want_idx, _) = out.values()
    same = (got_val.tobytes() == want_val.tobytes()
            and np.array_equal(got_idx, want_idx))
    rec = dict(seconds, ell_pack_same_bits=same)
    if not same:
        raise AssertionError(f"the native and numpy ELL packings differ: "
                             f"{rec}")
    return rec


def ell_f32(torch, built):
    """HPCG's operator (27-point, 104^3) under a random symmetric
    permutation, handed over as scipy CSR in float32: the auto route must
    pick ELL (with its warning); all 18 names on the one operator, solved
    in its RCM basis: each product one row-12 launch with no gather, two
    gathers a solve (``b`` and ``x0`` into the basis); the profile of the
    step on ``B``; one solve that converges.  The operator is left in
    ``built`` for ell_bf16 and dist_ell_f32."""
    import warnings

    from new_cg_variants_tpu_torch import (
        VARIANT_NAMES,
        EllOperator,
        as_operator,
        solve,
    )
    from new_cg_variants_tpu_torch.ops.block_banded import solver_basis
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
         build_host_seconds=build_s, **ell_pack_seconds(a))
    if not (reordered and warned):
        raise AssertionError(f"auto route gave {type(op).__name__}, "
                             f"warned={warned}, reordered={reordered}: "
                             "expected ELL in RCM order with a warning")
    launches, failed = solve_names(
        torch, "ell_f32", op, b, x_true, ("pipe_pr_cg",), ell_expected,
        iters=ELL_ITERS, n=n)
    # the step the solve runs: on B in the operator's basis
    basis_op, to_basis, _ = solver_basis(op)
    init_fn, step_fn = FAMILIES["pipe_pr"]
    ctx = Context(basis_op)
    bb = to_basis(b)
    emit("ell_f32", variant="pipe_pr_cg", profile=profile_steps(
        torch, ctx, step_fn, init_fn(ctx, bb, torch.zeros_like(bb))))
    del ctx, bb
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
    # ell_bf16 stores it in bf16; dist_ell_f32 runs it on the row context
    built["hpcg_ell"] = (a, op, b, x_true)
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


#: the entries of the full-DIA family kernel that read the band (DIA_STEP
#: without the vector phases)
DIA_BAND_STEP = {entry: spec for entry, spec in DIA_STEP.items()
                 if entry not in VECTOR_PHASES}
BF16_ACCURACY_N = 8192
BF16_ACCURACY_ITERS = 200
BF16_DENSE_N = 4096
#: tests/test_bf16_storage.py's floor properties: the best relative A-norm
#: error under this, f32 storage FLOOR_DEPTH times deeper
BF16_FLOOR_MAX = 5e-3
BF16_FLOOR_DEPTH = 100.0
#: card against CPU on the same bf16 data: histories within this through
#: BF16_CMP_ITERS iterations
BF16_RTOL = 1e-4
BF16_CMP_ITERS = 16


def bf16_checks(torch, card, timings, report):
    """Every bf16-storage entry (rows 1, 2, 2b, 3, 6, 7, 8 and 12) against
    its plain version and, bit for bit, against the float32 entry on the
    widened data, at the shapes of check_sym, check_dia and check_ell;
    timed beside the float32 entry at the paths' shapes (records named with
    BF16).  Returns the failed checks."""
    from new_cg_variants_tpu_torch.ops import fused_family as ff
    from new_cg_variants_tpu_torch.ops import fused_step as fs
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    bf = ("bfloat16",)
    failed = check_spmv(torch, card, timings, report, dtypes=bf,
                        timed=((N, K_BAND), "bfloat16"), suffix=BF16)
    shapes = tuple((n, k, tuple(range(k))) for n, k in SYM_SHAPES)
    failed += check_entries(torch, card, timings, sf, FAMILY, shapes,
                            random_band, 4, BF16, report, dtypes=bf,
                            timed_dtype="bfloat16")
    failed += check_dia_spmv(torch, card, timings, report, dtypes=bf,
                             suffix=BF16)
    for module, table in ((fs, DIA_BAND_STEP), (ff, DIA_FAMILY)):
        failed += check_entries(torch, card, timings, module, table,
                                DIA_SHAPES, random_dia, 2, BF16, report,
                                dtypes=bf, timed_dtype="bfloat16")
    failed += ell_checks(torch, card, timings, report, dtypes=bf, suffix=BF16)
    return failed


def check_bf16(torch, card, timings):
    """The bf16 checks; raises after all ran."""
    failed = bf16_checks(torch, card, timings, emit_check)
    hpcg_case.cache_clear()
    if failed:
        raise AssertionError(f"{len(failed)} bf16 checks disagree: {failed}")


def model_bf16(torch, fmt):
    """main_f32's problem with its band stored in bf16 on the card (the
    vectors in float32), rounded once from the float64 band."""
    from new_cg_variants_tpu_torch import banded_model

    op64, b64, x_true = banded_model(N, k=K_BAND, fmt=fmt, device="cpu")
    op = op64.astype(torch.bfloat16).to("cuda")
    b = torch.as_tensor(b64, dtype=torch.float32, device="cuda")
    if op.data.dtype != torch.bfloat16:
        raise AssertionError(f"band stored as {op.data.dtype}")
    return op, b, x_true


def stored_values(op):
    """Values the operator stores (band or ELL values)."""
    return (op.val_t if hasattr(op, "val_t") else op.data).numel()


def storage_check(torch, op, b, variant, precond=None):
    """The device memory a short solve takes beyond what is allocated
    before it, against the bytes a float32 copy of the stored matrix would
    take: a path that widened the band to float32 once, before the
    iterations, would need at least that much (the kernels read the bf16
    storage in place).  Returns the record and whether it holds."""
    from new_cg_variants_tpu_torch import solve

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    solve(op, b, variant=variant, max_iter=GENERIC_ITERS, norm_type="none",
          preconditioner=precond)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    copy = 4 * stored_values(op)
    return (dict(storage=dtype_name(op.dtype), peak_extra_bytes=extra,
                 f32_copy_bytes=copy, variant=variant), extra < copy)


def main_bf16(torch, timings):
    """The main path on bf16 storage: main_f32's problem with its band in
    bf16; pipe-PR-CG and hs-CG (the two arms of the JAX package's
    benchmarks/bf16_study.py) under the bench protocol, the profiler's
    kernels per iteration equal to main_f32's (no cast on the way); the
    other 17 names for 100 iterations each, each its own fused entry once
    per iteration.  Returns the launches by entry."""
    op, b, x_true = model_bf16(torch, "symdia")
    launches, failed = {}, []
    for variant, entry, init in (
            ("pipe_pr_cg", EPILOGUE, 3),
            ("hs_cg", "fused_sym_hs_matvec_phase", 2)):
        out = bench_protocol(torch, op, b, entry, "sym_dia_spmv",
                             variant=variant, init_spmvs=init)
        if variant == "pipe_pr_cg":
            timings["main_bf16"] = {"ms_per_iter": out["ms_per_iter"],
                                    "profile": out["profile"]}
        f32 = timings["main_f32"]
        kpi, kpi32 = (o["profile"].get("kernels_per_iter")
                      for o in (out, f32))
        add_counts(launches, emit_bench(
            torch, "main_bf16", out, x_true, timings[entry + BF16]["ms"],
            storage="bfloat16", f32_fused_kernel_ms=timings[entry + BF16][
                "f32_ms"], main_f32_ms_per_iter=f32["ms_per_iter"],
            main_f32_profile=f32["profile"]))
        if variant == "pipe_pr_cg" and not (kpi is not None
                                            and abs(kpi - kpi32) < 0.5):
            failed.append(dict(variant=variant, kernels_per_iter=kpi,
                               f32=kpi32))
    rec, ok = storage_check(torch, op, b, "pipe_pr_cg")
    emit("main_bf16", **rec)
    if not ok:
        failed.append(rec)
    more, failed2 = solve_names(torch, "main_bf16", op, b, x_true,
                                VARIANT_ENTRY, sym_expected,
                                iters=GENERIC_ITERS, n=N, k=K_BAND,
                                storage="bfloat16")
    add_counts(launches, more)
    failed += failed2
    if failed:
        raise AssertionError(f"{len(failed)} bf16 runs failed: {failed}")
    return launches


def dia_bf16(torch):
    """The full-DIA path on bf16 storage: main_f32's problem in 63
    diagonals, band in bf16; all 18 names for 100 iterations, each its own
    entry of the full-DIA family kernel once per iteration (rows 6-8), and
    one split-path run (row 4's preconditioned vector phase, then row 3's
    2-right-hand-side product).  Returns the launches by entry."""
    from new_cg_variants_tpu_torch import VARIANT_NAMES
    from new_cg_variants_tpu_torch.solvers.context import Context
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES

    op, b, x_true = model_bf16(torch, "dia")
    launches, failed = solve_names(torch, "dia_bf16", op, b, x_true,
                                   VARIANT_NAMES, dia_expected,
                                   iters=GENERIC_ITERS, n=N, k=K_BAND,
                                   fmt="dia", storage="bfloat16")
    inv = 1.0 / op.diagonal().float()
    split, failed2 = solve_names(
        torch, "dia_bf16", op, b, x_true, ("pipe_pr_pcg",), split_expected,
        lambda name, op: ("inverse diagonal, as a function", lambda v: inv * v),
        iters=GENERIC_ITERS, n=N, k=K_BAND, fmt="dia", path="split",
        storage="bfloat16")
    failed += failed2
    add_counts(launches, split)
    init_fn, step_fn = FAMILIES["pipe_pr"]
    ctx = Context(op)
    rec, ok = storage_check(torch, op, b, "pipe_pr_cg")
    emit("dia_bf16", profile=profile_steps(
        torch, ctx, step_fn, init_fn(ctx, b, torch.zeros_like(b))), **rec)
    if not ok:
        failed.append(rec)
    if failed:
        raise AssertionError(f"{len(failed)} bf16 DIA runs failed: {failed}")
    return launches


def ell_bf16(torch, built):
    """ell_f32's operator (HPCG 27-point, 104^3, permuted, ELL in RCM order)
    with its values stored in bf16 (``astype``): pipe-PR-CG and hs-PCG with
    Jacobi for 100 iterations in the operator's basis, one row-12 launch a
    product and two gathers a solve; what the auto route picks for this
    matrix in bf16.  Returns the launches by entry."""
    from new_cg_variants_tpu_torch import EllOperator
    from new_cg_variants_tpu_torch.ops.block_banded import solver_basis
    from new_cg_variants_tpu_torch.ops.operators import (
        choose_format,
        coo_from_scipy,
    )
    from new_cg_variants_tpu_torch.solvers.context import Context
    from new_cg_variants_tpu_torch.solvers.families import FAMILIES

    a, op32, b, x_true = built["hpcg_ell"]
    op = op32.astype(torch.bfloat16)
    del op32
    t0 = time.perf_counter()
    auto = choose_format(coo_from_scipy(a), dtype=torch.bfloat16)
    emit("ell_bf16", n=op.n, operator=type(op).__name__,
         values=dtype_name(op.val_t.dtype), locality_order=op.perm is not None,
         auto_route_bf16=auto, auto_route_seconds=time.perf_counter() - t0)
    if not (isinstance(op, EllOperator) and op.dtype == torch.bfloat16
            and op.perm is not None):
        raise AssertionError("expected a bf16 ELL operator in RCM order")
    launches, failed = solve_names(
        torch, "ell_bf16", op, b, x_true, ("pipe_pr_cg", "hs_pcg"),
        ell_expected, iters=GENERIC_ITERS, n=op.n, storage="bfloat16")
    basis_op, to_basis, _ = solver_basis(op)
    init_fn, step_fn = FAMILIES["pipe_pr"]
    ctx = Context(basis_op)
    bb = to_basis(b)
    rec, ok = storage_check(torch, op, b, "pipe_pr_cg")
    emit("ell_bf16", profile=profile_steps(
        torch, ctx, step_fn, init_fn(ctx, bb, torch.zeros_like(bb))), **rec)
    if not ok:
        failed.append(rec)
    if failed:
        raise AssertionError(f"{len(failed)} bf16 ELL runs failed: {failed}")
    return launches


def floor_iteration(rel):
    """The first iteration within a factor 2 of the best error."""
    return int(np.argmax(rel <= 2.0 * np.nanmin(rel)))


def bf16_accuracy(torch):
    """tests/test_bf16_storage.py's floor properties on the card:
    ``banded_model(8192, k=8, kappa=100)`` in half-band and full-DIA storage,
    hs-PCG with Jacobi for 200 iterations: bf16 storage's best relative
    A-norm error under 5e-3, float32 storage's 100 times deeper; card
    against CPU on the same bf16 data: the same iteration to the floor, the
    histories within rtol 1e-4 through iteration 15; a dense (n = 4096) and
    a permuted block-banded bf16 operator the same way against the CPU.
    Each card run launches what its operator kind prescribes (the band's
    hs entry once a step, its SpMV in init and once a row for the probe;
    dense and block-banded: no kernel)."""
    import scipy.sparse as sp

    from new_cg_variants_tpu_torch import as_operator, banded_model, run
    from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy, from_coo

    kw = dict(max_iter=BF16_ACCURACY_ITERS, preconditioner="jacobi",
              probes=("error_A_norm",))
    failed = []

    def rel_error(op, b, xt, device):
        out = run("hs_pcg", op, b, x_true=xt, device=device, **kw)
        if out["x"].dtype != torch.float32:
            raise AssertionError(f"solution in {out['x'].dtype}")
        return out["error_A_norm"] / out["error_A_norm"][0]

    def expected(fmt):
        """hs_pcg's launches on ``fmt``: 199 steps and 200 probe rows."""
        steps = BF16_ACCURACY_ITERS - 1
        by_fmt, _ = (sym_expected if fmt == "symdia" else dia_expected)(
            "hs_pcg", steps)
        spmv = "sym_dia_spmv" if fmt == "symdia" else "dia_spmv"
        return add_counts(dict(by_fmt), {spmv: BF16_ACCURACY_ITERS})

    def compare(label, op, b, xt, want, f32_op=None):
        if op.dtype != torch.bfloat16:
            raise AssertionError(f"{label} stored as {op.dtype}")
        reset_counts()
        card = rel_error(op.to("cuda"), b, xt, "cuda")
        counts = nonzero(read_counts())
        cpu = rel_error(op, b, xt, "cpu")
        cmp = slice(0, BF16_CMP_ITERS)
        diff = float(np.max(np.abs(card[cmp] - cpu[cmp]) / np.abs(cpu[cmp])))
        rec = dict(operator=label, n=op.n, storage=dtype_name(op.dtype),
                   best=float(np.nanmin(card)), cpu_best=float(np.nanmin(cpu)),
                   floor_iteration=floor_iteration(card),
                   cpu_floor_iteration=floor_iteration(cpu),
                   max_rel_diff_to_iteration_15=diff, rtol=BF16_RTOL,
                   launches=counts, expected_launches=want)
        ok = (rec["best"] < BF16_FLOOR_MAX and diff <= BF16_RTOL
              and rec["floor_iteration"] == rec["cpu_floor_iteration"]
              and counts == want)
        if f32_op is not None:
            rec["f32_best"] = float(np.nanmin(rel_error(
                f32_op.to("cuda"), b, xt, "cuda")))
            ok = ok and rec["f32_best"] < rec["best"] / BF16_FLOOR_DEPTH
        emit("bf16_accuracy", **rec)
        if not ok:
            failed.append(rec)

    for fmt in ("symdia", "dia"):
        op64, b64, xt = banded_model(BF16_ACCURACY_N, k=8, kappa=100.0,
                                     fmt=fmt, device="cpu")
        compare(fmt, op64.astype(torch.bfloat16), b64, xt, expected(fmt),
                f32_op=op64.astype(torch.float32))
    op64, b64, xt = banded_model(BF16_DENSE_N, k=8, kappa=100.0, fmt="dia",
                                 device="cpu")
    compare("dense", as_operator(op64.todense(), dtype=torch.bfloat16,
                                 device="cpu"), b64, xt, {})
    a = permuted(sp.csr_matrix(op64.tocsr()), PERM_SEED)
    x_true = np.ones(a.shape[0])
    compare("block_banded (permuted)",
            from_coo(coo_from_scipy(a), fmt="block_banded",
                     dtype=torch.bfloat16, device="cpu"), a @ x_true, x_true,
            {})
    if failed:
        raise AssertionError(f"{len(failed)} bf16 accuracy runs failed: "
                             f"{failed}")


def host_residual(a, b, x):
    """||b - A x|| / ||b|| on the host in float64 (scipy)."""
    x64 = x.double().cpu().numpy()
    return float(np.linalg.norm(b - a @ x64) / np.linalg.norm(b))


def vector_phase_expected(name, iters):
    """Launches a name makes on an operator no other kernel serves (dense,
    stencil, block-banded): the unpreconditioned pipe step (``pipe_*_cg``;
    a ``_pcg`` name keeps its preconditioned body, with M = I too) takes
    the vector-phase kernel (row 4) once per iteration, which reads no
    operator; nothing else launches."""
    if name.startswith("pipe_") and name.endswith("_cg"):
        return {"fused_pipe_vector_phase": iters}, "fused_pipe_vector_phase"
    return {}, None


def formats_f32(torch, built):
    """(a) The PETSc model problem as scipy CSR under a random symmetric
    permutation: the auto route must pick the block-banded packing (RCM
    recovers the band); pipe-PR-CG for 300 iterations, ``x`` back in the
    original order, its residual within 10x of the half-band path's on the
    unpermuted problem.  (b) The same problem unpermuted: the auto route must
    pick the stencil; it and ``banded_model(fmt="stencil")`` for 300
    iterations.  No path here reaches a kernel but the vector phase's (row
    4), once per iteration.  The block-banded operator is left in ``built``
    for dist_formats_f32."""
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
        kernel may launch but row 4, once per iteration."""
        solve(op, b, variant="pipe_pr_cg", max_iter=5, norm_type="none")
        torch.cuda.synchronize()
        reset_counts()
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
        want = vector_phase_expected("pipe_pr_cg", FORMATS_ITERS)[0]
        if ((counts != want and not kernels)
                or not np.isfinite(rec["rel_residual"])):
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
        built["model_block"] = (op, bp)  # dist_formats_f32's operator
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
    compare_f64(torch, "sparse_f64", cases, vector_phase_expected)

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
#: ``solve --dtype bf16``: main_f32's width at kappa 100, which converges to
#: this in ~50 iterations
CLI_BF16_KAPPA = 100.0
CLI_BF16_RTOL = 1e-5
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
        emit("convergence_f64", **read_mtx_seconds(str(d / "hpcg27.mtx")))
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
        # a product in the basis gathers nothing; a history run takes b, x0
        # and x_true (its error probes) into the basis: three gathers
        ell_product = {"ell_spmv": 1}

        def ell_run_expected(name, iters):
            return ell_expected(name, iters, moved=3)
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
            ell_run_expected, ell_product, data_dir=data,
            include_exact=True, device="cuda")
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
    output files and launch counts; ``solve --devices 2`` must raise the
    error that names ``torchrun`` (one process here), and ``solve --dtype
    bf16`` converge through the half-band kernels' bf16 entries."""
    import contextlib
    import io
    import json as js
    import pathlib
    import tempfile

    from new_cg_variants_tpu_torch import cli

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
            EPILOGUE: CLI_ITERS * CLI_REPEATS}
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
            entry, init = VARIANT_ENTRY.get(name, (EPILOGUE, 3))
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
    except ValueError as exc:
        refused = str(exc)
    else:
        refused = None
    emit("cli_f32", command="solve --devices 2", raised=refused)
    if not (refused and "torchrun --nproc-per-node 2" in refused):
        failed.append(dict(devices=2, raised=refused))
    # bf16 storage: the band in bf16 reaches the kernels' bf16 entries, and
    # the solve converges (to the bf16 matrix's solution)
    rc, lines, counts, seconds = main(
        ["solve", "-n", str(N), "-k", str(K_BAND), "--kappa",
         str(CLI_BF16_KAPPA), "--dtype", "bf16", "--ksp-type", "pipe_pr_cg",
         "--rtol", str(CLI_BF16_RTOL), "--max-iter", str(CLI_ITERS)])
    fields = dict(kv.split("=", 1) for ln in lines[:3] for kv in ln.split()
                  if "=" in kv)
    rec = dict(command="solve --dtype bf16", rc=rc, lines=lines,
               seconds=seconds, launches=counts)
    emit("cli_f32", **rec)
    half_band = {"sym_dia_spmv", "sym_dia_spmv2", EPILOGUE}
    if not (rc == 0 and fields.get("converged") == "True"
            and counts.get(EPILOGUE, 0) > 0
            and set(counts) <= half_band):
        failed.append(rec)
    launches["cli_bf16"] = counts
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
    want = {EPILOGUE: TRACE_STEPS}
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


#: the row-partitioned distributed layer (parallel/) at world size 1 on the
#: card (NCCL): history rows held to the single-device run (iteration 15)
DIST_ROWS = 16
DIST_RTOL = 1e-4
DIST_SOLVE_ITERS = 300
DIST_STEPS = 20
#: the chunk of a mesh case's replays under the bench protocol
DIST_REPLAY_ITERS = 200
#: the bench protocol's chunk in dist_f32 (the row context runs ~1 ms/iter
#: at world size 1: 2 x 5000-iteration chunks would take ~10 s a trial)
DIST_CHUNK_ITERS = 1000
DIST_F64_N = 65_536
DIST_NAMES = ("pipe_pr_cg", "hs_cg", "pipe_pr_pcg")
#: all-reduces per iteration of each family in the row partition
DIST_SYNCS = {"pipe_pr": 1, "hs": 2}
#: suffix of a kernel's record at the shapes the row partition gives it: the
#: extended slice of m + 2h rows (half-band), the halo-extended vectors
#: (DIA), the m rows of the vector phases; m = n at world size 1
DIST = " (dist)"
DIST_EXT_N = N + 2 * (K_BAND - 1)


@contextlib.contextmanager
def dist_world():
    """A world of one on the card, made from the environment ``torchrun``
    sets (``MASTER_ADDR``, a free ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``): yields the port's mesh; the process group is destroyed
    on leaving, after a failed check too."""
    import socket

    import torch.distributed as dist

    from new_cg_variants_tpu_torch.parallel import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield make_mesh(device="cuda")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def dist_expected(name, fmt, steps):
    """Launches of a row-partition run of ``name`` (pipe_pr or hs) at world
    size 1 with ``steps`` iterations: half-band, the SpMV on the extended
    slice (2 RHS for pipe_pr); full DIA, the ``_ext`` SpMV and, for
    pipe_pr, the vector phase kernel (row 4, or row 5 with a
    preconditioner)."""
    hs = name.startswith("hs")
    if fmt == "symdia":
        one, two, vec = "sym_dia_spmv", "sym_dia_spmv2", None
    else:
        one, two = "dia_spmv_ext", "dia_spmv2_ext"
        vec = ("fused_pipe_vector_phase_prec" if name.endswith("pcg")
               else "fused_pipe_vector_phase")
    if hs:
        return {one: 2 + steps}
    return {one: 3, two: steps, **({vec: steps} if vec else {})}


def dist_steps(name, fmt, steps):
    """The launches of ``steps`` iterations alone (no init)."""
    total, init = dist_expected(name, fmt, steps), dist_expected(name, fmt, 0)
    return nonzero({k: v - init.get(k, 0) for k, v in total.items()})


def check_dia_ext(torch, card, timings, report):
    """``dia_spmv_ext`` / ``dia_spmv2_ext`` at the row partition's shape
    (63 diagonals of n = 655,360 rows, vectors of n + 2h) against their
    plain versions in float32 and float64, timed in float32 with the plain
    versions and cuSPARSE (the (n, n + 2h) CSR of the shard) beside them,
    into ``timings["dia_spmv_ext" + DIST]`` and ``"dia_spmv2_ext" +
    DIST``.  Returns the failed checks."""
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp

    rate = memory_rate(card)
    offs, n = DIA_MAIN_OFFSETS, N
    h = max(abs(o) for o in offs)
    failed = []
    for dn in ("float32", "float64"):
        dtype = getattr(torch, dn)
        rng = np.random.default_rng(n + h)
        shard = torch.as_tensor(rng.uniform(-1.0, 1.0, (len(offs), n)),
                                dtype=dtype, device="cuda")
        vx, wx = (torch.as_tensor(rng.standard_normal(n + 2 * h), dtype=dtype,
                                  device="cuda") for _ in range(2))
        y = sp.dia_spmv_ext(offs, shard, vx)
        y2, z2 = sp.dia_spmv2_ext(offs, shard, vx, wx)
        torch.cuda.synchronize()
        errs, abs_err = [], 0.0
        for got, x in ((y, vx), (y2, vx), (z2, wx)):
            want = sp._dia_mv_ext_plain(offs, shard, x)
            scale = sp._dia_mv_ext_plain(offs, shard.abs(), x.abs())
            errs.append(cw_err(torch, got, want, scale))
            abs_err = max(abs_err, float((got - want).abs().max()))
        rec = dict(kernel="dia_spmv_ext", dtype=dn, n=n, k=K_BAND,
                   max_err=max(errs), max_abs_err=abs_err, tol=TOL[dn])
        if dn == "float32":
            i = torch.arange(n, device="cuda")
            rows = torch.cat([i] * len(offs))
            cols = torch.cat([i + h + o for o in offs])
            csr = torch.sparse_coo_tensor(
                torch.stack([rows, cols]), shard.reshape(-1),
                (n, n + 2 * h)).coalesce().to_sparse_csr()
            vw = torch.stack([vx, wx], dim=1)
            nd, isz = len(offs), shard.element_size()
            b1 = bound(nd * n * isz + (2 * n + 2 * h) * isz, 2 * nd * n, dn,
                       rate)
            b2 = bound(nd * n * isz + 2 * (2 * n + 2 * h) * isz, 4 * nd * n,
                       dn, rate)
            rec.update(library_err=cw_err(
                torch, csr @ vx, sp._dia_mv_ext_plain(offs, shard, vx),
                sp._dia_mv_ext_plain(offs, shard.abs(), vx.abs())))
            for entry, fn, plain, lib, (b_ms, b_by) in (
                    ("dia_spmv_ext", lambda: sp.dia_spmv_ext(offs, shard, vx),
                     lambda: sp._dia_mv_ext_plain(offs, shard, vx),
                     lambda: csr @ vx, b1),
                    ("dia_spmv2_ext",
                     lambda: sp.dia_spmv2_ext(offs, shard, vx, wx),
                     lambda: (sp._dia_mv_ext_plain(offs, shard, vx),
                              sp._dia_mv_ext_plain(offs, shard, wx)),
                     lambda: csr @ vw, b2)):
                timings[entry + DIST] = dict(
                    rec, kernel=entry, ms=time_ms(torch, fn, 50),
                    plain_ms=time_ms(torch, plain, 5),
                    library_ms=time_ms(torch, lib, 50), bound_ms=b_ms,
                    bound_by=b_by)
            rec.update({key: timings["dia_spmv_ext" + DIST][key]
                        for key in ("ms", "plain_ms", "library_ms",
                                    "bound_ms")},
                       spmv2_ms=timings["dia_spmv2_ext" + DIST]["ms"])
            del csr, vw
        report(rec)
        if not max(errs) <= TOL[dn]:
            failed.append(rec)
        del shard, vx, wx
        torch.cuda.empty_cache()
    return failed


def check_dist(torch, card, timings):
    """The kernels of the row partition at the shapes it gives them, each
    against its plain version: the half-band SpMV (1 and 2 RHS) on the
    extended slice of m + 2h = 655,422 rows, the DIA ``_ext`` entries
    (check_dia_ext), row 9's ``_ext`` entries (check_df_ext), row 12 on
    the ELL context's shards (check_ell_shards); the vector phases (rows 4
    and 5) run on m = 655,360 rows, check_dia's shape, whose records they
    take.  Raises after all ran."""
    shape = (DIST_EXT_N, K_BAND)
    failed = check_spmv(torch, card, timings, shapes=(shape,),
                        timed=(shape, "float32"), suffix=DIST)
    failed += check_dia_ext(torch, card, timings, emit_check)
    failed += check_df_ext(torch, card, timings, emit_check)
    failed += check_ell_shards(torch, card, timings, emit_check)
    for entry in VECTOR_PHASES:
        timings[entry + DIST] = timings[entry]
    if failed:
        raise AssertionError(f"{len(failed)} row-partition checks disagree: "
                             f"{failed}")


def dist_problem(torch, name, fmt, n, dtype):
    """``(operator, b)`` of a row-partition run: the model problem for the
    unpreconditioned names, the scaled band for pipe_pr_pcg (Jacobi solves
    the model problem to its rounding floor within a few iterations), in
    ``fmt`` and ``dtype`` on the CPU."""
    from new_cg_variants_tpu_torch import DiaOperator, banded_model

    if not name.endswith("pcg"):
        op, b, _ = banded_model(n, k=K_BAND, fmt=fmt, device="cpu")
    else:
        op, b = scaled_band(torch, n, K_BAND)
        if fmt == "dia":
            offsets, data = op.todia_host()
            op = DiaOperator(offsets, torch.from_numpy(data))
    return op.astype(dtype), b


def collective_host_us(torch, mesh, v, calls=1000):
    """Host microseconds a call of each collective of the row context
    takes on ``mesh``, ``calls`` back to back then one synchronize: the
    all-reduce of four partials started and waited for, and the halo
    exchange of two vectors like ``v`` (at world size 1: the extended
    tensor's zeros and copies, no message)."""
    from new_cg_variants_tpu_torch.parallel import contexts

    group, parts = mesh.get_group(), torch.ones(4, dtype=v.dtype,
                                                device=v.device)
    cases = {"all_reduce": lambda: contexts.all_reduce(
                 parts, group, async_op=True).wait(),
             "halo_exchange": lambda: contexts.halo_exchange(
                 (v, v), K_BAND - 1, group)}
    out = {}
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def dist_f32(torch, mesh, timings):
    """The row partition on the card at world size 1 (NCCL), n = 655,360,
    k = 32, float32, half-band and full DIA: for pipe_pr_cg, hs_cg and
    pipe_pr_pcg (Jacobi), dist_case: the captured ``dist_run`` and
    ``dist_solve`` beside their eager witnesses (the same bits, launches
    and collectives), nu and alpha against the single-device ``run`` to
    DIST_RTOL through iteration 15, the launches of the run and of the
    solve, the all-reduces and halo exchanges and the kernels per
    iteration, eager and replayed, with the profiler's busy share, and
    ms/iter of ``dist_solve`` beside ``solve`` (norm none, 300
    iterations).  Then pipe_pr_cg on half-band under the bench protocol
    (DIST_CHUNK_ITERS-iteration chunks): the single-device context and
    this rank's row context replayed, in turns, and the row context
    eagerly.  Returns the launches by wrapper."""
    from new_cg_variants_tpu_torch.parallel.dist import _local_ctx_factory
    from new_cg_variants_tpu_torch.solvers.api import resolve
    from new_cg_variants_tpu_torch.solvers.context import Context

    path, failed = {}, []
    for fmt in ("symdia", "dia"):
        for name in DIST_NAMES:
            op, b = dist_problem(torch, name, fmt, N, torch.float32)
            op = op.to("cuda")
            b = torch.as_tensor(b, dtype=torch.float32, device="cuda")
            family = name.rsplit("_", 1)[0]
            _, counts, bad = dist_case(
                torch, "dist_f32", mesh, name, op, b,
                fields=dict(storage=fmt, n=N, k=K_BAND, problem=(
                    "scaled_band" if name.endswith("pcg")
                    else "banded_model")),
                want_run=dist_expected(name, fmt, DIST_ROWS - 1),
                want_step=dist_steps(name, fmt, 1),
                want_coll={"all_reduce": DIST_SYNCS[family],
                           "halo_exchange": 1},
                want_solve=dist_expected(name, fmt, DIST_SOLVE_ITERS))
            add_counts(path, counts)
            failed += bad
            del op, b
            torch.cuda.empty_cache()
    # the main path's name under the bench protocol (1000-iteration
    # chunks): the single-device context and this rank's row context
    # replayed, in turns, and the row context eagerly
    op, b = dist_problem(torch, "pipe_pr_cg", "symdia", N, torch.float32)
    op = op.to("cuda")
    b = torch.as_tensor(b, dtype=torch.float32, device="cuda")
    init_fn, step_fn = resolve("pipe_pr_cg", op, None)[3:5]
    bench = {}
    for label in ("single", "dist", "dist eager", "dist again",
                  "single again"):
        ctx = (Context(op) if label.startswith("single")
               else _local_ctx_factory(op, mesh, None))
        reset_counts()
        if label == "dist eager":
            ms, trials, nu_final, _ = chained_ms(torch, ctx, init_fn,
                                                 step_fn, b, DIST_CHUNK_ITERS)
        else:
            ms, trials, nu_final, _, _ = replay_protocol(
                torch, ctx, init_fn, step_fn, b, torch.zeros_like(b),
                DIST_CHUNK_ITERS, MAX_TRIALS)
        torch.cuda.synchronize()
        if label.startswith("dist"):
            add_counts(path, nonzero(read_counts()))
            add_counts(MESH_GRAPHS.setdefault("dist_f32", {}),
                       nonzero(GRAPH["replayed"]))
        bench[label] = dict(ms_per_iter=ms, trial_seconds=trials,
                            nu_final=nu_final)
    timings["dist_f32"] = bench
    emit("dist_f32", variant="pipe_pr_cg", storage="symdia", n=N, k=K_BAND,
         bench_protocol=bench,
         collective_host_us=collective_host_us(torch, mesh, b))
    if not all(np.isfinite(v["nu_final"]) and v["nu_final"] > 0
               for v in bench.values()):
        failed.append(bench)
    failed += dist_hook(torch, mesh, op, b)
    if failed:
        raise AssertionError(f"{len(failed)} row-partition runs failed: "
                             f"{failed}")
    return path


def dist_hook(torch, mesh, op, b):
    """gv's replacement hook in the captured mesh loop (as jit_hook holds
    it for ``run``): ``k % 10 == 0`` answers a bool tensor for the device
    ``k`` of ``dist_run`` on the card and a Python bool for the eager
    witness's host ``k``: the same bits; a hook answering a Python bool on
    the card raises ``TypeError``.  Returns the failed records."""
    from new_cg_variants_tpu_torch.parallel import dist_run
    from new_cg_variants_tpu_torch.parallel.dist import _dist_history, _setup
    from new_cg_variants_tpu_torch.probes.probes import resolve_probes

    def hook(k, view):
        return k % 10 == 0

    probes = ("nu", "alpha")
    kw = dict(max_iter=JIT_NAME_ITERS + 1, probes=probes, device="cuda")
    got = counted_call(torch, lambda: dist_run(
        "gv_cg", op, b, mesh=mesh, w_replace=hook, **kw))
    local = _setup("gv_cg", op, b, None, mesh, "auto", None, None, False,
                   True, "cuda", w_replace=hook)[1]
    eager = _dist_history("gv_cg", local, resolve_probes(probes),
                          kw["max_iter"], None, None)
    same = same_output(got["out"], eager, ("x",) + probes)
    try:
        dist_run("gv_cg", op, b, mesh=mesh, w_replace=lambda k, v: True,
                 **kw)
        refused = None
    except TypeError as e:
        refused = str(e)
    rec = dict(variant="gv_cg", hook="k % 10 == 0", same_bits=same,
               graph_launches=got["graph_launches"],
               python_bool_refused=refused)
    emit("dist_f32", **rec)
    ok = (all(same.values()) and bool(got["graph_launches"])
          and refused is not None and "dist_run" in refused)
    return [] if ok else [rec]


def dist_f64(torch, mesh):
    """The row partition in float64 at n = 65,536: ``dist_run`` on the card
    (NCCL, captured) against its eager witness on the card (the same bits
    of x, nu and alpha) and against ``dist_run`` on the CPU (gloo, the same
    process group's CPU backend), nu and alpha to F64_RTOL over 25
    iterations, for pipe_pr_cg, hs_cg and pipe_pr_pcg (Jacobi) on
    half-band and full DIA, with the card's launches."""
    from new_cg_variants_tpu_torch.parallel import dist_run, make_mesh
    from new_cg_variants_tpu_torch.parallel.dist import _dist_history, _setup
    from new_cg_variants_tpu_torch.probes.probes import resolve_probes

    cpu_mesh = make_mesh(device="cpu")
    failed = []
    for fmt in ("symdia", "dia"):
        for name in DIST_NAMES:
            op, b = dist_problem(torch, name, fmt, DIST_F64_N, torch.float64)
            pre = "jacobi" if name.endswith("pcg") else None
            kw = dict(max_iter=F64_ITERS + 1, probes=("nu", "alpha"),
                      preconditioner=pre)
            c = counted_call(torch, lambda: dist_run(
                name, op, b, mesh=mesh, device="cuda", **kw))
            gpu, counts = c["out"], c["launches"]
            local = _setup(name, op, b, None, mesh, "auto", pre, None, False,
                           True, "cuda")[1]
            eager = _dist_history(name, local, resolve_probes(kw["probes"]),
                                  kw["max_iter"], None, None)
            same = same_output(gpu, eager, ("x", "nu", "alpha"))
            cpu = dist_run(name, op, b, mesh=cpu_mesh, device="cpu", **kw)
            errs = {p: float(np.max(np.abs(gpu[p] - cpu[p]) / np.abs(cpu[p])))
                    for p in ("nu", "alpha")}
            expected = dist_expected(name, fmt, F64_ITERS)
            rec = dict(variant=name, storage=fmt, n=DIST_F64_N,
                       iterations=F64_ITERS, max_rel_diff=errs,
                       rtol=F64_RTOL, same_bits_as_eager=same,
                       launches=counts, graph_launches=c["graph_launches"],
                       expected_launches=expected)
            emit("dist_f64", **rec)
            if not (max(errs.values()) <= F64_RTOL and counts == expected
                    and all(same.values()) and c["graph_launches"]):
                failed.append(rec)
    if failed:
        raise AssertionError(f"{len(failed)} f64 row-partition comparisons "
                             f"failed: {failed}")


# ---------------------------------------------------------------------------
# The rest of the distributed layer at world size 1: the ELL (row 12 on a
# shard's cache), double-word (row 9's _ext entries), block-banded, stencil
# and column contexts; the harness and the command line on a mesh
# ---------------------------------------------------------------------------

#: (p, rank) of the shards row 12 is checked on: the first and the last of
#: two, the first and an interior one of four (HPCG 104^3, natural order)
ELL_SHARDS = ((2, 0), (2, 1), (4, 0), (4, 1))
#: suffix of a shard's record
SHARD = " (shard p={} rank {})"
#: suffix of the timings of an all-gather shard of the permuted operator
AG_SHARD = " (all-gather shard p={} rank {})"
#: row 9's shard shapes: the row partition's rows (m = 655,360, 63
#: diagonals, h = 31) and the dense path's n
DF_EXT_MS = (N, DF_DENSE_N)
DIST_DF_ITERS = 100
#: the chunk of the double-word context's replays under the bench protocol
#: (one graph chunk: the step takes ~3.9 ms replayed)
DIST_DF_REPLAY_ITERS = 32
DIST_DF_NAMES = ("pipe_pr_cg", "hs_cg")
#: f32x2 on the mesh against f32x2 on one device, every row.  At world size
#: 1 the mesh context's arithmetic is the single-device mode's with the
#: generic double-word vector phase, so pipe-PR-CG is held to that run; the
#: default single-device run (row 11, whose dots sum in its tiles' order)
#: is the witness (df_witness)
DIST_DF_RTOL = 1e-5
#: rows of the witness printed in double words
DF_WITNESS_ROWS = 41
#: the two dot orders' histories agree to the double-word rounding class
#: through DF_EPS2_ROWS rows; later the model problem amplifies any
#: difference many times a row (the witness prints how)
DF_EPS2_ROWS = 20
DF_EPS2_TOL = 1e-12
COL_N = 8192
#: collectives per iteration of each family in the column context, packed
#: (tests/test_comm_structure.py:39-50)
COL_PACKED = {"hs": 3, "cg": 2, "gv": 1, "pr": 2, "m": 2, "pipe_p": 1,
              "pipe_pr": 1, "pipe_p_m": 1, "pipe_pr_m": 1}
SCALING_ITERS = 1000
SCALING_CHUNK = 500
#: the keys of the JAX package's ScalingResult.to_dict
SCALING_KEYS = {"variant", "n", "max_iter", "n_devices", "times", "best",
                "time_per_iter", "error"}


#: the collectives a captured graph makes, as GRAPH holds its launches: the
#: wrappers' calls at a capture, and the same calls once for each replay of
#: that graph (install_graph_counts); cleared by reset_collectives
GRAPH_COLL = {"captured": {}, "replayed": {}}


def raw_collectives():
    from new_cg_variants_tpu_torch.parallel import contexts

    return {fn.__name__: fn.calls for fn in contexts.COLLECTIVES}


def reset_collectives():
    from new_cg_variants_tpu_torch.parallel import contexts

    for fn in contexts.COLLECTIVES:
        fn.calls = 0
    for tally in GRAPH_COLL.values():
        tally.clear()


def collective_counts():
    """Collective calls since reset_collectives: the eager ones, and each
    call of a captured graph once for every replay of that graph (a
    wrapper counts a host call, so a capture's calls count once, when it
    is captured)."""
    return nonzero({name: n - GRAPH_COLL["captured"].get(name, 0)
                    + GRAPH_COLL["replayed"].get(name, 0)
                    for name, n in raw_collectives().items()})


def check_df_ext(torch, card, timings, report):
    """Row 9's shard entries (``df_dia_spmv_ext`` / ``df_dia_spmv2_ext``) at
    63 diagonals on m = 655,360 rows and on 4096, the words halo-extended to
    m + 2h, against their plain version: every word equal.  Timed at the
    first with its bound (bytes and non-FMA operations), the plain version
    and float64 ``dia_spmv_ext`` beside, into ``timings``."""
    from new_cg_variants_tpu_torch import df_split3
    from new_cg_variants_tpu_torch.ops import df_spmv as ds
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp

    rate = memory_rate(card)
    offs = DIA_MAIN_OFFSETS
    nd, h = len(offs), max(abs(o) for o in offs)
    failed = []
    for m in DF_EXT_MS:
        rng = np.random.default_rng(m + nd)
        data = rng.uniform(-1.0, 1.0, (nd, m))  # a shard: no matrix edge
        band = df_split3(data, device="cuda")
        v, w = df_vec(torch, rng, m + 2 * h), df_vec(torch, rng, m + 2 * h)
        got1 = ds.df_dia_spmv_ext(offs, *band, v)
        got2 = ds.df_dia_spmv2_ext(offs, *band, v, w)
        torch.cuda.synchronize()
        want = [ds._df_dia_mv_ext_plain(offs, *band, *x) for x in (v, w)]
        err, same = bitwise_err([got1, *got2], [want[0], *want])
        rec = dict(kernel="df_dia_spmv_ext", n=m, k=K_BAND, ndiag=nd, halo=h,
                   max_abs_err=err, bitwise=same, tol=0.0)
        if m == N:
            data64 = torch.from_numpy(data).cuda()
            v64, w64 = (torch.randn(m + 2 * h, dtype=torch.float64,
                                    device="cuda") for _ in range(2))
            ext = m + 2 * h
            common = dict(n=m, k=K_BAND, max_abs_err=err, library_ms=None,
                          f64_counterpart="dia_spmv_ext / dia_spmv2_ext on "
                          "the float64 shard (not the same function)")
            for entry, fn, plain, f64, nrhs in (
                    ("df_dia_spmv_ext",
                     lambda: ds.df_dia_spmv_ext(offs, *band, v),
                     lambda: ds._df_dia_mv_ext_plain(offs, *band, *v),
                     lambda: sp.dia_spmv_ext(offs, data64, v64), 1),
                    ("df_dia_spmv2_ext",
                     lambda: ds.df_dia_spmv2_ext(offs, *band, v, w),
                     lambda: [ds._df_dia_mv_ext_plain(offs, *band, *x)
                              for x in (v, w)],
                     lambda: sp.dia_spmv2_ext(offs, data64, v64, w64), 2)):
                timings[entry + DIST] = dict(
                    common, ms=time_ms(torch, fn, 20),
                    plain_ms=time_ms(torch, plain, 3),
                    f64_counterpart_ms=time_ms(torch, f64, 20),
                    **df_bound((3 * nd * m + 2 * nrhs * (ext + m)) * 4,
                               DF_OPS["dia"] * nd * nrhs * m, rate))
            t1, t2 = (timings[e + DIST] for e in ("df_dia_spmv_ext",
                                                  "df_dia_spmv2_ext"))
            rec.update(ms=t1["ms"], spmv2_ms=t2["ms"], plain_ms=t1["plain_ms"],
                       plain2_ms=t2["plain_ms"],
                       f64_ms=t1["f64_counterpart_ms"],
                       f64_2_ms=t2["f64_counterpart_ms"],
                       **{key: t2[key] for key in (
                           "bound_ms", "bound_by", "bound_bytes_ms",
                           "bound_ops_ms")},
                       spmv_bound_ms=t1["bound_ms"],
                       row9_ms=timings.get("df_dia_spmv", {}).get("ms"),
                       row9_spmv2_ms=timings.get("df_dia_spmv2", {}).get(
                           "ms"))
            del data64, v64, w64
        report(rec)
        if not same:
            failed.append(rec)
        del band, v, w, got1, got2, want
        torch.cuda.empty_cache()
    return failed


@functools.lru_cache(maxsize=2)
def ell_pattern(perm_seed):
    """HPCG's ELL arrays (numpy ``(n, L)`` values and int32 indices, the
    given order) of ``stencil27(HPCG_GRID, perm_seed)``."""
    from new_cg_variants_tpu_torch.ops.operators import build_ell, coo_from_scipy

    a, _ = hpcg_case(perm_seed)
    val, idx, _ = build_ell(coo_from_scipy(a))
    return val, idx


@functools.lru_cache(maxsize=2)
def ell_plan(p):
    """The exchange plan of HPCG's natural order at ``p`` ranks."""
    from new_cg_variants_tpu_torch.parallel.ell_exchange import (
        plan_ell_exchange,
    )

    _, idx = ell_pattern(None)
    return plan_ell_exchange(idx, idx.shape[0], p)


def device_csr(torch, val_t, idx_t, c):
    """The ``(m, c)`` matrix of slot-major ``(L, m)`` ELL arrays on the
    card as a CUDA CSR tensor (the library's yardstick), built there."""
    L, m = val_t.shape
    real = val_t != 0.0
    rows = torch.arange(m, device=val_t.device).expand(L, m)[real]
    coo = torch.sparse_coo_tensor(
        torch.stack([rows, idx_t[real].long()]), val_t[real], (m, c))
    return coo.coalesce().to_sparse_csr()


def check_ell_shard(torch, label, vals, lidx, c, rate, timings, sfx, report):
    """Row 12's shard entries on one shard (``vals`` / ``lidx``: its ``(m,
    L)`` rows, indices into a cache of length ``c``) against their plain
    versions in float32 and float64, in units of each value's scale, and
    the witness's bits; timed in float32 into ``timings[entry + sfx]``."""
    from new_cg_variants_tpu_torch.ops import ell_spmv as es

    m, L = vals.shape
    failed = []
    li = torch.from_numpy(np.ascontiguousarray(lidx.T)).cuda().T
    es.check_index(li, c)
    for dn in ("float32", "float64"):
        dtype = getattr(torch, dn)
        val = torch.from_numpy(np.ascontiguousarray(vals.T)).to(
            device="cuda", dtype=dtype).T
        rng = np.random.default_rng(c)
        cv, cw = (torch.as_tensor(rng.standard_normal(c), dtype=dtype,
                                  device="cuda") for _ in range(2))
        y = es.ell_spmv_cache(val, li, cv)
        y2, z2 = es.ell_spmv2_cache(val, li, cv, cw)
        witness = witness_same(torch, lambda: (
            es.ell_spmv_cache(val, li, cv),
            *es.ell_spmv2_cache(val, li, cv, cw)), (y, y2, z2))
        yp, zp = (es._ell_mv_plain(val, li, x) for x in (cv, cw))
        ys, zs = (es._ell_mv_plain(val.abs(), li, x.abs()) for x in (cv, cw))
        torch.cuda.synchronize()
        got = [(y, yp, ys), (y2, yp, ys), (z2, zp, zs)]
        errs = [cw_err(torch, g, want, sc) for g, want, sc in got]
        abs_err = max(float((g - want).abs().max()) for g, want, _ in got)
        rec = dict(kernel="ell_spmv_cache", shape=label, dtype=dn, m=m, L=L,
                   cache=c, max_err=max(errs), max_abs_err=abs_err,
                   tol=TOL[dn])
        if witness is not None:
            rec["same_bits_as_witness"] = witness
        if dn == "float32" and timings is not None:
            isz = val.element_size()
            csr = device_csr(torch, val.T, li.T, c)
            cvw = torch.stack([cv, cw], dim=1)
            common = dict(n=m, L=L, cache=c, max_abs_err=abs_err,
                          library="cuSPARSE CSR of the (m, c) shard "
                          "through torch (csr @ cache, csr @ [cv cw])")
            for entry, fn, plain, lib, nrhs in (
                    ("ell_spmv_cache", lambda: es.ell_spmv_cache(val, li, cv),
                     lambda: es._ell_mv_plain(val, li, cv), lambda: csr @ cv,
                     1),
                    ("ell_spmv2_cache",
                     lambda: es.ell_spmv2_cache(val, li, cv, cw),
                     lambda: es._ell_mv2_plain(val, li, cv, cw),
                     lambda: csr @ cvw, 2)):
                b_ms, b_by = bound(m * L * (isz + 4) + nrhs * (c + m) * isz,
                                   2 * nrhs * m * L, dn, rate)
                timings[entry + sfx] = dict(
                    common, ms=time_ms(torch, fn, 50),
                    plain_ms=time_ms(torch, plain, 5),
                    library_ms=time_ms(torch, lib, 50), bound_ms=b_ms,
                    bound_by=b_by)
            t1, t2 = (timings[e + sfx] for e in ("ell_spmv_cache",
                                                 "ell_spmv2_cache"))
            rec.update(ms=t1["ms"], spmv2_ms=t2["ms"], plain_ms=t1["plain_ms"],
                       library_ms=t1["library_ms"],
                       library2_ms=t2["library_ms"], bound_ms=t1["bound_ms"],
                       spmv2_bound_ms=t2["bound_ms"],
                       library_err=cw_err(torch, csr @ cv, yp, ys))
            del csr, cvw
        report(rec)
        if not (max(errs) <= TOL[dn] and witness is not False):
            failed.append(rec)
        del val, cv, cw
        torch.cuda.empty_cache()
    return failed


def check_ell_ag_shard(torch, op, p, r, rate, timings, sfx, report):
    """Row 12's shard entries on rank ``r`` of ``p``'s all-gather shard of
    ``op`` (HPCG 104^3 permuted, an ``EllOperator`` in its RCM order,
    float64 on the card): the rank's rows in the given numbering (the
    witness) and in the locality order the row context takes
    (``dist._ell_locality_shard``: rows and touched columns in RCM order,
    one gather in), the cache the whole vector.  In float32, float64 and
    bf16 storage: the locality order's products the given order's bits,
    and the witness build's; both against the plain version.  Timed in
    float32 into ``timings[entry + sfx]`` (the locality order with its
    gather in; at one rank, dist_ell_f32's shape, the product of ``B`` with
    no order on the gathered cache that ``dist_run`` in the operator's basis
    runs, the locality order's beside it; the given order beside both; at
    one rank also the gather in, ``ell_gather`` + sfx)."""
    from new_cg_variants_tpu_torch.ops import ell_spmv as es
    from new_cg_variants_tpu_torch.parallel.dist import _ell_locality_shard

    n = op.n
    m = n // p
    gval_t, gidx_t = (t[:, r * m:(r + 1) * m].contiguous()
                      for t in op._given())
    lval_t, lidx_t, q, cols = _ell_locality_shard(op, r, m, "cuda")
    k = cols.shape[0]
    es.check_index(lidx_t, k)
    L = gval_t.shape[0]
    label = f"27-point {HPCG_GRID}^3 permuted, all-gather, p = {p}, rank {r}"
    failed = []
    for dn in ("float32", "float64", "bfloat16"):
        dtype = getattr(torch, dn)
        gval, lval = gval_t.to(dtype).T, lval_t.to(dtype).T
        gidx, lidx = gidx_t.T, lidx_t.T
        rng = np.random.default_rng(p + r)
        cv, cw = (torch.as_tensor(rng.standard_normal(n),
                                  dtype=vector_dtype(torch, dtype),
                                  device="cuda") for _ in range(2))

        def local():
            return (es.ell_spmv_cache(lval, lidx, cv, q, cols),
                    *es.ell_spmv2_cache(lval, lidx, cv, cw, q, cols))

        ly, ly2, lz2 = local()
        y = es.ell_spmv_cache(gval, gidx, cv)
        y2, z2 = es.ell_spmv2_cache(gval, gidx, cv, cw)
        same = same_bits(torch, (ly, ly2, lz2), (y, y2, z2))
        witness = witness_same(torch, local, (ly, ly2, lz2))
        yp, zp = (es._ell_mv_plain(gval, gidx, x) for x in (cv, cw))
        ys, zs = (es._ell_mv_plain(gval.abs(), gidx, x.abs())
                  for x in (cv, cw))
        torch.cuda.synchronize()
        got = [(ly, yp, ys), (ly2, yp, ys), (lz2, zp, zs), (y, yp, ys),
               (y2, yp, ys), (z2, zp, zs)]
        errs = [cw_err(torch, g, want, sc) for g, want, sc in got]
        abs_err = max(float((g - want).abs().max()) for g, want, _ in got)
        rec = dict(kernel="ell_spmv_cache", shape=label, dtype=dn, m=m, L=L,
                   cache=n, columns=k, orders=["given", "locality"],
                   same_bits_as_given=same, max_err=max(errs),
                   max_abs_err=abs_err, tol=TOL[dn])
        ok = same
        if witness is not None:
            rec["same_bits_as_witness"] = witness
            ok = ok and witness
        if dn == "float32" and timings is not None:
            csr = device_csr(torch, gval_t.to(dtype), gidx_t, n)
            cvw = torch.stack([cv, cw], dim=1)
            common = dict(n=m, L=L, cache=n, columns=k, max_abs_err=abs_err,
                          library="cuSPARSE CSR of the (m, n) shard "
                          "through torch (csr @ cache, csr @ [cv cw])")
            # one rank: dist_run solves in the operator's basis, so the
            # path's product is B's storage (the shard's own at one rank)
            # with no order on the gathered vector; at more ranks no path
            # runs these shapes
            basis = {}
            if p == 1:
                bcv, bcw = cv[cols.long()], cw[cols.long()]
                bcsr = device_csr(torch, lval_t.to(dtype), lidx_t, k)
                bvw = torch.stack([bcv, bcw], dim=1)
                for entry, fn, plain, lib in (
                        ("ell_spmv_cache",
                         lambda: es.ell_spmv_cache(lval, lidx, bcv),
                         lambda: es._ell_mv_plain(lval, lidx, bcv),
                         lambda: bcsr @ bcv),
                        ("ell_spmv2_cache",
                         lambda: es.ell_spmv2_cache(lval, lidx, bcv, bcw),
                         lambda: es._ell_mv2_plain(lval, lidx, bcv, bcw),
                         lambda: bcsr @ bvw)):
                    basis[entry] = dict(
                        ms=time_ms(torch, fn, 50),
                        plain_ms=time_ms(torch, plain, 5),
                        library_ms=time_ms(torch, lib, 50),
                        library="cuSPARSE CSR of B through torch (csr @ "
                        "cache[perm], csr @ [cv cw][perm])")
                del bcv, bcw, bcsr, bvw
            for entry, fn, given_fn, plain, lib, nrhs in (
                    ("ell_spmv_cache",
                     lambda: es.ell_spmv_cache(lval, lidx, cv, q, cols),
                     lambda: es.ell_spmv_cache(gval, gidx, cv),
                     lambda: es._ell_reordered_plain(lval, lidx, q, [cv],
                                                     cols),
                     lambda: csr @ cv, 1),
                    ("ell_spmv2_cache",
                     lambda: es.ell_spmv2_cache(lval, lidx, cv, cw, q, cols),
                     lambda: es.ell_spmv2_cache(gval, gidx, cv, cw),
                     lambda: es._ell_reordered_plain(lval, lidx, q, [cv, cw],
                                                     cols),
                     lambda: csr @ cvw, 2)):
                # the touched columns read once: the least either order
                # could read
                b_ms, b_by = bound(m * L * 8 + nrhs * (k + m) * 4,
                                   2 * nrhs * m * L, dn, rate)
                timings[entry + sfx] = dict(
                    common, ms=time_ms(torch, fn, 50),
                    given_order=dict(ms=time_ms(torch, given_fn, 50)),
                    plain_ms=time_ms(torch, plain, 5),
                    library_ms=time_ms(torch, lib, 50), bound_ms=b_ms,
                    bound_by=b_by)
                if basis:
                    t = timings[entry + sfx]
                    t["locality_order"] = {key: t[key] for key in (
                        "ms", "plain_ms", "library_ms")}
                    t.update(basis[entry])
            t1, t2 = (timings[e + sfx] for e in ("ell_spmv_cache",
                                                 "ell_spmv2_cache"))
            rec.update(ms=t1["ms"], spmv2_ms=t2["ms"],
                       given_order_ms=t1["given_order"]["ms"],
                       given_order_spmv2_ms=t2["given_order"]["ms"],
                       plain_ms=t1["plain_ms"], library_ms=t1["library_ms"],
                       library2_ms=t2["library_ms"], bound_ms=t1["bound_ms"],
                       spmv2_bound_ms=t2["bound_ms"])
            if p == 1:
                g_ms, g_by = bound(k * (4 + 2 * 4), 0, dn, rate)
                timings["ell_gather" + sfx] = dict(
                    n=k, max_abs_err=float((es.ell_gather(cols, [cv])
                                            - cv[cols.long()]).abs().max()),
                    ms=time_ms(torch, lambda: es.ell_gather(cols, [cv]), 50),
                    ms_2rhs=time_ms(torch,
                                    lambda: es.ell_gather(cols, [cv, cw]), 50),
                    plain_ms=time_ms(
                        torch, lambda: es._ell_gather_plain(cols, [cv]), 50),
                    library_ms=time_ms(
                        torch, lambda: torch.index_select(cv, 0, cols), 50),
                    library="torch.index_select(v, 0, cols)", bound_ms=g_ms,
                    bound_by=g_by)
            del csr, cvw
        report(rec)
        if not (ok and max(errs) <= TOL[dn]):
            failed.append(rec)
        del gval, lval, cv, cw
        torch.cuda.empty_cache()
    return failed


def check_ell_shards(torch, card, timings, report):
    """Row 12 on the shards of the ELL row context: HPCG 104^3 in natural
    order planned by ``plan_ell_exchange`` at 2 and 4 ranks, the first and
    another rank's ``(m, L)`` rows and ``m + recv``-long caches
    (ELL_SHARDS); and HPCG 104^3 permuted, whose shards take the
    all-gather, at one rank (dist_ell_f32's shape, into ``timings[entry +
    DIST]``) and at 2 and 4 (ELL_SHARDS again), each in the given
    numbering and in the locality order (check_ell_ag_shard)."""
    from new_cg_variants_tpu_torch.ops.operators import EllOperator

    rate = memory_rate(card)
    failed = []
    val, idx = ell_pattern(None)
    n = idx.shape[0]
    for p, r in ELL_SHARDS:
        plan, m = ell_plan(p), n // p
        rows = slice(r * m, (r + 1) * m)
        vals = np.random.default_rng(p + r).uniform(-1.0, 1.0, val[rows].shape)
        vals[val[rows] == 0.0] = 0.0  # padding stays 0
        failed += check_ell_shard(
            torch, f"27-point {HPCG_GRID}^3, p = {p}, rank {r}", vals,
            plan.idx_remap[rows], m + plan.recv_total, rate, timings,
            SHARD.format(p, r), report)
    val, idx = ell_pattern(PERM_SEED)
    vals = np.random.default_rng(1).uniform(-1.0, 1.0, val.shape)
    vals[val == 0.0] = 0.0
    _, perm = hpcg_case(PERM_SEED)
    op = EllOperator(torch.from_numpy(vals).cuda(),
                     torch.from_numpy(idx).cuda(), perm=perm)
    for p, r in ((1, 0),) + ELL_SHARDS:
        failed += check_ell_ag_shard(
            torch, op, p, r, rate, timings,
            DIST if p == 1 else AG_SHARD.format(p, r), report)
    del op
    torch.cuda.empty_cache()
    return failed


#: launches inside the mesh paths' captured graphs, by phase (dist_case,
#: dist_f32's bench protocol, dist_scaling): the kernels line's
#: graph_launches of the row partition's records
MESH_GRAPHS = {}


def counted_call(torch, fn):
    """``fn()`` after a synchronize, with its counts reset first: a dict of
    its output (``out``), host seconds to a synchronize after it, launches
    and collective calls (a captured graph's once for every replay), the
    launches and collective calls inside graphs (``graph_launches``,
    ``graph_collectives``) and the captures' host seconds."""
    torch.cuda.synchronize()
    reset_counts()
    reset_collectives()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return dict(out=out, seconds=time.perf_counter() - t0,
                launches=nonzero(read_counts()),
                collectives=collective_counts(),
                graph_launches=nonzero(GRAPH["replayed"]),
                graph_collectives=nonzero(GRAPH_COLL["replayed"]),
                capture_seconds=dict(GRAPH["seconds"]))


def per_step(counts, steps=DIST_STEPS):
    return {k: v / steps for k, v in counts.items()}


def dist_case(torch, phase, mesh, name, op, b, single_op=None, kw=None,
              fields=None, want_run=None, want_step=None, want_coll=None,
              want_solve=None, rtol=DIST_RTOL, rows=DIST_ROWS,
              iters=DIST_SOLVE_ITERS, want=None, rounds=2,
              replay_iters=DIST_REPLAY_ITERS):
    """One name on a mesh context at world size 1 (``kw``: ``dist_run``'s
    ``partition``, ``col_packed``, ``dtype``; ``fields``: the record's
    labels), its loops captured as the entry points run them on the card,
    each beside its eager witness (``parallel/dist.py``'s private bodies
    with no runner):

    * ``dist_run`` of ``rows`` rows: x, nu and alpha the witness's bits,
      the same launches and collectives (``want_run``: its launches); nu
      and alpha within ``rtol`` of ``want`` (default the single-device
      ``run`` on ``single_op``, default ``op``);
    * DIST_STEPS steps eagerly, then replayed: the same kernels
      (``want_step``) and collectives (``want_coll``) per iteration; the
      profiler's busy share and CUDA events a step of each;
    * ``dist_solve`` (norm none, ``iters`` iterations) captured, eagerly
      and the single-device captured ``solve``, ``rounds`` times in turns:
      ms/iter (a call's capture included), the captures' host seconds, the
      same iterations, x the witness's bits, the same launches
      (``want_solve``) and collectives;
    * the replays alone under the bench protocol (``replay_iters``-
      iteration chunks), the mesh context and the single-device one in
      turns, and the replayed step's busy share of that ms/iter.

    The launches inside the graphs go to MESH_GRAPHS[phase].  Returns
    ``(record, launches on the path, failed)``."""
    from new_cg_variants_tpu_torch import run, solve
    from new_cg_variants_tpu_torch.parallel import dist_run, dist_solve
    from new_cg_variants_tpu_torch.parallel.dist import (
        _dist_history,
        _dist_tolerance,
        _setup,
    )
    from new_cg_variants_tpu_torch.probes.probes import resolve_probes
    from new_cg_variants_tpu_torch.solvers import graphs

    single_op = op if single_op is None else single_op
    kw = kw or {}
    pre = "jacobi" if name.endswith("pcg") else None
    dtype = kw.get("dtype")
    probes = ("nu", "alpha")
    rk = dict(probes=probes, preconditioner=pre, device="cuda")

    def local():
        return _setup(name, op, b, None, mesh, kw.get("partition", "auto"),
                      pre, dtype, False, kw.get("col_packed", True),
                      "cuda")[1]

    dist_run(name, op, b, mesh=mesh, max_iter=2, **rk, **kw)  # warm-up
    run_c = counted_call(torch, lambda: dist_run(
        name, op, b, mesh=mesh, max_iter=rows, **rk, **kw))
    run_e = counted_call(torch, lambda: _dist_history(
        name, local(), resolve_probes(probes), rows, None, None))
    got = run_c["out"]
    same = same_output(got, run_e["out"], ("x", "nu") + probes)
    path = dict(run_c["launches"])
    inside = dict(run_c["graph_launches"])
    if want is None:
        want = run(name, single_op, b, max_iter=rows, dtype=dtype, **rk)
    errs = {p: float(np.max(np.abs(got[p] - want[p]) / np.abs(want[p])))
            for p in probes}
    # DIST_STEPS steps eagerly, then DIST_STEPS replayed
    lc = local()
    ctx, step_fn = lc.ctx, lc.step_fn
    st = {"s": lc.init_fn(ctx, lc.b, lc.x0)}

    def advance(m):
        for _ in range(m):
            st["s"] = step_fn(ctx, st["s"])

    e_steps = counted_call(torch, lambda: advance(DIST_STEPS))
    profile = profile_window(torch, advance, DIST_STEPS - 1)
    loop = graphs.runner(torch.device("cuda"), True).start(
        ctx, step_fn, st["s"], horizon=DIST_STEPS)
    c_steps = counted_call(torch, lambda: loop.advance(DIST_STEPS))
    # a short window: the double-word context launches ~2,200 kernels a step
    c_profile = profile_window(torch, loop.advance, DIST_STEPS)
    c_profile.update(capture_seconds=loop.cap.capture_seconds,
                     instantiate_seconds=loop.cap.instantiate_seconds)
    for c in (e_steps, c_steps):
        add_counts(path, c["launches"])
    add_counts(inside, c_steps["graph_launches"])
    steps = {"eager": dict(kernels=per_step(e_steps["launches"]),
                           collectives=per_step(e_steps["collectives"])),
             "captured": dict(kernels=per_step(c_steps["launches"]),
                              collectives=per_step(c_steps["collectives"]))}
    del loop, st
    # dist_solve captured, eagerly and the single-device solve, in turns
    sk = dict(variant=name, norm_type="none", preconditioner=pre,
              device="cuda")
    solves = {
        "captured": lambda m: dist_solve(op, b, mesh=mesh, max_iter=m, **sk,
                                         **kw),
        "eager": lambda m: _dist_tolerance(local(), m, 1e-8, 0.0, "none",
                                           None),
        "single": lambda m: solve(single_op, b, dtype=dtype, max_iter=m,
                                  **sk)}
    for fn in solves.values():
        fn(5)  # warm-up
    res = {label: [] for label in solves}
    for _ in range(rounds):
        for label, fn in solves.items():
            res[label].append(counted_call(torch, lambda: fn(iters)))
    sc, se, ss = (res[k][-1] for k in ("captured", "eager", "single"))
    for c in res["captured"]:
        add_counts(path, c["launches"])
        add_counts(inside, c["graph_launches"])
    solve_same = dict(
        iterations=sc["out"].iterations == se["out"].iterations
        == ss["out"].iterations == iters,
        x=bits_equal(torch, sc["out"].x, se["out"].x),
        launches=sc["launches"] == se["launches"],
        collectives=sc["collectives"] == se["collectives"])
    ms = {label: [c["seconds"] / iters * 1e3 for c in r]
          for label, r in res.items()}
    # the replays alone, the mesh context and one device in turns
    pieces = {"dist": (ctx, lc.init_fn, step_fn, lc.b, lc.x0),
              "single": single_pieces(torch, single_op, b, name, pre,
                                      dtype)}
    replays = {}
    for label in ("dist", "single", "dist", "single"):
        t = replay_protocol(torch, *pieces[label], replay_iters,
                            MIN_TRIALS)
        replays.setdefault(label, []).append(t[0])
    busy = c_profile.get("device_busy_ms_per_iter")
    c_profile["busy_share_of_replay_ms_per_iter"] = (
        None if busy is None else busy / min(replays["dist"]))
    add_counts(MESH_GRAPHS.setdefault(phase, {}), inside)
    rec = dict(variant=name, **(fields or {}), rows=rows,
               max_rel_diff=errs, rtol=rtol, context=type(ctx).__name__,
               run_same_bits=same, launches=nonzero(path),
               run_launches=run_c["launches"],
               run_eager_launches=run_e["launches"],
               run_collectives=run_c["collectives"],
               run_eager_collectives=run_e["collectives"],
               run_capture_seconds=run_c["capture_seconds"],
               run_graph_collectives=run_c["graph_collectives"],
               graph_launches=inside,
               per_iteration=steps["eager"],
               per_iteration_captured=steps["captured"],
               profile=profile, profile_captured=c_profile,
               dist_solve_ms_per_iter=min(ms["captured"]),
               dist_solve_eager_ms_per_iter=min(ms["eager"]),
               solve_ms_per_iter=min(ms["single"]), solve_ms_turns=ms,
               solve_capture_seconds=sc["capture_seconds"],
               solve_same=solve_same, solve_launches=sc["launches"],
               solve_collectives=sc["collectives"],
               replay_ms_per_iter={k: min(v) for k, v in replays.items()},
               replay_ms_turns=replays, iterations=sc["out"].iterations,
               finite=bool(torch.isfinite(sc["out"].x).all()))
    ok = (max(errs.values()) <= rtol and rec["finite"]
          and all(same.values()) and all(solve_same.values())
          and run_c["launches"] == run_e["launches"]
          and run_c["collectives"] == run_e["collectives"]
          and steps["captured"] == steps["eager"]
          and bool(run_c["graph_collectives"]))
    if want_coll is not None:
        rec["expected_collectives"] = want_coll
        ok = ok and steps["eager"]["collectives"] == want_coll
    if want_step is not None:
        rec["expected_step_kernels"] = want_step
        ok = ok and steps["eager"]["kernels"] == want_step
    if want_run is not None:
        rec["expected_run_launches"] = want_run
        ok = ok and run_c["launches"] == want_run
    if want_solve is not None:
        rec["expected_solve_launches"] = want_solve
        ok = ok and sc["launches"] == want_solve
    emit(phase, **rec)
    return rec, path, [] if ok else [rec]


def dist_ell_f32(torch, mesh, built):
    """pipe-PR-CG and hs-CG on the ELL row context at world size 1:
    ell_f32's operator (HPCG 27-point, 104^3, permuted), which ``dist_run``
    solves in its RCM basis (the context takes ``B``'s storage as it is,
    no order), the cache gathered whole (the planner's choice at one
    rank): row 12 once per product with no gather, ``b`` and ``x0``
    gathered into the basis once a run (``ell_gather``), one all-gather
    per matvec phase, one all-reduce per sync phase (hs-CG: two); nu and
    alpha within 1e-4 of the single-device run through iteration 15.
    Returns the launches."""
    a, op, b, x_true = built.pop("hpcg_ell")
    path, failed = {}, []
    for name, want_run, want_step, syncs in (
            ("pipe_pr_cg", {"ell_spmv_cache": 3,
                            "ell_spmv2_cache": DIST_ROWS - 1},
             {"ell_spmv2_cache": 1}, 1),
            ("hs_cg", {"ell_spmv_cache": 2 + DIST_ROWS - 1},
             {"ell_spmv_cache": 1}, 2)):
        _, counts, bad = dist_case(
            torch, "dist_ell_f32", mesh, name, op, b,
            fields=dict(n=op.n, operator="ELL, HPCG 104^3 permuted"),
            want_run=dict(want_run, ell_gather=2), want_step=want_step,
            want_coll={"all_reduce": syncs, "all_gather": 1})
        add_counts(path, counts)
        failed += bad
    if failed:
        raise AssertionError(f"ELL row context failed: {failed}")
    return path


def df_rows(torch, ctx, init_fn, step_fn, b, x0, rows):
    """``rows`` states of a double-word run stepped by hand: nu and alpha as
    the probes give them (collapsed) and nu in float64 (hi + lo)."""
    from new_cg_variants_tpu_torch.probes.probes import resolve_probes

    fns = resolve_probes(("nu", "alpha"))
    out = {"nu": [], "alpha": [], "nu64": []}
    state = init_fn(ctx, b, x0)
    for k in range(rows):
        if k:
            state = step_fn(ctx, state)
        for p, fn in fns.items():
            out[p].append(fn(ctx, state, {}))
        out["nu64"].append(state["nu"].value64())
    return {p: torch.stack(v).cpu().numpy() for p, v in out.items()}


def df_witness(torch, mesh, dop, b):
    """pipe-PR-CG in f32x2 on the model problem, stepped by hand: the
    single-device mode with row 11 (its dots in the tiles' order) and with
    the generic double-word vector phase (df_dot's flat tree), the mesh
    context at world size 1, and hs-CG.  The mesh context must repeat the
    generic run's double words in every row; the row-11 run must stay within
    DF_EPS2_TOL of it through DF_EPS2_ROWS rows (the other order's
    rounding, before the model problem amplifies it).  Prints the first
    DF_WITNESS_ROWS rows of each run and their relative differences.
    Returns ``(generic run's rows, failed)``."""
    from new_cg_variants_tpu_torch.ops.doublefloat import DoubleFloatContext
    from new_cg_variants_tpu_torch.parallel.dist import _setup
    from new_cg_variants_tpu_torch.solvers.api import prepare
    from new_cg_variants_tpu_torch.solvers.context import (
        generic_pipe_vector_phase)

    class GenericPhase(DoubleFloatContext):
        def pipe_vector_phase(self, *args):
            return generic_pipe_vector_phase(self, *args)

    runs = {}
    for name in DIST_DF_NAMES:
        p = prepare(name, dop, b, preconditioner=None, dtype="f32x2",
                    compensated=False, device="cuda")
        runs[name] = df_rows(torch, p.ctx, p.init_fn, p.step_fn, p.b, p.x0,
                             DIST_DF_ITERS)
        if name == "pipe_pr_cg":
            runs["generic"] = df_rows(
                torch, GenericPhase(p.ctx.op, p.ctx.precond), p.init_fn,
                p.step_fn, p.b, p.x0, DIST_DF_ITERS)
    _, local, _ = _setup("pipe_pr_cg", dop, b, None, mesh, "auto", None,
                         "f32x2", False, True, "cuda")
    runs["mesh"] = df_rows(torch, local.ctx, local.init_fn, local.step_fn,
                           local.b, local.x0, DIST_DF_ITERS)
    gen = runs["generic"]["nu64"]

    def rel(a, ref):
        return np.abs(a - ref) / np.abs(ref)

    row11 = rel(runs["pipe_pr_cg"]["nu64"], gen)
    mesh_same = all(np.array_equal(runs["mesh"][p], runs["generic"][p])
                    for p in ("nu64", "nu", "alpha"))
    early = float(np.max(row11[:DF_EPS2_ROWS]))
    rec = dict(
        variant="pipe_pr_cg", rows=DIST_DF_ITERS, shown=DF_WITNESS_ROWS,
        mesh_equals_generic_every_row=mesh_same,
        row11_vs_generic_max_early=early, early_rows=DF_EPS2_ROWS,
        early_tol=DF_EPS2_TOL,
        first_row_row11_beyond={
            str(t): int(np.argmax(row11 > t)) if (row11 > t).any() else None
            for t in (DF_EPS2_TOL, DIST_DF_RTOL)},
        **{f"nu64_{k}": [float(v) for v in r["nu64"][:DF_WITNESS_ROWS]]
           for k, r in runs.items()},
        rel_row11_vs_generic=[float(v) for v in row11[:DF_WITNESS_ROWS]],
        rel_mesh_vs_row11=[float(v) for v in rel(
            runs["mesh"]["nu64"], runs["pipe_pr_cg"]["nu64"])[
                :DF_WITNESS_ROWS]],
        rel_hs_vs_row11=[float(v) for v in rel(
            runs["hs_cg"]["nu64"], runs["pipe_pr_cg"]["nu64"])[
                :DF_WITNESS_ROWS]])
    emit("dist_f32x2_witness", **rec)
    ok = mesh_same and early <= DF_EPS2_TOL
    return runs["generic"], [] if ok else [rec]


def dist_f32x2(torch, mesh):
    """pipe-PR-CG and hs-CG in f32x2 on the double-word row context at
    world size 1: the model problem (n = 655,360, 63 diagonals built in
    float64 and split on the host), 100 iterations; every row's nu and
    alpha within 1e-5 of the single-device f32x2 run with the same dot
    order (hs-CG: ``run``; pipe-PR-CG: the generic vector phase, with row
    11's run as the witness, df_witness); row 9's ``_ext`` entries once per
    product, one all-gather per sync phase, one halo exchange per product.
    Returns the launches."""
    from new_cg_variants_tpu_torch import banded_model, df_operator

    sym, b64, _ = banded_model(N, k=K_BAND, device="cpu")  # float64
    dop = df_operator(sym, device="cuda")  # split once on the host
    del sym
    b = torch.from_numpy(b64)
    generic, failed = df_witness(torch, mesh, dop, b)
    path = {}
    for name in DIST_DF_NAMES:
        hs = name.startswith("hs")
        want_run = ({"df_dia_spmv_ext": 2 + DIST_DF_ITERS - 1} if hs
                    else {"df_dia_spmv_ext": 3,
                          "df_dia_spmv2_ext": DIST_DF_ITERS - 1})
        _, counts, bad = dist_case(
            torch, "dist_f32x2", mesh, name, dop, b, kw=dict(dtype="f32x2"),
            rows=DIST_DF_ITERS, iters=DIST_DF_ITERS, rtol=DIST_DF_RTOL,
            want=None if hs else generic,
            fields=dict(n=N, ndiag=len(dop.inner.offsets),
                        reference="run" if hs else "generic vector phase"),
            want_run=want_run,
            want_step={"df_dia_spmv_ext" if hs else "df_dia_spmv2_ext": 1},
            want_coll={"all_gather": 2.0 if hs else 1.0,
                       "halo_exchange": 1.0}, rounds=1,
            replay_iters=DIST_DF_REPLAY_ITERS)
        add_counts(path, counts)
        failed += bad
    if failed:
        raise AssertionError(f"{len(failed)} f32x2 row-context runs failed: "
                             f"{failed}")
    return path


def dist_formats_f32(torch, mesh, built):
    """The contexts with no kernel of their own, at world size 1, float32:
    the block-banded row context on formats_f32's operator (the permuted
    model problem, packed in 128-row blocks), the stencil row context on
    ``banded_model(655360, k=32, fmt="stencil")``, the column context on a
    dense SPD n = 8192 matrix (256 MiB) packed and unpacked; pipe-PR-CG
    against its single-device run (nu, alpha to 1e-4 through iteration
    15), collectives per iteration, ms/iter; the packed column context's
    collective totals of every family's ``_cg`` name and the unpacked one's
    gv and pipe_pr.  formats_f32 leaves its operator in ``built``; the
    dense one is left there for dist_scaling."""
    from new_cg_variants_tpu_torch import as_operator, banded_model
    from new_cg_variants_tpu_torch.parallel.dist import _setup
    from new_cg_variants_tpu_torch.solvers.api import VARIANT_NAMES

    failed = []
    if "model_block" not in built:  # formats_f32 did not run before
        ap, bp64 = model_csr(N, PERM_SEED)
        built["model_block"] = (
            as_operator(ap, dtype=torch.float32, device="cuda"),
            torch.from_numpy(bp64).to(device="cuda", dtype=torch.float32))
    op, b = built.pop("model_block")
    failed += dist_case(torch, "dist_formats_f32", mesh, "pipe_pr_cg", op, b,
                        fields=dict(n=N, operator="block-banded (the "
                                    "permuted model problem)"),
                        want_step={}, want_run={},
                        want_coll={"all_reduce": 1.0,
                                   "halo_exchange": 1.0})[2]
    del op, b
    st, b64, _ = banded_model(N, k=K_BAND, fmt="stencil", device="cpu")
    op = st.astype(torch.float32).to("cuda")
    b = torch.from_numpy(b64).to(device="cuda", dtype=torch.float32)
    failed += dist_case(torch, "dist_formats_f32", mesh, "pipe_pr_cg", op, b,
                        fields=dict(n=N, operator="stencil"), want_step={},
                        want_run={},
                        want_coll={"all_reduce": 1.0,
                                   "halo_exchange": 1.0})[2]
    del op, b
    a = dense_spd(torch, COL_N, seed=5, device="cuda")
    op = as_operator(a.astype(np.float32), device="cuda")
    b = torch.from_numpy(a @ np.ones(COL_N)).to(device="cuda",
                                                 dtype=torch.float32)
    del a
    for packed in (True, False):
        kw = dict(partition="col", col_packed=packed)
        want = ({"all_reduce": 1.0} if packed
                else {"all_reduce": 1.0, "reduce_scatter": 1.0})
        failed += dist_case(torch, "dist_formats_f32", mesh, "pipe_pr_cg",
                            op, b, kw=kw, fields=dict(
                                n=COL_N, operator="dense", **kw),
                            want_step={}, want_run={}, want_coll=want)[2]
        totals = {}
        for name in (nm for nm in VARIANT_NAMES if nm.endswith("_cg")):
            family = name.rsplit("_", 1)[0]
            if not packed and family not in ("gv", "pipe_pr"):
                continue
            _, local, _ = _setup(name, op, b, None, mesh, "col", None, None,
                                 False, packed, "cuda")
            state = local.init_fn(local.ctx, local.b, local.x0)
            reset_collectives()
            for _ in range(3):
                state = local.step_fn(local.ctx, state)
            totals[name] = {k: v / 3 for k, v in collective_counts().items()}
        want_totals = {name: (sum(c.values()) == COL_PACKED[
            name.rsplit("_", 1)[0]]) if packed else c == {
            "all_reduce": 1.0, "reduce_scatter": 1.0}
            for name, c in totals.items()}
        emit("dist_formats_f32", operator=f"dense n = {COL_N}",
             col_packed=packed, collectives_per_iteration=totals,
             as_expected=want_totals)
        if not all(want_totals.values()):
            failed.append(dict(col_packed=packed, totals=totals))
    built["col_dense"] = (op, b)
    if failed:
        raise AssertionError(f"{len(failed)} mesh-context runs failed: "
                             f"{failed}")


def dist_scaling(torch, mesh, built):
    """The harness and the command line on a mesh at world size 1:
    ``time_variant(mesh=..., partition="row" | "col", chunk_iters=500)``
    (main_f32's problem half-band; the dense n = 8192 of
    dist_formats_f32), beside the single-device loop; ``scaling_run``'s
    result file with the JAX package's keys; ``cli.main(["solve",
    "--devices", "1", "--partition", "row", ...])`` through ``dist_solve``;
    ``--devices 2`` raising the error that names ``torchrun``.  Returns
    the launches."""
    import contextlib
    import io
    import json as js
    import pathlib
    import tempfile

    from new_cg_variants_tpu_torch import cli
    from new_cg_variants_tpu_torch.harness.scaling import (
        scaling_run,
        time_variant,
    )

    failed, path = [], {}
    sym, b, x_true = model_f32(torch, "symdia")
    col_op, col_b = built.pop("col_dense")
    col_x = np.ones(COL_N)
    for part, op, rhs, xt in (("row", sym, b, x_true),
                              ("col", col_op, col_b, col_x)):
        c = counted_call(torch, lambda: time_variant(
            "pipe_pr_cg", op, rhs, x_true=xt, max_iter=SCALING_ITERS,
            trials=2, mesh=mesh, partition=part, chunk_iters=SCALING_CHUNK))
        got = c["out"]
        add_counts(path, c["launches"])
        add_counts(MESH_GRAPHS.setdefault("dist_scaling", {}),
                   c["graph_launches"])
        one = time_variant("pipe_pr_cg", op, rhs, x_true=xt,
                           max_iter=SCALING_ITERS, trials=2)
        rec = dict(call="time_variant", partition=part, n=got.n,
                   n_devices=got.n_devices, max_iter=SCALING_ITERS,
                   chunk_iters=SCALING_CHUNK,
                   mesh_ms_per_iter=got.time_per_iter * 1e3,
                   single_ms_per_iter=one.time_per_iter * 1e3,
                   mesh_error=got.error, single_error=one.error,
                   graph_launches=c["graph_launches"],
                   graph_collectives=c["graph_collectives"],
                   collectives=c["collectives"],
                   capture_seconds=c["capture_seconds"])
        emit("dist_scaling", **rec)
        # the same size of error (two summation orders over 1000 float32
        # iterations: the digits differ); the trials replayed
        if not (np.isfinite(got.error) and got.n_devices == 1
                and abs(got.error - one.error) <= 0.05 * one.error
                and c["graph_collectives"]):
            failed.append(rec)
    del col_op, col_b
    with tempfile.TemporaryDirectory() as tmp:
        res = scaling_run(["pipe_pr_cg"], n=N, k=K_BAND, max_iter=300,
                          trials=1, mesh_sizes=(1,), dtype=torch.float32,
                          data_dir=tmp, verbose=False)
        files = {p.name: js.loads(p.read_text())
                 for p in pathlib.Path(tmp).glob("*_p1_n*.json")}
    keys = {name: sorted(d) for name, d in files.items()}
    rec = dict(call="scaling_run", files=sorted(files), keys=keys)
    emit("dist_scaling", **rec)
    if not (len(res) == 1 and len(files) == 1
            and all(set(k) == SCALING_KEYS for k in keys.values())):
        failed.append(rec)
    buf = io.StringIO()

    def cli_solve():
        with contextlib.redirect_stdout(buf):
            return cli.main(["solve", "-n", str(N), "-k", str(K_BAND),
                             "--dtype", "f32", "--devices", "1",
                             "--partition", "row", "--ksp-norm-type",
                             "none", "--max-iter", "300"])

    c = counted_call(torch, cli_solve)
    rc, counts = c["out"], c["launches"]
    add_counts(path, counts)
    add_counts(MESH_GRAPHS.setdefault("dist_scaling", {}),
               c["graph_launches"])
    lines = buf.getvalue().splitlines()
    rec = dict(call="cli solve --devices 1 --partition row", rc=rc,
               lines=lines, launches=counts,
               graph_launches=c["graph_launches"])
    emit("dist_scaling", **rec)
    # through dist_solve, replayed: the half-band SpMV of the extended
    # slice, no fused family kernel
    if not (rc == 0 and len(lines) == 4 and counts.get("sym_dia_spmv2")
            and c["graph_launches"].get("sym_dia_spmv2")
            and not any(k.startswith("fused") for k in counts)):
        failed.append(rec)
    try:
        cli.main(["solve", "-n", str(N), "-k", str(K_BAND), "--devices", "2",
                  "--max-iter", "5"])
    except ValueError as exc:
        refused = str(exc)
    else:
        refused = None
    emit("dist_scaling", call="solve --devices 2", raised=refused)
    if not (refused and "torchrun --nproc-per-node 2" in refused):
        failed.append(dict(devices=2, raised=refused))
    if failed:
        raise AssertionError(f"{len(failed)} mesh harness calls failed: "
                             f"{failed}")
    return path


# ---------------------------------------------------------------------------
# The compiled loop: use_jit=True replays captured CUDA graphs
# ---------------------------------------------------------------------------

#: iterations of a run whose bits are held between use_jit=True and False:
#: the main paths', and each name's of a path that runs every name
JIT_ITERS = 300
JIT_NAME_ITERS = 100
#: chained iterations of a trial's chunk for the paths timed with a shorter
#: protocol (ELL, at ~0.5-0.8 ms an eager step; f32x2, at ~3.6 ms; each
#: of the 18 names); the trials of every jit timing (the protocol's least,
#: MIN_TRIALS); the profiled window, in captured chunks (fewer for f32x2,
#: whose 278 kernels a step make the profiler's events slow to read, and
#: for each name)
JIT_ELL_ITERS = 2000
JIT_SHORT_ITERS = 200
JIT_TRIALS = MIN_TRIALS
JIT_PROFILE_CHUNKS = 6
JIT_DF_PROFILE_CHUNKS = 2
JIT_NAME_PROFILE_CHUNKS = 1
#: a history run's probes: residual_2_norm puts one product a step (the
#: SpMV entry of the operator's kind) inside the captured graph
JIT_PROBES = ("nu", "alpha", "residual_2_norm")
#: the tolerance solves of jit_solve: (problem, variant, preconditioner,
#: norm type, rtol, max_iter); "model" is main_f32's problem, "scaled" the
#: scaled band of variants_f64 in float32 (on the model problem Jacobi
#: converges within a few iterations)
JIT_SOLVES = (("model", "pipe_pr_cg", None, "natural", 1e-4, 3000),
              ("scaled", "pipe_pr_pcg", "jacobi", "natural", 1e-5, 3000),
              ("model", "pipe_pr_pcg", "jacobi", "unpreconditioned", 0.0,
               GENERIC_ITERS),
              ("model", "pipe_pr_cg", None, "none", 0.0, 1000))

#: launches made at a capture (by wrapper), the same launches once for each
#: replay of that graph (``read_counts`` counts a captured launch as often
#: as its graph was replayed), and the host seconds of the captures' bodies
#: and of their instantiation (install_graph_counts)
GRAPH = {"captured": {}, "replayed": {}, "seconds": {}}


def raw_counts():
    return {fn.__name__: fn.launches for fn in counted_wrappers()}


def install_graph_counts():
    """Count the launches and the collective calls a captured graph makes:
    each capture's (the wrappers' counts around it), once for every
    replay."""
    from new_cg_variants_tpu_torch.solvers import graphs

    capture = graphs.CudaCapture.capture

    def counted(self, body):
        before, coll = raw_counts(), raw_collectives()
        seconds = (self.capture_seconds, self.instantiate_seconds)
        replay = capture(self, body)
        inside = {k: v - before[k] for k, v in raw_counts().items()
                  if v != before[k]}
        calls = {k: v - coll[k] for k, v in raw_collectives().items()
                 if v != coll[k]}
        add_counts(GRAPH["captured"], inside)
        add_counts(GRAPH_COLL["captured"], calls)
        add_counts(GRAPH["seconds"], {
            "capture": self.capture_seconds - seconds[0],
            "instantiate": self.instantiate_seconds - seconds[1]})

        def counted_replay():
            replay()
            add_counts(GRAPH["replayed"], inside)
            add_counts(GRAPH_COLL["replayed"], calls)

        return counted_replay

    graphs.CudaCapture.capture = counted


def same_output(got, want, keys):
    """Whether each of ``keys`` of two ``run`` outputs has the same bits
    (numpy arrays, or ``x`` as a tensor)."""
    out = {}
    for key in keys:
        g, w = got[key], want[key]
        if hasattr(g, "cpu"):
            g, w = g.cpu().numpy(), w.cpu().numpy()
        out[key] = bool(g.dtype == w.dtype and g.shape == w.shape
                        and g.tobytes() == w.tobytes())
    return out


def jit_pair(torch, call):
    """``call(use_jit)`` with use_jit=True, then False: the results, host
    seconds, launches (captured ones once per replay), the launches that
    ran inside graphs, by wrapper, and the captures' host seconds."""
    out = {}
    for jit in (True, False):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = call(jit)
        torch.cuda.synchronize()
        out[jit] = (res, time.perf_counter() - t0, read_counts(),
                    nonzero(GRAPH["replayed"]), dict(GRAPH["seconds"]))
    return out


def run_pair(torch, phase, variant, op, b, iters, probes=JIT_PROBES,
             fields=None, **kw):
    """One history run (``run``'s keywords ``kw``) with use_jit=True and
    with False: ``x`` and every probe history the same bits, the same
    launches.  Emits the record with ``fields``; returns it, whether it
    holds, and the launches inside graphs."""
    from new_cg_variants_tpu_torch import run

    pair = jit_pair(torch, lambda jit: run(
        variant, op, b, max_iter=iters + 1, probes=probes, use_jit=jit,
        **kw))
    (g, g_s, g_n, inside, cap), (e, e_s, e_n, *_) = pair[True], pair[False]
    same = same_output(g, e, ("x",) + tuple(probes))
    rec = dict(variant=variant, iterations=iters, same_bits=same,
               seconds_jit=g_s, seconds_eager=e_s, capture_seconds=cap,
               graph_launches=inside,
               launches=nonzero(g_n), eager_launches=nonzero(e_n))
    rec.update({k: v for k, v in kw.items()
                if isinstance(v, (str, int, float, type(None)))})
    rec.update(fields or {})
    emit(phase, **rec)
    return rec, all(same.values()) and g_n == e_n and bool(inside), inside


def solve_pair(torch, phase, op, b, variant, precond, norm_type, rtol,
               max_iter, **fields):
    """One tolerance solve with use_jit=True and with False: the same
    iterations, norm, convergence and bits of ``x``.  The launches of the
    replays are the eager loop's and, where a chunk ran past the stopping
    iteration (its state then taken back), those of the steps past it
    (``overshoot``): never fewer; with ``norm_type="none"`` the same."""
    from new_cg_variants_tpu_torch import solve

    pair = jit_pair(torch, lambda jit: solve(
        op, b, variant=variant, preconditioner=precond, norm_type=norm_type,
        rtol=rtol, max_iter=max_iter, use_jit=jit))
    (g, g_s, g_n, inside, cap), (e, e_s, e_n, *_) = pair[True], pair[False]
    same = dict(iterations=g.iterations == e.iterations,
                norm=np.float64(g.norm).tobytes() == np.float64(
                    e.norm).tobytes(),
                converged=g.converged == e.converged,
                x=bool(torch.equal(g.x, e.x)))
    it = max(g.iterations, 1)
    rec = dict(variant=variant, preconditioner=precond, norm_type=norm_type,
               rtol=rtol, max_iter=max_iter, iterations=g.iterations,
               norm=g.norm, converged=g.converged, same=same,
               ms_per_iter_jit=g_s / it * 1e3,
               ms_per_iter_eager=e_s / it * 1e3, capture_seconds=cap,
               graph_launches=inside,
               launches=nonzero(g_n), eager_launches=nonzero(e_n),
               overshoot=nonzero({k: g_n[k] - e_n[k] for k in g_n}),
               **fields)
    emit(phase, **rec)
    launches_ok = (g_n == e_n if norm_type == "none"
                   else all(g_n[k] >= e_n[k] for k in g_n))
    return rec, all(same.values()) and launches_ok, inside


def replay_protocol(torch, ctx, init_fn, step_fn, b, x0, chunk_iters,
                    max_trials):
    """protocol_ms over replays of captured chunks (graphs.Runner, as
    use_jit=True runs the loop; the loop made at the warm-up chunk, each
    trial loading its init state): ``(ms/iter, trial seconds, nu at the
    end, advance, loop)``."""
    from new_cg_variants_tpu_torch.ops.doublefloat import collapse
    from new_cg_variants_tpu_torch.solvers import graphs

    runner = graphs.runner(torch.device("cuda"), use_jit=True)
    loop = {}

    def begin(scale):
        s = init_fn(ctx, b * scale, x0)
        if not loop:
            loop["l"] = runner.start(ctx, step_fn, s, horizon=chunk_iters)
        loop["l"].load(s)

    def advance(m):
        loop["l"].advance(m)

    ms, times, nu = protocol_ms(
        begin, advance, lambda: float(collapse(loop["l"].state()["nu"])),
        chunk_iters, max_trials)
    return ms, times, nu, advance, loop["l"]


def jit_timing(torch, ctx, init_fn, step_fn, b, x0,
               chunk_iters=ITERS_PER_CHUNK, max_trials=JIT_TRIALS,
               profile_chunks=JIT_PROFILE_CHUNKS, eager=None):
    """The step loop of ``ctx`` timed under the bench protocol eagerly and
    as replays of captured graphs (graphs.Runner, as use_jit=True runs it),
    one after the other, each with a profiled window (``profile_chunks``
    chunks of the graph's steps): ms/iter, device time and busy share (of
    the profiled window's wall time, and of the protocol's ms/iter), CUDA
    events per iteration; the capture's and instantiation's host seconds.
    ``eager``: the eager loop's ``{"ms_per_iter", "profile"}`` as the
    phase's own bench_protocol measured it earlier in the run (not measured
    again)."""
    from new_cg_variants_tpu_torch.solvers import graphs

    steps = profile_chunks * min(graphs.CHUNK, chunk_iters)
    if eager is None:
        begin, advance, read_nu = eager_loop(ctx, init_fn, step_fn, b, x0)
        ms, times, nu = protocol_ms(begin, advance, read_nu, chunk_iters,
                                    max_trials)
        eager = dict(ms_per_iter=ms, trial_seconds=times, nu_final=nu,
                     profile=profile_window(torch, advance, steps))
    else:
        eager = dict(eager, measured_in="the phase's bench_protocol")
    ms, times, nu, gadvance, loop = replay_protocol(
        torch, ctx, init_fn, step_fn, b, x0, chunk_iters, max_trials)
    replayed = dict(ms_per_iter=ms, trial_seconds=times, nu_final=nu,
                    profile=profile_window(torch, gadvance, steps))
    for rec in (eager, replayed):
        busy = rec["profile"].get("device_busy_ms_per_iter")
        rec["busy_share_of_ms_per_iter"] = (None if busy is None
                                            else busy / rec["ms_per_iter"])
    cap = loop.cap
    rec = dict(chunk_iters=chunk_iters, graph_chunk=loop.chunk,
               ms_per_iter_eager=eager["ms_per_iter"],
               ms_per_iter_jit=replayed["ms_per_iter"],
               speedup=eager["ms_per_iter"] / replayed["ms_per_iter"],
               eager=eager, jit=replayed,
               capture_seconds=cap.capture_seconds,
               instantiate_seconds=cap.instantiate_seconds,
               graphs=len(cap.graphs))
    ok = all(v is None or np.isfinite(v)
             for v in (eager.get("nu_final"), replayed["nu_final"]))
    return rec, ok


def single_pieces(torch, op, b, variant, precond=None, dtype=None):
    """``(ctx, init_fn, step_fn, b, x0)`` of ``variant``'s single-device
    step loop on ``op`` as a solve runs it: double-word for a
    ``DFOperator`` (or ``dtype="f32x2"``), else in the operator's basis
    (ELL in a locality order, block-banded)."""
    from new_cg_variants_tpu_torch.ops.doublefloat import DFOperator
    from new_cg_variants_tpu_torch.solvers.api import prepare

    if isinstance(op, DFOperator):
        dtype = "f32x2"
    p = prepare(variant, op, b, preconditioner=precond, dtype=dtype,
                compensated=False, device="cuda")
    return p.ctx, p.init_fn, p.step_fn, p.b, p.x0


def jit_timed(torch, phase, op, b, variant, card, chunk_iters=ITERS_PER_CHUNK,
              max_trials=JIT_TRIALS, precond=None, profile_chunks=None,
              eager=None, **fields):
    """jit_timing of ``variant`` on ``op`` (single-word or, for a
    ``DFOperator``, double-word), emitted with the card's line."""
    rec, ok = jit_timing(torch, *single_pieces(torch, op, b, variant,
                                               precond),
                         chunk_iters, max_trials,
                         profile_chunks or JIT_PROFILE_CHUNKS, eager)
    emit(phase, variant=variant, timing=rec, card=card, **fields)
    return rec, ok


def hold(phase, failed):
    if failed:
        raise AssertionError(f"{phase}: {len(failed)} checks failed: "
                             f"{failed}")


def jit_names(torch, phase, op, b, names, iters=JIT_NAME_ITERS,
              precond=jacobi_for_pcg, probes=("nu", "alpha"), entry=None,
              fields=None, **kw):
    """run_pair of each name; returns the launches inside graphs, summed,
    a wrapper's launches under the kernel entry ``entry(name)`` where that
    is one of the wrapper's (as solve_names files them), and the failed
    records."""
    inside, failed = {}, []
    for name in names:
        rec, ok, got = run_pair(torch, phase, name, op, b, iters,
                                probes=probes, fields=fields,
                                preconditioner=precond(name, op)[1], **kw)
        dest = entry(name) if entry else ""
        add_counts(inside, {dest if k == dest.split("/")[0] else k: v
                            for k, v in got.items()})
        if not ok:
            failed.append(rec)
    return inside, failed


def sym_entry(name):
    return VARIANT_ENTRY.get(name, (EPILOGUE,))[0]


def dia_entry(name):
    return dia_expected(name, 0)[1]


def jit_main_f32(torch, card, timings):
    """The main path captured: pipe-PR-CG on main_f32's problem, use_jit
    True against False (x, nu, alpha and the true residual, whose product
    runs inside the graph, the same bits; the same launches), both timed
    under the bench protocol with their profiles."""
    op, b, _ = model_f32(torch, "symdia")
    rec, ok, inside = run_pair(torch, "jit_main_f32", "pipe_pr_cg", op, b,
                               JIT_ITERS)
    failed = [] if ok else [rec]
    t, ok = jit_timed(torch, "jit_main_f32", op, b, "pipe_pr_cg", card,
                      eager=timings["main_f32"], n=N, k=K_BAND)
    timings["jit_main_f32"] = t
    hold("jit_main_f32", failed + ([] if ok else [t]))
    return inside


def jit_variants_f32(torch, card):
    """Every name on main_f32's half-band problem captured: use_jit True
    against False for JIT_NAME_ITERS iterations, same bits and launches;
    each timed both ways with JIT_SHORT_ITERS-iteration chunks, profiled
    over one chunk."""
    from new_cg_variants_tpu_torch import VARIANT_NAMES

    op, b, _ = model_f32(torch, "symdia")
    inside, failed = jit_names(torch, "jit_variants_f32", op, b,
                               VARIANT_NAMES, entry=sym_entry)
    ms = {}
    for name in VARIANT_NAMES:
        t, ok = jit_timed(torch, "jit_variants_f32", op, b, name, card,
                          JIT_SHORT_ITERS,
                          profile_chunks=JIT_NAME_PROFILE_CHUNKS,
                          precond=jacobi_for_pcg(name, op)[1])
        ms[name] = (t["ms_per_iter_eager"], t["ms_per_iter_jit"])
        if not ok:
            failed.append(t)
    emit("jit_variants_f32", ms_per_iter_eager_jit=ms, card=card)
    failed += jit_hook(torch, op, b)
    hold("jit_variants_f32", failed)
    return inside


def jit_hook(torch, op, b):
    """gv's replacement hook under capture: ``k % 10 == 0`` answers a bool
    tensor for the device ``k`` of use_jit=True (the step selects) and a
    Python bool for use_jit=False's host ``k`` (the step branches): the
    same bits; a hook that answers a Python bool under use_jit=True is
    refused with TypeError.  Returns the failed records."""
    from new_cg_variants_tpu_torch import run

    kw = dict(max_iter=JIT_NAME_ITERS + 1, probes=("nu", "alpha"))
    pair = jit_pair(torch, lambda jit: run(
        "gv_cg", op, b, use_jit=jit, w_replace=lambda k, view: k % 10 == 0,
        **kw))
    same = same_output(pair[True][0], pair[False][0], ("x", "nu", "alpha"))
    try:
        run("gv_cg", op, b, w_replace=lambda k, view: True, **kw)
        refused = None
    except TypeError as e:
        refused = str(e)
    rec = dict(variant="gv_cg", hook="k % 10 == 0", same_bits=same,
               graph_launches=pair[True][3], python_bool_refused=refused)
    emit("jit_variants_f32", **rec)
    ok = (all(same.values()) and bool(pair[True][3])
          and refused is not None and "use_jit=False" in refused)
    return [] if ok else [rec]


def jit_dia_f32(torch, card, timings):
    """The full-DIA path captured: every name (use_jit True against False,
    same bits and launches), pipe-PR-CG with the true residual (the DIA
    SpMV inside the graph) and timed both ways; the split formulation
    (preconditioner as a function: row 5 and the 2-RHS SpMV)."""
    from new_cg_variants_tpu_torch import VARIANT_NAMES

    op, b, _ = model_f32(torch, "dia")
    inside, failed = jit_names(torch, "jit_dia_f32", op, b, VARIANT_NAMES,
                               entry=dia_entry)
    rec, ok, got = run_pair(torch, "jit_dia_f32", "pipe_pr_cg", op, b,
                            JIT_ITERS)
    add_counts(inside, got)
    failed += [] if ok else [rec]
    inv = 1.0 / op.diagonal()
    got, f2 = jit_names(torch, "jit_dia_f32", op, b, ("pipe_pr_pcg",),
                        precond=lambda name, op: (None, lambda v: inv * v))
    add_counts(inside, got)
    t, ok = jit_timed(torch, "jit_dia_f32", op, b, "pipe_pr_cg", card,
                      eager=timings["dia_f32"], n=N, k=K_BAND, fmt="dia")
    timings["jit_dia_f32"] = t
    hold("jit_dia_f32", failed + f2 + ([] if ok else [t]))
    return inside


def jit_dia_wide_f32(torch):
    """dia_wide_f32's band captured: the split formulations (rows 4, 5 and
    the direct-regime SpMV) and a generic body, use_jit True against
    False."""
    op = grid_operator(torch, torch.float32)
    b = op.mv(torch.ones(op.n, dtype=torch.float32, device="cuda"))
    inside, failed = jit_names(torch, "jit_dia_wide_f32", op, b,
                               ("pipe_pr_cg", "pipe_pr_pcg", "pr_cg"),
                               iters=40, probes=JIT_PROBES)
    hold("jit_dia_wide_f32", failed)
    return inside


def df_checked(torch):
    """The double-word mode's one-shot check on the card, made before a
    use_jit pair so that neither run's launches include it."""
    from new_cg_variants_tpu_torch.solvers import api

    api.df_selfcheck(torch.device("cuda"))


def jit_f32x2(torch, card, built, timings):
    """The double-word path captured: pipe-PR-CG (row 9 with 2 RHS, row 11)
    and hs-CG (row 9 once a product) in f32x2 on df_f32x2's operator,
    use_jit True against False; pipe-PR-CG timed both ways with
    JIT_SHORT_ITERS-iteration chunks."""
    dop, b = built.pop("df_model")
    df_checked(torch)
    inside, failed = jit_names(torch, "jit_f32x2", dop, b,
                               ("pipe_pr_cg", "hs_cg"), dtype="f32x2",
                               probes=JIT_PROBES)
    t, ok = jit_timed(torch, "jit_f32x2", dop, b, "pipe_pr_cg", card,
                      JIT_SHORT_ITERS, profile_chunks=JIT_DF_PROFILE_CHUNKS,
                      n=N, ndiag=len(dop.inner.offsets))
    timings["jit_f32x2"] = t
    hold("jit_f32x2", failed + ([] if ok else [t]))
    return inside


def jit_df_dense(torch, built):
    """df_dense_f32x2's operator captured (row 10, rows 9-11's dense
    path): pipe-PR-CG and hs-CG in f32x2, use_jit True against False."""
    dense, b = built.pop("df_dense")
    df_checked(torch)
    inside, failed = jit_names(torch, "jit_df_dense", dense, b,
                               ("pipe_pr_cg", "hs_cg"), dtype="f32x2",
                               probes=JIT_PROBES)
    hold("jit_df_dense", failed)
    return inside


class OriginalOrderDiagonal:
    """An object preconditioner ``v -> inv * v`` whose diagonal ``inv`` is
    in the matrix's original numbering.  A solve in an ELL operator's basis
    hands it vectors in that order (``GivenOrderPreconditioner``): a
    scatter out, then one ``ell_gather`` back into the basis, each time it
    is applied inside the loop."""

    def __init__(self, inv):
        self.inv = inv

    def apply(self, v):
        return self.inv * v


def distinct_inverse_diagonal(torch, a, dtype, seed=16):
    """The inverse of ``a``'s diagonal, each entry scaled by its own random
    factor in [0.5, 2] (distinct entries: applied to the wrong rows, they
    would give another solve), on the card in ``dtype``."""
    d = a.diagonal().astype(np.float64) * np.random.default_rng(seed).uniform(
        0.5, 2.0, a.shape[0])
    return torch.as_tensor(1.0 / d, dtype=dtype, device="cuda")


def original_order_diagonal(torch, a, dtype, seed=16):
    """:class:`OriginalOrderDiagonal` of :func:`distinct_inverse_diagonal`:
    applied in the basis without the wrapper, it would scale the wrong
    rows."""
    return OriginalOrderDiagonal(distinct_inverse_diagonal(torch, a, dtype,
                                                           seed))


def jit_ell_f32(torch, card, built, timings):
    """The ELL path captured (HPCG 104^3 permuted, solved in its RCM basis:
    row 12 with no gather): pipe-PR-CG with the true residual and hs-CG,
    and pipe-PR-PCG with an object preconditioner in the original order
    (the one gather inside the loop) and with a ``JacobiPreconditioner``
    of the same diagonal (moved into the basis once a solve: b, x0 and the
    diagonal the run's 3 gathers, none inside a graph), use_jit True
    against False; pipe-PR-CG timed both ways (JIT_ELL_ITERS-iteration
    chunks); the tolerance solve of ell_f32, which stops inside a chunk."""
    from new_cg_variants_tpu_torch.solvers.precond import (
        JacobiPreconditioner,
    )

    a, op, b, _ = built["hpcg_ell"]
    inside, failed = jit_names(torch, "jit_ell_f32", op, b,
                               ("pipe_pr_cg", "hs_cg"), iters=JIT_ITERS,
                               probes=JIT_PROBES)
    rec, ok, got = run_pair(
        torch, "jit_ell_f32", "pipe_pr_pcg", op, b, JIT_ITERS,
        preconditioner=original_order_diagonal(torch, a, torch.float32),
        fields={"preconditioner": "diagonal object, original order"})
    add_counts(inside, got)
    failed += [] if ok and got.get("ell_gather") else [rec]
    rec, ok, got = run_pair(
        torch, "jit_ell_f32", "pipe_pr_pcg", op, b, JIT_ITERS,
        preconditioner=JacobiPreconditioner(distinct_inverse_diagonal(
            torch, a, torch.float32)),
        fields={"preconditioner": "JacobiPreconditioner, original order"})
    add_counts(inside, got)
    failed += [] if (ok and not got.get("ell_gather")
                     and rec["launches"].get("ell_gather") == 3) else [rec]
    rec, ok, got = solve_pair(torch, "jit_ell_f32", op, b, "pipe_pr_cg",
                              None, "natural", ELL_RTOL, ELL_MAX_ITER,
                              card=card)
    add_counts(inside, got)
    failed += [] if ok and rec["converged"] else [rec]
    t, ok = jit_timed(torch, "jit_ell_f32", op, b, "pipe_pr_cg", card,
                      JIT_ELL_ITERS, n=op.n)
    timings["jit_ell_f32"] = t
    hold("jit_ell_f32", failed + ([] if ok else [t]))
    return inside


def jit_bf16(torch, card, built, timings):
    """bf16 storage captured: main_bf16's problem (pipe-PR-CG with the true
    residual, timed both ways; every name), dia_bf16's (every name, the
    split formulation) and ell_bf16's operator (pipe-PR-CG, hs-CG), use_jit
    True against False."""
    from new_cg_variants_tpu_torch import VARIANT_NAMES

    op, b, _ = model_bf16(torch, "symdia")
    rec, ok, inside = run_pair(torch, "jit_bf16", "pipe_pr_cg", op, b,
                               JIT_ITERS, fields={"storage": "bfloat16"})
    failed = [] if ok else [rec]
    got, f2 = jit_names(torch, "jit_bf16", op, b, VARIANT_NAMES,
                        entry=sym_entry)
    add_counts(inside, got)
    t, ok = jit_timed(torch, "jit_bf16", op, b, "pipe_pr_cg", card,
                      eager=timings["main_bf16"], n=N, k=K_BAND,
                      storage="bfloat16")
    timings["jit_bf16"] = t
    failed += f2 + ([] if ok else [t])
    del op
    dop, db, _ = model_bf16(torch, "dia")
    got, f2 = jit_names(torch, "jit_bf16", dop, db, VARIANT_NAMES,
                        entry=dia_entry)
    add_counts(inside, got)
    failed += f2
    got, f2 = jit_names(torch, "jit_bf16", dop, db, ("pipe_pr_cg",),
                        probes=JIT_PROBES)
    add_counts(inside, got)
    failed += f2
    inv = 1.0 / dop.diagonal().float()
    got, f2 = jit_names(torch, "jit_bf16", dop, db, ("pipe_pr_pcg",),
                        precond=lambda name, op: (None, lambda v: inv * v))
    add_counts(inside, got)
    failed += f2
    del dop
    _, eop, eb, _ = built["hpcg_ell"]
    got, f2 = jit_names(torch, "jit_bf16", eop.astype(torch.bfloat16), eb,
                        ("pipe_pr_cg", "hs_cg"), probes=JIT_PROBES)
    add_counts(inside, got)
    failed += f2
    hold("jit_bf16", failed)
    return inside


def jit_solve(torch, card):
    """Tolerance solves captured (JIT_SOLVES on main_f32's problem): use_jit
    True against False, the same iterations, norm, convergence, bits of x
    and launches; ms/iter of each beside the other."""
    model, bm, _ = model_f32(torch, "symdia")
    band, bs = scaled_band(torch, CONV_BAND_N, K_BAND)
    problems = {"model": (model, bm),
                "scaled": (band.astype(torch.float32).to("cuda"),
                           torch.as_tensor(bs, dtype=torch.float32,
                                           device="cuda"))}
    inside, failed = {}, []
    for problem, variant, precond, norm_type, rtol, max_iter in JIT_SOLVES:
        op, b = problems[problem]
        rec, ok, got = solve_pair(torch, "jit_solve", op, b, variant,
                                  precond, norm_type, rtol, max_iter,
                                  card=card, problem=problem, n=op.n,
                                  k=K_BAND)
        add_counts(inside, got)
        if not ok:
            failed.append(rec)
    hold("jit_solve", failed)
    return inside


def jit_convergence_f64(torch):
    """convergence_f64's table through ``run``: its nine names on its two
    matrices (HPCG 32^3 permuted, ELL; the scaled band, half-band) in
    float64 with Jacobi and the suite's probes, use_jit True against
    False (every probe row and x the same bits, so the same table); hs-PCG
    on the post-hoc run's 24^3 operator; on both ELL operators hs-PCG with
    an object preconditioner in the original order too (its gather inside
    the graph)."""
    from new_cg_variants_tpu_torch import as_operator, from_coo
    from new_cg_variants_tpu_torch.harness import convergence as hc
    from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy

    inside, failed = {}, []
    cases = (("hpcg27", stencil27(CONV_GRID, PERM_SEED), hc.DEFAULT_VARIANTS,
              CONV_ITERS, None),
             ("scaled_band", scaled_band(torch, CONV_BAND_N, K_BAND)[0],
              hc.DEFAULT_VARIANTS, CONV_ITERS, sym_entry),
             ("posthoc", stencil27(POSTHOC_GRID, PERM_SEED), ("hs_pcg",),
              POSTHOC_ITERS, None))
    for label, a, names, iters, entry in cases:
        # the post-hoc run's operator as convergence_f64 builds it (at 24^3
        # the auto route would pick another format)
        op = (from_coo(coo_from_scipy(a), fmt="ell", device="cuda")
              if label == "posthoc" else
              as_operator(a.tocsr(), dtype=torch.float64, device="cuda"))
        n = op.n
        x_true = np.ones(n) / np.sqrt(n)
        b = np.asarray(a.tocsr() @ x_true)
        got, f2 = jit_names(torch, "jit_convergence_f64", op, b, names,
                            iters=iters, probes=hc.PROBES,
                            precond=lambda name, op: (None, "jacobi"),
                            entry=entry, x_true=x_true,
                            fields={"matrix": label})
        add_counts(inside, got)
        failed += f2
        if entry is None:  # ELL
            rec, ok, got = run_pair(
                torch, "jit_convergence_f64", "hs_pcg", op, b, iters,
                probes=hc.PROBES, x_true=x_true,
                preconditioner=original_order_diagonal(torch, a,
                                                       torch.float64),
                fields={"matrix": label,
                        "preconditioner": "diagonal object, original order"})
            add_counts(inside, got)
            failed += [] if ok and got.get("ell_gather") else [rec]
    hold("jit_convergence_f64", failed)
    return inside


def bits_equal(torch, a, b):
    """Whether two tensors hold the same bits (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return bool(torch.equal(a, b))


def tensors_of(out):
    """The tensors of a nested tuple / list, in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensors_of(o)]
    return [out]


def capture_check(torch, fn):
    """``fn()`` eagerly, then captured once (graphs.CudaCapture, as a loop
    captures) and replayed: whether every output has the eager bits."""
    from new_cg_variants_tpu_torch.solvers import graphs

    want = tensors_of(fn())
    got = []
    replay = graphs.CudaCapture(torch.device("cuda")).capture(
        lambda: got.extend(tensors_of(fn())))
    replay()
    torch.cuda.synchronize()
    return len(got) == len(want) and all(
        bits_equal(torch, g, w) for g, w in zip(got, want))


def capture_dist(torch, built):
    """The entries the row partition runs (the dist_* phases, whose loops
    replay captured graphs) at the shapes dist_f32, dist_f32x2 and
    dist_ell_f32 give them, each held to one capture of itself alone: the
    replay's outputs the eager call's bits."""
    from new_cg_variants_tpu_torch.ops import df_spmv as ds
    from new_cg_variants_tpu_torch.ops import ell_spmv as es
    from new_cg_variants_tpu_torch.ops import fused_step as fs
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp
    from new_cg_variants_tpu_torch.ops import sym_dia as sd
    from new_cg_variants_tpu_torch.parallel.dist import _ell_locality_shard

    rng = np.random.default_rng(15)
    f32 = dict(dtype=torch.float32, device="cuda")

    def vec(n):
        return torch.as_tensor(rng.standard_normal(n), **f32)

    sym_offs = tuple(range(K_BAND))
    band = random_band(torch, sym_offs, DIST_EXT_N, torch.float32, rng)
    v, w = vec(DIST_EXT_N), vec(DIST_EXT_N)
    offs = DIA_MAIN_OFFSETS
    h = max(abs(o) for o in offs)
    shard = torch.as_tensor(rng.uniform(-1.0, 1.0, (len(offs), N)), **f32)
    vx, wx = vec(N + 2 * h), vec(N + 2 * h)
    vecs = [vec(N) for _ in range(10)]
    a1, beta = (torch.tensor(SCALAR_VALUES[k], **f32) for k in ("a1", "beta"))
    # three O(1) words a value: the kernel's steps do not depend on their
    # sizes, and the comparison is the eager call's bits
    words = [torch.as_tensor(rng.uniform(-1.0, 1.0, (len(offs), N)), **f32)
             for _ in range(3)]
    xw = [vec(N + 2 * h) for _ in range(4)]
    _, op, _, _ = built["hpcg_ell"]
    lval_t, lidx_t, q, cols = _ell_locality_shard(op, 0, op.n, "cuda")
    cv, cw = vec(op.n), vec(op.n)
    calls = {
        "sym_dia_spmv": lambda: sd.sym_dia_spmv(sym_offs, band, v),
        "sym_dia_spmv2": lambda: sd.sym_dia_spmv2(sym_offs, band, v, w),
        "dia_spmv_ext": lambda: sp.dia_spmv_ext(offs, shard, vx),
        "dia_spmv2_ext": lambda: sp.dia_spmv2_ext(offs, shard, vx, wx),
        "fused_pipe_vector_phase": lambda: fs.fused_pipe_vector_phase(
            *vecs[:6], a1, beta),
        "fused_pipe_vector_phase_prec":
            lambda: fs.fused_pipe_vector_phase_prec(*vecs, a1, beta),
        "df_dia_spmv_ext": lambda: ds.df_dia_spmv_ext(
            offs, *words, tuple(xw[:2])),
        "df_dia_spmv2_ext": lambda: ds.df_dia_spmv2_ext(
            offs, *words, tuple(xw[:2]), tuple(xw[2:])),
        "ell_spmv_cache": lambda: es.ell_spmv_cache(
            lval_t.T, lidx_t.T, cv, q, cols),
        "ell_spmv2_cache": lambda: es.ell_spmv2_cache(
            lval_t.T, lidx_t.T, cv, cw, q, cols),
    }
    reset_counts()
    same = {name: capture_check(torch, fn) for name, fn in calls.items()}
    inside = nonzero(GRAPH["replayed"])
    emit("capture_dist", same_bits=same, graph_launches=inside)
    hold("capture_dist", [k for k, ok in same.items() if not ok])
    return inside


#: suffix of a mesh phase's launches inside its captured loops (MESH_GRAPHS)
MESH = " (graphs)"
#: the phases that run a path's shapes inside captured graphs (use_jit=True
#: against False; for the row partition's entries, each captured once and
#: the mesh phases' own captured loops)
GRAPH_PATHS = {
    "main_f32": ("jit_main_f32", "jit_solve"),
    "variants_f32": ("jit_variants_f32",),
    "dia_f32": ("jit_dia_f32",), "dia_wide_f32": ("jit_dia_wide_f32",),
    "df_f32x2": ("jit_f32x2",), "df_dense_f32x2": ("jit_df_dense",),
    "ell_f32": ("jit_ell_f32",),
    "convergence_f64": ("jit_convergence_f64",),
    "posthoc_f64": ("jit_convergence_f64",),
    "main_bf16": ("jit_bf16",), "dia_bf16": ("jit_bf16",),
    "ell_bf16": ("jit_bf16",),
    "dist_f32": ("capture_dist", "dist_f32" + MESH),
    "dist_f32x2": ("capture_dist", "dist_f32x2" + MESH),
    "dist_ell_f32": ("capture_dist", "dist_ell_f32" + MESH),
}


def kernel_records(timings, launches):
    """The ``kernels`` line: one record per kernel entry and shape a driven
    path gives it, with the entry's launches on the paths of that shape
    (``launches``: path -> entry -> count) and inside captured graphs on
    the phases of GRAPH_PATHS (``graph_launches``); a shape checked and
    timed that no path runs (the ELL shards of 2 and 4 ranks) has no path
    and no launches."""
    jax_ops = "new_cg_variants_tpu/ops/"
    sym = ("main_f32", "variants_f32", "cli_f32", "trace_f32")
    # the unpreconditioned pipe names take the entry with its scalar
    # epilogue, so no path runs the entry without it: checked and timed only
    no_path = ("fused_sym_pipe_full_step",
               "fused_sym_pipe_full_step/no recompute")
    epilogues = (EPILOGUE, EPILOGUE + "/no recompute")
    records = {
        "sym_dia_spmv": ("sym_dia.cu", "sym_dia.py:47", sym),
        **{entry: ("sym_family.cu", "sym_fused.py:184",
                   () if entry in no_path else sym) for entry in FAMILY},
        **{entry: ("sym_family.cu", "sym_fused.py:184", sym)
           for entry in epilogues},
    }
    for sfx, path in (("", "dia_f32"), (WIDE, "dia_wide_f32")):
        records.update({
            "dia_spmv" + sfx: ("dia_spmv.cu", "spmv_pallas.py:58", (path,)),
            "dia_spmv2" + sfx: ("dia_spmv.cu", "spmv_pallas.py:58", (path,)),
            "fused_pipe_vector_phase_prec" + sfx: (
                "pipe_vector.cu", "fused_step.py:160", (path,)),
        })
    # at the full-width band the unpreconditioned pipe names take the
    # whole-iteration entry, so this one runs on the wide band, and on every
    # operator no other kernel step serves: ELL at HPCG's n
    records["fused_pipe_vector_phase" + WIDE] = (
        "pipe_vector.cu", "fused_step.py:76", ("dia_wide_f32",))
    records["fused_pipe_vector_phase" + HPCG_VEC] = (
        "pipe_vector.cu", "fused_step.py:76", ("ell_f32",))
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
        # main_f64 runs pipe_pr_cg's entry eagerly and counts its launches
        # there; no phase captures it in float64
        **{entry + F64_MAIN: ("sym_family.cu", "sym_fused.py:184", ())
           for entry in epilogues},
        **{entry + F64_ELL_POSTHOC: ("ell_spmv.cu", "ell_pallas.py:44",
                                     ("posthoc_f64",))
           for entry in ("ell_spmv", "ell_gather")},
    })
    # bf16 storage: each entry beside the float32 entry on the widened data
    # (f32_ms), on the paths that run it
    bf_sym = ("main_bf16", "cli_bf16")
    records.update({
        "sym_dia_spmv" + BF16: ("sym_dia.cu", "sym_dia.py:47", bf_sym),
        **{entry + BF16: ("sym_family.cu", "sym_fused.py:184",
                          () if entry in no_path else bf_sym)
           for entry in (*FAMILY, *epilogues)},
        "dia_spmv" + BF16: ("dia_spmv.cu", "spmv_pallas.py:58", ("dia_bf16",)),
        "dia_spmv2" + BF16: ("dia_spmv.cu", "spmv_pallas.py:58",
                             ("dia_bf16",)),
        **{entry + BF16: ("dia_family.cu", "fused_step.py:"
                          + ("483" if "_prec" in entry else "329"),
                          ("dia_bf16",)) for entry in DIA_BAND_STEP},
        **{entry + BF16: ("dia_family.cu", "fused_family.py:189",
                          ("dia_bf16",)) for entry in DIA_FAMILY},
        "ell_spmv" + BF16: ("ell_spmv.cu", "ell_pallas.py:44", ("ell_bf16",)),
        "ell_spmv2" + BF16: ("ell_spmv.cu", "ell_pallas.py:44",
                             ("ell_bf16",)),
    })
    # the row partition's shapes (dist_f32): the extended half-band slice,
    # the halo-extended DIA vectors, the vector phases on a shard's rows
    dist = ("dist_f32",)
    records.update({
        "sym_dia_spmv" + DIST: ("sym_dia.cu", "sym_dia.py:47", dist),
        "sym_dia_spmv2" + DIST: ("sym_dia.cu", "sym_dia.py:47", dist),
        "dia_spmv_ext" + DIST: ("dia_spmv.cu", "spmv_pallas.py:58", dist),
        "dia_spmv2_ext" + DIST: ("dia_spmv.cu", "spmv_pallas.py:58", dist),
        "fused_pipe_vector_phase" + DIST: ("pipe_vector.cu",
                                           "fused_step.py:76", dist),
        "fused_pipe_vector_phase_prec" + DIST: ("pipe_vector.cu",
                                                "fused_step.py:160", dist),
    })
    # the rest of the distributed layer: row 9 on a shard's extended words
    # (dist_f32x2), row 12 on a shard's cache (dist_ell_f32 at world size
    # 1: the whole operator, the cache the gathered vector); the shards of
    # 2 and 4 ranks are checked and timed only: no path runs their shapes
    records.update({
        entry + DIST: ("df_spmv.cu", "df_spmv.py:43", ("dist_f32x2",))
        for entry in ("df_dia_spmv_ext", "df_dia_spmv2_ext")})
    for entry in ("ell_spmv_cache", "ell_spmv2_cache"):
        records[entry + DIST] = ("ell_spmv.cu", "ell_pallas.py:44",
                                 ("dist_ell_f32",))
        records.update({
            entry + sfx.format(p, r): ("ell_spmv.cu", "ell_pallas.py:44", ())
            for sfx in (SHARD, AG_SHARD) for p, r in ELL_SHARDS})
    # the gather in of the row context's product in its locality order
    records["ell_gather" + DIST] = ("ell_spmv.cu", "ell_pallas.py:44",
                                    ("dist_ell_f32",))
    kernels = []
    for name, (source, replaces, paths) in records.items():
        t = timings[name]
        entry = name.split(" (")[0]
        extra = {key: t[key] for key in ("f64_counterpart_ms",
                                         "f64_counterpart", "bound_bytes_ms",
                                         "bound_ops_ms", "L", "library",
                                         "given_order", "locality_order",
                                         "ms_2rhs",
                                         "launches_per_call", "f32_ms",
                                         "cache", "columns",
                                         "torch_epilogue_ms", "ms_in_turns")
                 if key in t}
        if name.endswith(BF16):
            extra["storage"] = "bf16 band / values, float32 vectors"
            extra["share_of_bound"] = t["bound_ms"] / t["ms"]
        if name + NATURAL in timings:
            extra["natural_order"] = {
                key: timings[name + NATURAL][key]
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        gpaths = sorted({g for p in paths for g in GRAPH_PATHS.get(p, ())})
        if any(p + MESH in launches for p in paths):
            extra["mesh_graph_launches"] = sum(
                launches.get(p + MESH, {}).get(entry, 0) for p in paths)
        kernels.append(dict(
            name=name, route="cuda",
            source="new_cg_variants_tpu_torch/csrc/" + source,
            replaces=jax_ops + replaces, n=t["n"], paths=list(paths),
            launches=sum(launches[p].get(entry, 0) for p in paths),
            graph_paths=gpaths,
            graph_launches=sum(launches[g].get(entry, 0) for g in gpaths),
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
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        witness = pool.submit(build_ell_witness)  # beside the package's
        paths = _kernels.build()
        ELL_WITNESS.update(witness.result())
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(str(p.name) for p in paths.values()),
         witness=sorted(ELL_WITNESS))
    for p in paths.values():
        log = p.with_suffix(".log").read_text()
        print("\n".join(ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling" in ln),
              file=sys.stderr)

    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)
    install_graph_counts()

    # built: what a phase makes for a later one (ell_f32's operator)
    timings, launches, built = {}, {}, {}

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
    phase("jit_main_f32", jit_main_f32, torch, card, timings)
    phase("main_f64", main_path_f64, torch)
    phase("variants_f32", variants_f32, torch)
    phase("jit_variants_f32", jit_variants_f32, torch, card)
    phase("jit_solve", jit_solve, torch, card)
    phase("variants_f64", variants_f64, torch)
    phase("dia_f32", dia_path_f32, torch, timings)
    phase("dia_wide_f32", dia_wide_f32, torch)
    phase("jit_dia_f32", jit_dia_f32, torch, card, timings)
    phase("jit_dia_wide_f32", jit_dia_wide_f32, torch)
    phase("dia_f64", dia_f64, torch)
    phase("df_f32x2", df_f32x2, torch, built)
    phase("df_dense_f32x2", df_dense_f32x2, torch, built)
    phase("jit_f32x2", jit_f32x2, torch, card, built, timings)
    phase("jit_df_dense", jit_df_dense, torch, built)
    phase("df_card_vs_cpu", df_card_vs_cpu, torch)
    phase("df_accuracy", df_accuracy, torch)
    phase("check_ell", check_ell, torch, card, timings)
    phase("check_bf16", check_bf16, torch, card, timings)
    phase("ell_f32", ell_f32, torch, built)
    phase("jit_ell_f32", jit_ell_f32, torch, card, built, timings)
    phase("ell_bf16", ell_bf16, torch, built)
    phase("main_bf16", main_bf16, torch, timings)
    phase("dia_bf16", dia_bf16, torch)
    phase("jit_bf16", jit_bf16, torch, card, built, timings)
    phase("bf16_accuracy", bf16_accuracy, torch)
    phase("formats_f32", formats_f32, torch, built)
    phase("sparse_f64", sparse_f64, torch)
    phase("convergence_f64", convergence_f64, torch, card, timings, launches)
    phase("jit_convergence_f64", jit_convergence_f64, torch)
    phase("cli_f32", cli_f32, torch, timings, launches)
    phase("trace_f32", trace_f32, torch, launches)
    phase("check_dist", check_dist, torch, card, timings)
    phase("capture_dist", capture_dist, torch, built)
    with dist_world() as mesh:
        phase("dist_f32", dist_f32, torch, mesh, timings)
        phase("dist_f64", dist_f64, torch, mesh)
        phase("dist_ell_f32", dist_ell_f32, torch, mesh, built)
        phase("dist_f32x2", dist_f32x2, torch, mesh)
        phase("dist_formats_f32", dist_formats_f32, torch, mesh, built)
        phase("dist_scaling", dist_scaling, torch, mesh, built)
    launches.update({p + MESH: v for p, v in MESH_GRAPHS.items()})

    kernels = kernel_records(timings, launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    unlaunched = [k["name"] for k in kernels
                  if k["paths"] and k["launches"] < 1]
    if unlaunched:
        raise AssertionError(f"no launch on its driven path: {unlaunched}")
    # the mesh paths' loops replay rows 1, 3, 4, 5, 9 and 12 (ell_gather,
    # the change of basis, runs outside the loop)
    uncaptured = [k["name"] for k in kernels
                  if k["paths"] and k["graph_launches"] < 1
                  or k.get("mesh_graph_launches", 1) < 1
                  and not k["name"].startswith("ell_gather")]
    if uncaptured:
        raise AssertionError(f"no launch inside a graph: {uncaptured}")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
