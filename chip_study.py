#!/usr/bin/env python3
"""Studies of the port's CUDA kernels on one NVIDIA GPU, beside chip_smoke.py.

    python3 chip_study.py check     # build, registers per kernel, check_dia
    python3 chip_study.py dfcheck   # build, registers, the double-word checks
    python3 chip_study.py symcheck  # build, registers, the half-band checks
    python3 chip_study.py symopts   # rows 1 and 2's design options in turns
    python3 chip_study.py ellcheck  # build, registers, check_ell (timed)
    python3 chip_study.py bf16check # build, registers, check_bf16 (timed)
    python3 chip_study.py ellopts   # row 12's design options, timed in turns
    python3 chip_study.py denseopts # row 10's dense design options, the same
    python3 chip_study.py pipeopts  # row 11's design options, the same
    python3 chip_study.py mutants   # do the checks catch a faulty kernel?
                                    # (mutants dia|sym|df|ell|bf16: one
                                    # family)
    python3 chip_study.py bounds    # launch bounds, timed in turns
    python3 chip_study.py halo      # whole-iteration kernel against the split
                                    # formulation as the band widens
    python3 chip_study.py floors    # convergence rows, card against CPU, at
                                    # the rounding floor on three matrices
    python3 chip_study.py distcheck # the row-partitioned distributed layer:
                                    # check_dist, dist_f32, dist_f64

Each study edits throw-away copies of ``new_cg_variants_tpu_torch/csrc`` in a
temporary directory (the sources in the checkout are never touched), builds
them with the port's own build (``_kernels.build(csrc=...)``), and runs them
through the port's own wrappers and ``chip_smoke.py``'s checks
(``_kernels.using``).  Every line printed is JSON; the numbers quoted in
PERF.md come from these lines.  Needs a CUDA device and ``nvcc``; exits
nonzero without them.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke as cs

#: this tree's kernel sources (what every study copies, whatever is bound)
CSRC = Path(__file__).resolve().parent / "new_cg_variants_tpu_torch" / "csrc"

#: faults a check must catch: what -> (source, text, replacement); every one
#: keeps its reads inside the kernel's buffers
MUTANTS = {
    "offset sign flipped (SpMV)": (
        "dia_spmv.cu", "x0 = sv0[c + off];",
        "x0 = sv0[max(0, min(vw - 1, c - off))];"),
    "diagonal d read at the offset of d - 1 (SpMV)": (
        "dia_spmv.cu", "const int off = soff[d];",
        "const int off = soff[d == 0 ? 0 : d - 1];"),
    "last diagonal dropped (SpMV)": (
        "dia_spmv.cu", "for (int d = 0; d < ndiag; ++d) {",
        "for (int d = 0; d < ndiag - 1; ++d) {"),
    "window staged one row off (SpMV)": (
        "dia_spmv.cu", "const long long g = i0 - h_lo + j + vorg;",
        "const long long g = i0 - h_lo + j + vorg + 1;"),
    "direct read ignores the vector's origin (SpMV)": (
        "dia_spmv.cu", "const long long g = i + off + vorg;",
        "const long long g = i + off;"),
    "halo rows left zero (full step)": (
        "family_specs.cuh",
        "if (g >= 0 && g < n) S::update(a, sc, g, idx < kTile, keep, mv);",
        "if (g >= 0 && g < n && idx < kTile) "
        "S::update(a, sc, g, true, keep, mv);"),
    "offset sign flipped (full step)": (
        "dia_family.cu", "const int j = c + soff[d];",
        "const int j = max(0, min(vw - 1, c - soff[d]));"),
    "beta p dropped from p2 (vector phase)": (
        "pipe_vector.cu", "const T p2 = r2 + beta * pv;", "const T p2 = r2;"),
    "wt2 formed from w (vector phase, prec)": (
        "pipe_vector.cu",
        "const T wt2 = __ldg(a.in[8] + i) - a1 * __ldg(a.in[9] + i);",
        "const T wt2 = __ldg(a.in[2] + i) - a1 * __ldg(a.in[9] + i);"),
}

#: faults of the half-band kernels (rows 1, 2 and 2b), held to chip_smoke.py's
#: half-band checks
SYM_MUTANTS = {
    "mirror term dropped (half-band)": (
        "sym_common.cuh", "        acc[r][k] += am * smv[k * vw + c - off];\n",
        "        (void)am;\n"),
    "mirror term read at row i + off (half-band)": (
        "sym_common.cuh",
        "const T am = (i < n && i >= off) ? widen(__ldg(row + i - off)) : T(0);",
        "const T am = (i + off < n) ? widen(__ldg(row + i + off)) : T(0);"),
    "diagonal d read at the offset of d - 1 (half-band)": (
        "sym_common.cuh", "    const int off = soff[d];\n    const D* row",
        "    const int off = soff[d - 1];\n    const D* row"),
    "halo rows of the SpMV input left zero (half-band step)": (
        "sym_family.cu",
        "if (g >= 0 && g < n) S::update(a, sc, g, owned, kept, mv);",
        "if (g >= 0 && g < n && owned) S::update(a, sc, g, owned, kept, mv);"),
}

#: faults of the double-word kernels (rows 9-11), held to chip_smoke.py's
#: double-word checks
DF_MUTANTS = {
    "contraction on: plain operators for the intrinsics (all three rows)": (
        "df_common.cuh",
        "__device__ __forceinline__ float rn_add(float a, float b) "
        "{ return __fadd_rn(a, b); }\n"
        "__device__ __forceinline__ float rn_sub(float a, float b) "
        "{ return __fsub_rn(a, b); }\n"
        "__device__ __forceinline__ float rn_mul(float a, float b) "
        "{ return __fmul_rn(a, b); }",
        "__device__ __forceinline__ float rn_add(float a, float b) "
        "{ return a + b; }\n"
        "__device__ __forceinline__ float rn_sub(float a, float b) "
        "{ return a - b; }\n"
        "__device__ __forceinline__ float rn_mul(float a, float b) "
        "{ return a * b; }"),
    "lo2 vh dropped (products)": (
        "df_common.cuh", "      rn_mul(al2, vh));", "      0.0f);"),
    "v.lo ignored (products)": (
        "df_common.cuh",
        "rn_add(rn_mul(a, vl), rn_mul(al, vh)), rn_mul(al, vl))",
        "rn_add(0.0f, rn_mul(al, vh)), 0.0f)"),
    "sloppy df_add, one 2Sum (all three rows)": (
        "df_common.cuh",
        "  const Pair t = two_sum(a.lo, b.lo);\n"
        "  const Pair u = fast_two_sum(s.hi, rn_add(s.lo, t.hi));\n"
        "  return fast_two_sum(u.hi, rn_add(u.lo, t.lo));",
        "  return fast_two_sum(s.hi, rn_add(s.lo, rn_add(a.lo, b.lo)));"),
    "power-of-two-only combine (vector phase)": (
        "df_pipe.cu", "const long long width = pow2_ceil(ntiles);",
        "const long long width = ntiles;"),
    "ticket counter not reset (vector phase)": (
        "df_pipe.cu",
        "    last = atomicInc(tickets, gridDim.x - 1) == gridDim.x - 1;\n",
        "    last = atomicAdd(tickets, 1u) == gridDim.x - 1;\n"),
    "last block sums partials in arrival order (vector phase)": (
        "df_pipe.cu",
        "  if (threadIdx.x == 0) {\n"
        "#pragma unroll\n"
        "    for (int d = 0; d < 4; ++d) {\n"
        "      partials[(2 * d) * parts + g] = group[d].hi;\n"
        "      partials[(2 * d + 1) * parts + g] = group[d].lo;\n"
        "    }\n"
        "    // the partials reach device memory before the block draws its "
        "ticket,\n"
        "    // so the block that draws the last one sees them all\n"
        "    __threadfence();\n"
        "    last = atomicInc(tickets, gridDim.x - 1) == gridDim.x - 1;\n",
        # each block draws a slot (the counter's low half) and its partial
        # goes there; a second ticket (the high half) finds the last block,
        # which clears both halves
        "  if (threadIdx.x == 0) {\n"
        "    const unsigned slot = atomicAdd(tickets, 1u) & 0xffffu;\n"
        "#pragma unroll\n"
        "    for (int d = 0; d < 4; ++d) {\n"
        "      partials[(2 * d) * parts + slot] = group[d].hi;\n"
        "      partials[(2 * d + 1) * parts + slot] = group[d].lo;\n"
        "    }\n"
        "    __threadfence();\n"
        "    last = atomicAdd(tickets, 1u << 16) >> 16 == gridDim.x - 1;\n"
        "    if (last) *tickets = 0;\n"),
    "dense tree pairs neighbours instead of halves (dense)": (
        "df_common.cuh", "for (int off = lanes >> 1; off > 0; off >>= 1) {",
        "for (int off = 1; off < lanes; off <<= 1) {"),
}

#: faults of the ELL kernel (row 12), held to chip_smoke.py's check_ell
ELL_MUTANTS = {
    "last slot dropped (ELL)": (
        "ell_spmv.cu", "for (int l = 0; l < L; ++l) {",
        "for (int l = 0; l < L - 1; ++l) {"),
    "v[i] read in place of v[idx] (ELL)": (
        "ell_spmv.cu", "const int j = stream(c + o);", "const int j = (int)i;"),
    "scatter-out skips the permutation (ELL)": (
        "ell_spmv.cu",
        "const long long out = PERM ? (long long)stream(perm + i) : i;",
        "const long long out = i;"),
}

#: faults of the bf16-storage entries (rows 1-3, 6-8, 12), held to
#: chip_smoke.py's check_bf16: the half-band and ELL faults above as the bf16
#: entries take them, and a widening that reads the stored bits wrong
BF16_MUTANTS = {
    "mirror term dropped (half-band, bf16 checks)":
        SYM_MUTANTS["mirror term dropped (half-band)"],
    "last slot dropped (ELL, bf16 checks)":
        ELL_MUTANTS["last slot dropped (ELL)"],
    "bf16 value read as the low half of a float32 (every bf16 entry)": (
        "storage.cuh", "  return __bfloat162float(x);",
        "  return __uint_as_float(__bfloat16_as_ushort(x));"),
}

#: design options of row 12, each timed against the committed source in
#: turns (``ellopts``): what -> edits
ELL_OPTIONS = {
    "val / idx / perm through __ldg (no evict-first)": [
        ("ell_spmv.cu", "  return __ldcs(p);", "  return __ldg(p);")],
    "2 RHS in a locality order gathered interleaved (one load of both)": [
        ("ell_spmv.cu",
         "    acc0 = fma(x, __ldg(v0 + j), acc0);\n"
         "    if constexpr (NRHS == 2) acc1 = fma(x, __ldg(v1 + j), acc1);\n",
         "    if constexpr (PERM && NRHS == 2) {\n"
         "      if constexpr (sizeof(T) == 4) {\n"
         "        const float2 g = __ldg(reinterpret_cast<const float2*>(v0) + j);\n"
         "        acc0 = fma(x, T(g.x), acc0);\n"
         "        acc1 = fma(x, T(g.y), acc1);\n"
         "      } else {\n"
         "        const double2 g =\n"
         "            __ldg(reinterpret_cast<const double2*>(v0) + j);\n"
         "        acc0 = fma(x, T(g.x), acc0);\n"
         "        acc1 = fma(x, T(g.y), acc1);\n"
         "      }\n"
         "    } else {\n"
         "      acc0 = fma(x, __ldg(v0 + j), acc0);\n"
         "      if constexpr (NRHS == 2) acc1 = fma(x, __ldg(v1 + j), acc1);\n"
         "    }\n"),
        ("ell_spmv.cu",
         "  xs[i] = __ldg(v0 + p);\n"
         "  if constexpr (NRHS == 2) xs[n + i] = __ldg(v1 + p);\n",
         "  if constexpr (NRHS == 2) {\n"
         "    xs[2 * i] = __ldg(v0 + p);\n"
         "    xs[2 * i + 1] = __ldg(v1 + p);\n"
         "  } else {\n"
         "    xs[i] = __ldg(v0 + p);\n"
         "  }\n"),
        ("ell_spmv.cu",
         "  const T* x1 = p ? x0 + n : static_cast<const T*>(v1);",
         "  const T* x1 = p ? nullptr : static_cast<const T*>(v1);")],
    "128 rows per block": [
        ("ell_spmv.cu", "constexpr int kEllThreads = 256;",
         "constexpr int kEllThreads = 128;")],
    "512 rows per block": [
        ("ell_spmv.cu", "constexpr int kEllThreads = 256;",
         "constexpr int kEllThreads = 512;")],
}

#: design options of row 10's dense product (``denseopts``)
_DENSE_KNOBS = {
    "warps": ("df_spmv.cu", "constexpr int kDenseWarps = 32;",
              "constexpr int kDenseWarps = {};"),
    "lg": ("df_spmv.cu", "constexpr int kDenseLG = 2;",
           "constexpr int kDenseLG = {};"),
    "maxd": ("df_spmv.cu", "constexpr int kDenseMaxD = 12;",
             "constexpr int kDenseMaxD = {};"),
}


def dense_knobs(**knobs):
    """Edits that set the dense product's design constants."""
    return [(src, text, repl.format(v)) for k, v in knobs.items()
            for src, text, repl in [_DENSE_KNOBS[k]]]


#: the vector through L1 at every n (no staged copy, not persistent)
DENSE_UNSTAGED = [
    ("df_spmv.cu",
     "  const bool stage =\n"
     "      size_t(2 * NRHS) * size_t(n) * sizeof(float) <= kMaxBlockSmem;\n",
     "  const bool stage = false;\n")]


def dense_ring(stages=4, stage=True):
    """Edits that bring the matrix words of the dense product in by bulk
    copies (cp.async.bulk, completion counted on an mbarrier) through a ring
    of ``stages`` shared-memory stages per warp, one group of leaves a
    stage: lane 3 j + w copies word w of the group's leaf j (a 128-byte
    chunk; the chunks of a group lie width / 4 columns apart).  Rows must
    start on 16-byte boundaries (n a multiple of 4), else the lanes load as
    committed; the blocks are persistent and each warp's ring runs on over
    its rows.  ``stage``: the vector staged where it fits beside the
    rings."""
    helpers = r"""
namespace ncgv {

constexpr int kRingStages = STAGES;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ unsigned chunk_bytes(long long c0, long long n) {
  return c0 < n ? unsigned(4 * (n - c0 < 32 ? n - c0 : 32)) : 0u;
}

}  // namespace ncgv
""".replace("STAGES", str(stages))
    setup = r"""    __syncthreads();
  }
  __shared__ unsigned long long sbar[WARPS * kRingStages];
  const int warp = threadIdx.x >> 5;
  const int count = width < 32 ? 1 : width / 32;
  const int depth = 31 - __clz(count);
  const int groups = count >> LG;
  float* ring = swin + (STAGE_V ? 2 * NRHS * n : 0) +
                warp * kRingStages * ((3 * 32) << LG);
  unsigned long long* bar = sbar + warp * kRingStages;
  const bool ring_ok =
      LG > 0 && n % 4 == 0 &&
      ((reinterpret_cast<size_t>(hi) | reinterpret_cast<size_t>(lo) |
        reinterpret_cast<size_t>(lo2)) & 15) == 0;
  if (ring_ok && lane == 0) {
    for (int st = 0; st < kRingStages; ++st) mbar_init(bar + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long s) {
    if (s >= rows * groups) return;
    const long long row = first + (s / groups) * stride;
    const int g = int(s % groups);
    const int st = int(s % kRingStages);
    if (lane == 0) {
      unsigned total = 0;
      for (int j = 0; j < G; ++j)
        total += chunk_bytes(32LL * leaf_chunk((g << LG) + j, depth), n);
      mbar_expect_tx(bar + st, 3 * total);
    }
    if (lane < 3 * G) {
      const int j = lane / 3, w = lane % 3;
      const long long c0 = 32LL * leaf_chunk((g << LG) + j, depth);
      const unsigned bytes = chunk_bytes(c0, n);
      const float* src = w == 0 ? hi : w == 1 ? lo : lo2;
      if (bytes)
        bulk_copy(ring + st * ((3 * 32) << LG) + (3 * j + w) * 32,
                  src + row * n + c0, bytes, bar + st);
    }
  };
  if (ring_ok) {
    for (int s = 0; s < kRingStages; ++s) issue(s);
  }
"""
    fetch = r"""    auto fetch = [&](int g, const int (&cols)[G],
                     DenseWords (&cur)[G]) {
      if (ring_ok) {
        const long long s = ri * groups + g;
        const int st = int(s % kRingStages);
        mbar_wait(bar + st, unsigned(s / kRingStages) & 1u);
        const float* src = ring + st * ((3 * 32) << LG) + lane;
        for (int j = 0; j < G; ++j)
          cur[j] = DenseWords{src[(3 * j) * 32], src[(3 * j + 1) * 32],
                              src[(3 * j + 2) * 32]};
        __syncwarp();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(s + kRingStages);
        return;
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
"""
    ring_bytes = ("(LG > 0 ? size_t(WARPS) * kRingStages * ((3 * 32) << LG)"
                  " * sizeof(float) : 0)")
    return [
        ("df_spmv.cu", '#include "df_common.cuh"\n',
         '#include "df_common.cuh"\n' + helpers),
        ("df_common.cuh", "    fetch(cols, cur);\n",
         "    fetch(g, cols, cur);\n"),
        ("df_spmv.cu", "    __syncthreads();\n  }\n\n  for (long long ri = 0;",
         setup + "\n  for (long long ri = 0;"),
        ("df_spmv.cu",
         "    auto fetch = [&](const int (&cols)[G], DenseWords (&cur)[G]) {\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < G; ++j) {\n", fetch),
        ("df_spmv.cu",
         "  const size_t smem = STAGE_V ? size_t(2 * NRHS) * size_t(n) * "
         "sizeof(float)\n                              : 0;\n",
         "  const size_t smem =\n      (STAGE_V ? size_t(2 * NRHS) * "
         "size_t(n) * sizeof(float) : 0) +\n      " + ring_bytes + ";\n"),
        ("df_spmv.cu", DENSE_UNSTAGED[0][1],
         "  const bool stage =\n"
         "      size_t(2 * NRHS) * size_t(n) * sizeof(float) +\n"
         "          size_t(W) * kRingStages * ((3 * 32) << LG) *\n"
         "              sizeof(float) <=\n"
         "      kMaxBlockSmem;\n") if stage else DENSE_UNSTAGED[0],
    ]


DENSE_OPTIONS = {
    "vector through L1, not staged, 4 rows per block (not persistent)":
        DENSE_UNSTAGED + dense_knobs(warps=4),
    "vector through L1, not staged, 32 rows per block (not persistent)":
        DENSE_UNSTAGED,
    "vector staged, 16 rows per block": dense_knobs(warps=16),
    "vector staged, 8 rows per block": dense_knobs(warps=8),
    "matrix words through a ring of 4 bulk-copy stages per warp, 8 rows "
    "per block": dense_ring() + dense_knobs(warps=8),
    "ring of 2 stages, 8 rows per block": dense_ring(2) + dense_knobs(warps=8),
    "ring, vector not staged, 4 rows per block": (
        dense_ring(stage=False) + dense_knobs(warps=4)),
    "the next group's loads issued ahead of this group's arithmetic": [
        ("df_common.cuh",
         "  Pair slot[NR][MAXD];\n"
         "  for (int g = 0; g < groups; ++g) {\n"
         "    int cols[G];\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < G; ++j)\n"
         "      cols[j] = lane + 32 * leaf_chunk((g << LG) + j, depth);\n"
         "    Words cur[G];\n"
         "    fetch(cols, cur);\n",
         "  Pair slot[NR][MAXD];\n"
         "  Words next[G];\n"
         "  {\n"
         "    int cols[G];\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < G; ++j)\n"
         "      cols[j] = lane + 32 * leaf_chunk(j, depth);\n"
         "    fetch(cols, next);\n"
         "  }\n"
         "  for (int g = 0; g < groups; ++g) {\n"
         "    int cols[G], ncols[G];\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < G; ++j) {\n"
         "      cols[j] = lane + 32 * leaf_chunk((g << LG) + j, depth);\n"
         "      ncols[j] = lane + 32 * leaf_chunk(((g + 1) << LG) + j, depth);\n"
         "    }\n"
         "    Words cur[G];\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < G; ++j) cur[j] = next[j];\n"
         "    if (g + 1 < groups) fetch(ncols, next);\n")],
    "group counter as a predicated chain (no branch)": [
        ("df_common.cuh",
         "#pragma unroll 1\n"
         "      for (int l = 0; l < tz; ++l) carry = df_add(slot[r][l], carry);\n"
         "      slot[r][tz] = carry;\n",
         "#pragma unroll\n"
         "      for (int l = 0; l < MAXD; ++l) {\n"
         "        if (l < tz) {\n"
         "          carry = df_add(slot[r][l], carry);\n"
         "        } else if (l == tz) {\n"
         "          slot[r][l] = carry;\n"
         "        }\n"
         "      }\n")],
    "matrix words through __ldg (no evict-first)": [
        ("df_spmv.cu", f"__ldcs({w} + base + c)", f"__ldg({w} + base + c)")
        for w in ("hi", "lo", "lo2")],
    "at least 2 blocks of 32 rows per SM (32 registers)": [
        ("df_spmv.cu",
         "__global__ void __launch_bounds__(WARPS * 32) df_dense_kernel(",
         "__global__ void __launch_bounds__(WARPS * 32, 2) "
         "df_dense_kernel(")],
    "groups of 2 leaves": dense_knobs(lg=1, maxd=13),
    "groups of 8 leaves": dense_knobs(lg=3),
}


#: row 11 as PR 4 built it (option (a) of ``pipeopts``): a pass that leaves
#: one partial per 256-row tile, then a second launch, one block, that sums
#: them by a predicated in-thread counter and a shared-memory tree; the same
#: trees, so the same bits.  Its entry point takes the ticket counter and
#: leaves it alone.
PR4_PIPE = r"""#include "df_common.cuh"

namespace ncgv {

constexpr int kPipeIn = 12;
constexpr int kPipeOut = 10;

struct DfPipeArgs {
  const float* in[kPipeIn];
  float* out[kPipeOut];
  const float* sc[4];
};

__device__ __forceinline__ Pair load(const float* const* w, int k,
                                     long long i) {
  return {__ldg(w[2 * k] + i), __ldg(w[2 * k + 1] + i)};
}

__device__ __forceinline__ void store(float* const* w, int k, long long i,
                                      Pair v) {
  w[2 * k][i] = v.hi;
  w[2 * k + 1][i] = v.lo;
}

template <int NR>
__device__ __forceinline__ void pr4_block_tree_sum(const Pair (&v)[NR],
                                                   int width, Pair* sred,
                                                   Pair (&out)[NR]) {
  const int t = threadIdx.x;
  const int bd = blockDim.x;
  if (t < width) {
#pragma unroll
    for (int r = 0; r < NR; ++r) sred[r * bd + t] = v[r];
  }
  __syncthreads();
  for (int w = width; w > 1; w >>= 1) {
    const int half = w >> 1;
    if (t < half) {
#pragma unroll
      for (int r = 0; r < NR; ++r)
        sred[r * bd + t] = df_add(sred[r * bd + t], sred[r * bd + t + half]);
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < NR; ++r) out[r] = sred[r * bd];
  }
}

template <int NR, typename Leaf>
__device__ __forceinline__ void pr4_tree_sum(int width, const Leaf& leaf,
                                             Pair* sred, Pair (&out)[NR]) {
  const int t = threadIdx.x;
  const int teff = width < int(blockDim.x) ? width : int(blockDim.x);
  const int count = width / teff;
  const int depth = 31 - __clz(count);
  Pair total[NR];
  if (t < teff) {
    Pair slot[NR][kMaxTreeDepth + 1];
    for (int m = 0; m < count; ++m) {
      const int k = depth ? int(__brev(unsigned(m)) >> (32 - depth)) : 0;
      const int tz = __ffs(~m) - 1;
      Pair vals[NR];
      leaf(t + k * teff, vals);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        Pair carry = vals[r];
#pragma unroll
        for (int l = 0; l <= kMaxTreeDepth; ++l) {
          if (l < tz) {
            carry = df_add(slot[r][l], carry);
          } else if (l == tz) {
            slot[r][l] = carry;
          }
        }
      }
    }
#pragma unroll
    for (int l = 0; l <= kMaxTreeDepth; ++l) {
      if (l == depth) {
#pragma unroll
        for (int r = 0; r < NR; ++r) total[r] = slot[r][l];
      }
    }
  }
  pr4_block_tree_sum<NR>(total, teff, sred, out);
}

__global__ void __launch_bounds__(kTile) df_pipe_kernel(
    long long n, const __grid_constant__ DfPipeArgs a,
    float* __restrict__ partials, int nblocks) {
  __shared__ Pair sred[4 * kTile];
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  Pair terms[4] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  if (i < n) {
    const Pair a1 = {*a.sc[0], *a.sc[1]};
    const Pair beta = {*a.sc[2], *a.sc[3]};
    const Pair p = load(a.in, 4, i), s = load(a.in, 5, i);
    const Pair x2 = df_add(load(a.in, 0, i), df_mul(a1, p));
    const Pair r2 = df_add(load(a.in, 1, i), df_neg(df_mul(a1, s)));
    const Pair w2 = df_add(load(a.in, 2, i), df_neg(df_mul(a1, load(a.in, 3, i))));
    const Pair p2 = df_add(r2, df_mul(beta, p));
    const Pair s2 = df_add(w2, df_mul(beta, s));
    store(a.out, 0, i, x2);
    store(a.out, 1, i, r2);
    store(a.out, 2, i, w2);
    store(a.out, 3, i, p2);
    store(a.out, 4, i, s2);
    terms[0] = dot_term(p2, s2);
    terms[1] = dot_term(r2, s2);
    terms[2] = dot_term(s2, s2);
    terms[3] = dot_term(r2, r2);
  }
  Pair sums[4];
  pr4_block_tree_sum<4>(terms, kTile, sred, sums);
  if (threadIdx.x == 0) {
    for (int d = 0; d < 4; ++d) {
      partials[(2 * d) * (long long)nblocks + blockIdx.x] = sums[d].hi;
      partials[(2 * d + 1) * (long long)nblocks + blockIdx.x] = sums[d].lo;
    }
  }
}

__global__ void __launch_bounds__(kTile) df_pipe_combine_kernel(
    const float* __restrict__ partials, int nblocks, int width,
    float* __restrict__ dots) {
  __shared__ Pair sred[4 * kTile];
  auto leaf = [&](int c, Pair (&vals)[4]) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      vals[d] = c < nblocks
                    ? Pair{partials[(2 * d) * (long long)nblocks + c],
                           partials[(2 * d + 1) * (long long)nblocks + c]}
                    : Pair{0.0f, 0.0f};
    }
  };
  Pair sums[4];
  pr4_tree_sum<4>(width, leaf, sred, sums);
  if (threadIdx.x == 0) {
    for (int d = 0; d < 4; ++d) {
      dots[2 * d] = sums[d].hi;
      dots[2 * d + 1] = sums[d].lo;
    }
  }
}

}  // namespace ncgv

extern "C" {

int df_pipe_f32(long long n, const void* const* in, int nin,
                const void* const* sc, int nsc, void* const* out, int nout,
                void* partials, void* dots, void* tickets, int device,
                void* stream) {
  using namespace ncgv;
  (void)tickets;
  if (n <= 0 || nin != kPipeIn || nout != kPipeOut || nsc != 4)
    return int(cudaErrorInvalidValue);
  const long long nb = (n + kTile - 1) / kTile;
  const long long width = pow2_ceil(nb);
  if (width > ((long long)kTile << kMaxTreeDepth))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  DfPipeArgs a = {};
  for (int k = 0; k < kPipeIn; ++k) a.in[k] = static_cast<const float*>(in[k]);
  for (int k = 0; k < kPipeOut; ++k) a.out[k] = static_cast<float*>(out[k]);
  for (int k = 0; k < 4; ++k) a.sc[k] = static_cast<const float*>(sc[k]);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  df_pipe_kernel<<<unsigned(nb), kTile, 0, st>>>(n, a, part, int(nb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  df_pipe_combine_kernel<<<1, kTile, 0, st>>>(part, int(nb), int(width),
                                              static_cast<float*>(dots));
  return int(cudaGetLastError());
}

}  // extern "C"
"""

def pipe_min_blocks(blocks):
    """Row 11's kernel held to at least ``blocks`` resident blocks an SM."""
    return [("df_pipe.cu", "constexpr int kPipeMinBlocks = 4;",
             f"constexpr int kPipeMinBlocks = {blocks};")]


#: the end of the pass after the partials: fence, ticket, the last block's
#: test
PIPE_TICKET = ("    __threadfence();\n"
               "    last = atomicInc(tickets, gridDim.x - 1) == gridDim.x - 1;\n"
               "    __threadfence();\n"
               "  }\n"
               "  __syncthreads();\n"
               "  if (!last) return;\n")

#: option (f) of row 11: a grid of as many blocks as fit at once, each
#: walking the groups of tiles blockIdx.x, blockIdx.x + gridDim.x, ... (the
#: partials stay one per group, so the bits do too)
PIPE_PERSISTENT = [
    ("df_pipe.cu", "  const int g = blockIdx.x, parts = gridDim.x;\n",
     "  for (int g = blockIdx.x; g < parts; g += gridDim.x) {\n"),
    ("df_pipe.cu", "    long long n, const __grid_constant__ DfPipeArgs a,\n"
     "    float* __restrict__ partials, long long ntiles, int width,\n",
     "    long long n, const __grid_constant__ DfPipeArgs a,\n"
     "    float* __restrict__ partials, long long ntiles, int parts,\n"
     "    int width,\n"),
    ("df_pipe.cu", "    // the partials reach device memory before the block draws "
     "its ticket,\n",
     "  }\n  __syncthreads();\n  }\n  if (threadIdx.x == 0) {\n"),
    ("df_pipe.cu", "  kernel<<<unsigned(parts), kPipeThreads, 0, "
     "static_cast<cudaStream_t>(stream)>>>(\n"
     "      n, a, static_cast<float*>(partials), ntiles,\n",
     "  long long grid = parts;\n"
     "  int sms = 0, per_sm = 0;\n"
     "  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,"
     " device);\n"
     "  if (err != cudaSuccess) return int(err);\n"
     "  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
     "      &per_sm, df_pipe_kernel<true>, kPipeThreads, 0);\n"
     "  if (err != cudaSuccess) return int(err);\n"
     "  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;\n"
     "  kernel<<<unsigned(grid), kPipeThreads, 0, "
     "static_cast<cudaStream_t>(stream)>>>(\n"
     "      n, a, static_cast<float*>(partials), ntiles, int(parts),\n"),
]

#: design options of row 11 (``pipeopts``), each timed against the committed
#: source in turns; (a), the PR 4 design, replaces the whole file.  The
#: committed kernel is (b), the last-block combine, with (d) taken to eight
#: rows a lane (a warp a tile) from 1024 tiles, and (e); (f) is an option
#: of it.  (c), 1024-thread blocks, was timed on the first one-launch build,
#: a block a tile (PERF.md, Findings PR 8).
PIPE_OPTIONS = {
    "(a) PR 4 design: pass + one-block combine, two launches": [
        ("df_pipe.cu", None, PR4_PIPE)],
    "one warp a tile at every n": [
        ("df_pipe.cu", "constexpr long long kWarpTiles = 1024;",
         "constexpr long long kWarpTiles = 1;")],
    "a block a tile at every n": [
        ("df_pipe.cu", "constexpr long long kWarpTiles = 1024;",
         "constexpr long long kWarpTiles = 1LL << 40;")],
    "(e) off: input words through __ldg": [
        ("df_pipe.cu", "__device__ __forceinline__ float stream("
         "const float* p) { return __ldcs(p); }",
         "__device__ __forceinline__ float stream(const float* p) "
         "{ return __ldg(p); }")],
    "(f) persistent grid, as many blocks as fit": PIPE_PERSISTENT,
    "outputs evict-first (__stcs)": [
        ("df_pipe.cu", "  w[2 * k][i] = v.hi;\n  w[2 * k + 1][i] = v.lo;\n",
         "  __stcs(w[2 * k] + i, v.hi);\n  __stcs(w[2 * k + 1] + i, v.lo);\n")],
    "no minimum of blocks an SM (registers as the compiler chooses)": [
        ("df_pipe.cu", "__launch_bounds__(kPipeThreads, kPipeMinBlocks)",
         "__launch_bounds__(kPipeThreads)")],
    "at least 3 blocks an SM": pipe_min_blocks(3),
    "at least 5 blocks an SM": pipe_min_blocks(5),
    "four sums through every shuffle level (no split over the lanes)": [
        ("df_pipe.cu", "  warp_tree_sum4(sums);\n",
         "  for (int off = 16; off > 0; off >>= 1) {\n"
         "#pragma unroll\n"
         "    for (int d = 0; d < 4; ++d)\n"
         "      sums[d] = df_add(sums[d], shfl_down(sums[d], off));\n"
         "  }\n"
         "#pragma unroll\n"
         "  for (int d = 0; d < 4; ++d)\n"
         "    sums[d] = {__shfl_sync(0xffffffffu, sums[d].hi, 0),\n"
         "               __shfl_sync(0xffffffffu, sums[d].lo, 0)};\n"),
        ("df_common.cuh", "  if constexpr (NR == 4) {",
         "  if constexpr (NR == 0) {")],
    "combine counter predicated (unrolled, as PR 4)": [
        ("df_common.cuh",
         "#pragma unroll 1\n"
         "        for (int l = 0; l < tz; ++l) carry = df_add(slot[r][l], carry);\n"
         "        slot[r][tz] = carry;\n",
         "#pragma unroll\n"
         "        for (int l = 0; l <= kMaxTreeDepth; ++l) {\n"
         "          if (l < tz) {\n"
         "            carry = df_add(slot[r][l], carry);\n"
         "          } else if (l == tz) {\n"
         "            slot[r][l] = carry;\n"
         "          }\n"
         "        }\n")],
    # diagnostics: what each part costs (their dots are not the sums)
    "pass alone: no fence, no ticket, no combine (dots not summed)": [
        ("df_pipe.cu", PIPE_TICKET, "  }\n  return;\n")],
    "pass alone without the lanes' tree (dots not summed)": [
        ("df_pipe.cu", PIPE_TICKET, "  }\n  return;\n"),
        ("df_pipe.cu", "  warp_tree_sum4(sums);\n", "")],
}


#: the earlier staged band (``load_band``, ``sym_row``) as edits of the
#: direct design: the band window staged in shared memory by 4-byte loads
STAGED_HELPERS = r"""// Stage data[:, i0 - h : i0 + kTile) into sdata (row stride kTile + h).
template <typename T, typename D>
__device__ __forceinline__ void load_band(const D* __restrict__ data,
                                          int ndiag, int h, long long n,
                                          long long i0, T* sdata) {
  const int dw = kTile + h;
  const int total = ndiag * dw;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int d = idx / dw;
    const long long g = i0 - h + (idx - d * dw);
    sdata[idx] = (g >= 0 && g < n) ? widen(data[(long long)d * n + g]) : T(0);
  }
}

template <typename T>
__host__ __device__ inline int band_pad(int h) {
  return h;
}

// (A v)[i0 + t] from the staged band and window.
template <typename T>
__device__ __forceinline__ T sym_row(const T* sdata, const T* sv, int ndiag,
                                     int h, const int* soff, int t) {
  const int dw = kTile + h;
  const int c = t + h;  // row i0 + t in window coordinates
  T acc = sdata[c] * sv[c];
  for (int d = 1; d < ndiag; ++d) {
    const int off = soff[d];
    const T* row = sdata + d * dw;
    acc += row[c] * sv[c + off];
    acc += row[c - off] * sv[c - off];
  }
  return acc;
}

"""

#: the staged band brought in by 16-byte asynchronous copies (cp.async.cg),
#: all issued before the first wait: rows of the window start on 16-byte
#: boundaries (h padded to hp), rows wholly outside [0, n) stored as zeros;
#: plain loads where n leaves the band's rows unaligned
ASYNC_HELPERS = r"""template <typename T>
__host__ __device__ inline int band_pad(int h) {
  constexpr int V = 16 / sizeof(T);
  return (h + V - 1) / V * V;
}

// Stage data[:, i0 - hp : i0 + kTile) into sdata (row stride kTile + hp);
// a band stored in another type than T (bf16) by plain loads.
template <typename T, typename D>
__device__ __forceinline__ void load_band(const D* __restrict__ data,
                                          int ndiag, int h, long long n,
                                          long long i0, T* sdata) {
  constexpr int V = 16 / sizeof(T);
  const int hp = band_pad<T>(h);
  const int dw = kTile + hp;
  if (sizeof(D) == sizeof(T) && n % V == 0) {
    const int nch = dw / V;
    const int total = ndiag * nch;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int d = idx / nch;
      const int m = idx - d * nch;
      const long long g = i0 - hp + m * V;
      T* dst = sdata + d * dw + m * V;
      if (g >= 0 && g < n) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                     "l"(data + (long long)d * n + g)
                     : "memory");
      } else {
        for (int e = 0; e < V; ++e) dst[e] = T(0);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    const int total = ndiag * dw;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int d = idx / dw;
      const long long g = i0 - hp + (idx - d * dw);
      sdata[idx] =
          (g >= 0 && g < n) ? widen(data[(long long)d * n + g]) : T(0);
    }
  }
}

// (A v)[i0 + t] from the staged band (row t + hp) and window (row t + h).
template <typename T>
__device__ __forceinline__ T sym_row(const T* sdata, const T* sv, int ndiag,
                                     int h, const int* soff, int t) {
  const int hp = band_pad<T>(h);
  const int dw = kTile + hp;
  const int cb = t + hp;
  const int c = t + h;
  T acc = sdata[cb] * sv[c];
  for (int d = 1; d < ndiag; ++d) {
    const int off = soff[d];
    const T* row = sdata + d * dw;
    acc += row[cb] * sv[c + off];
    acc += row[cb - off] * sv[c - off];
  }
  return acc;
}

"""


#: the staged band in a persistent block with two stages: while a block
#: computes one 256-row tile from one stage, the 16-byte asynchronous copies
#: (cp.async.cg, one commit group a tile) of its next tile's band land in the
#: other; the vector windows are staged per tile as before
RING_HELPERS = r"""template <typename T>
__host__ __device__ inline int band_pad(int h) {
  constexpr int V = 16 / sizeof(T);
  return (h + V - 1) / V * V;
}

// Issue the copies of data[:, i0 - hp : i0 + kTile) into sdata (row stride
// kTile + hp) as one commit group; plain loads where n leaves the band's
// rows unaligned or the band is stored in another type than T (bf16).
template <typename T, typename D>
__device__ __forceinline__ void issue_band(const D* __restrict__ data,
                                           int ndiag, int h, long long n,
                                           long long i0, T* sdata) {
  constexpr int V = 16 / sizeof(T);
  const int hp = band_pad<T>(h);
  const int dw = kTile + hp;
  if (sizeof(D) == sizeof(T) && n % V == 0) {
    const int nch = dw / V;
    const int total = ndiag * nch;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int d = idx / nch;
      const int m = idx - d * nch;
      const long long g = i0 - hp + m * V;
      T* dst = sdata + d * dw + m * V;
      if (g >= 0 && g < n) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                     "l"(data + (long long)d * n + g)
                     : "memory");
      } else {
        for (int e = 0; e < V; ++e) dst[e] = T(0);
      }
    }
  } else {
    const int total = ndiag * dw;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int d = idx / dw;
      const long long g = i0 - hp + (idx - d * dw);
      sdata[idx] =
          (g >= 0 && g < n) ? widen(data[(long long)d * n + g]) : T(0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// (A v)[i0 + t] from the staged band (row t + hp) and window (row t + h).
template <typename T>
__device__ __forceinline__ T sym_row(const T* sdata, const T* sv, int ndiag,
                                     int h, const int* soff, int t) {
  const int hp = band_pad<T>(h);
  const int dw = kTile + hp;
  const int cb = t + hp;
  const int c = t + h;
  T acc = sdata[cb] * sv[c];
  for (int d = 1; d < ndiag; ++d) {
    const int off = soff[d];
    const T* row = sdata + d * dw;
    acc += row[cb] * sv[c + off];
    acc += row[cb - off] * sv[c - off];
  }
  return acc;
}

// Blocks a launch of a persistent kernel holds: as many as fit on the card.
template <typename K>
inline unsigned persistent_grid(K kernel, size_t smem, long long ntiles) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kTile, smem);
  const long long g = (long long)(occ > 0 ? occ : 1) * sms;
  return unsigned(g < ntiles ? g : ntiles);
}

"""

RING_SPMV = r"""template <typename T, typename D, int NRHS>
__global__ void __launch_bounds__(kTile) sym_dia_ring_kernel(
    const D* __restrict__ data, const __grid_constant__ Offsets o, int ndiag,
    int h, long long n, const T* __restrict__ v0, const T* __restrict__ v1,
    T* __restrict__ y0, T* __restrict__ y1) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const size_t bw = size_t(ndiag) * (kTile + band_pad<T>(h));
  const int vw = kTile + 2 * h;
  T* sdata = reinterpret_cast<T*>(smem);  // two stages of bw
  T* sv = sdata + 2 * bw;                 // NRHS windows of vw
  const long long ntiles = (n + kTile - 1) / kTile;
  load_offsets(o, ndiag, soff);
  long long tile = blockIdx.x;
  issue_band(data, ndiag, h, n, tile * kTile, sdata);
  for (int s = 0; tile < ntiles; tile += gridDim.x, s ^= 1) {
    const long long i0 = tile * kTile;
    if (tile + gridDim.x < ntiles) {
      issue_band(data, ndiag, h, n, (tile + gridDim.x) * kTile,
                 sdata + (s ^ 1) * bw);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    load_window(v0, h, n, i0, vw, sv);
    if (NRHS == 2) load_window(v1, h, n, i0, vw, sv + vw);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const long long i = i0 + threadIdx.x;
    const T* cur = sdata + s * bw;
    if (i < n) {
      y0[i] = sym_row(cur, sv, ndiag, h, soff, threadIdx.x);
      if (NRHS == 2) y1[i] = sym_row(cur, sv + vw, ndiag, h, soff, threadIdx.x);
    }
    __syncthreads();
  }
}

"""

RING_FAMILY = r"""template <typename T, typename D, typename S>
__global__ void __launch_bounds__(kTile) sym_family_ring_kernel(
    const D* __restrict__ data, const __grid_constant__ Offsets o, int ndiag,
    int h, long long n, const __grid_constant__ FamilyArgs<T> a,
    T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const size_t bw = size_t(ndiag) * (kTile + band_pad<T>(h));
  const int vw = kTile + 2 * h;
  T* sdata = reinterpret_cast<T*>(smem);  // two stages of bw
  T* smv = sdata + 2 * bw;                // S::kMv windows of vw
  T* sred = smv + size_t(S::kMv) * vw;    // S::kDots * kWarps
  const int t = threadIdx.x;
  const long long ntiles = (n + kTile - 1) / kTile;
  T sc[2];
  sc[0] = *a.sc[0];
  sc[1] = S::kSc > 1 ? *a.sc[1] : T(0);
  load_offsets(o, ndiag, soff);
  long long tile = blockIdx.x;
  issue_band(data, ndiag, h, n, tile * kTile, sdata);
  for (int s = 0; tile < ntiles; tile += gridDim.x, s ^= 1) {
    const long long i0 = tile * kTile;
    if (tile + gridDim.x < ntiles) {
      issue_band(data, ndiag, h, n, (tile + gridDim.x) * kTile,
                 sdata + (s ^ 1) * bw);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    T keep[kFamilyRows][S::kKeep];
    sym_window<T, S>(a, sc, n, i0, h, vw, keep, smv);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const long long i = i0 + t;
    T prod[S::kDots];
#pragma unroll
    for (int k = 0; k < S::kDots; ++k) prod[k] = T(0);
    if (i < n) {
      T mv[S::kMv], acc[S::kMv];
#pragma unroll
      for (int k = 0; k < S::kMv; ++k) {
        mv[k] = smv[k * vw + t + h];
        acc[k] = sym_row(sdata + s * bw, smv + k * vw, ndiag, h, soff, t);
      }
      S::finish(a, i, keep[0], mv, acc, prod);
    }
    block_dots(prod, sred, partials + size_t(tile) * S::kDots);
    __syncthreads();
  }
}

"""

#: the persistent two-stage ring as edits: new kernels beside the committed
#: ones, launched in their place, one row a thread
SYM_RING = [
    ("sym_common.cuh", "constexpr int kWarps = kTile / 32;\n",
     "constexpr int kWarps = kTile / 32;\n\n" + RING_HELPERS),
    ("sym_dia.cu", "template <typename T, typename D = T>\nint launch_sym_dia(",
     RING_SPMV + "template <typename T, typename D = T>\nint launch_sym_dia("),
    ("sym_dia.cu",
     "  if (nrhs == 1) {\n"
     "    err = allow_smem(sym_dia_kernel<T, D, 1>, smem);\n"
     "    if (err != cudaSuccess) return int(err);\n"
     "    sym_dia_kernel<T, D, 1><<<grid, kTile, smem, st>>>(d, o, ndiag, h, n, a,\n"
     "                                                       b, ya, yb);\n"
     "  } else {\n"
     "    err = allow_smem(sym_dia_kernel<T, D, 2>, smem);\n"
     "    if (err != cudaSuccess) return int(err);\n"
     "    sym_dia_kernel<T, D, 2><<<grid, kTile, smem, st>>>(d, o, ndiag, h, n, a,\n"
     "                                                       b, ya, yb);\n"
     "  }\n",
     "  (void)grid;\n"
     "  const long long ntiles = (n + kTile - 1) / kTile;\n"
     "  const size_t ring =\n"
     "      (2 * size_t(ndiag) * (kTile + band_pad<T>(h)) +\n"
     "       size_t(nrhs) * (kTile + 2 * h)) * sizeof(T);\n"
     "  if (nrhs == 1) {\n"
     "    err = allow_smem(sym_dia_ring_kernel<T, D, 1>, ring);\n"
     "    if (err != cudaSuccess) return int(err);\n"
     "    const unsigned g = persistent_grid(sym_dia_ring_kernel<T, D, 1>, ring, ntiles);\n"
     "    sym_dia_ring_kernel<T, D, 1><<<g, kTile, ring, st>>>(d, o, ndiag, h, n, a, b,\n"
     "                                                         ya, yb);\n"
     "  } else {\n"
     "    err = allow_smem(sym_dia_ring_kernel<T, D, 2>, ring);\n"
     "    if (err != cudaSuccess) return int(err);\n"
     "    const unsigned g = persistent_grid(sym_dia_ring_kernel<T, D, 2>, ring, ntiles);\n"
     "    sym_dia_ring_kernel<T, D, 2><<<g, kTile, ring, st>>>(d, o, ndiag, h, n, a, b,\n"
     "                                                         ya, yb);\n"
     "  }\n"),
    ("sym_family.cu", "constexpr int kFamilyRows = 2;",
     "constexpr int kFamilyRows = 1;"),
    ("sym_family.cu", "template <typename T, typename D, typename S>\nint launch_spec(",
     RING_FAMILY + "template <typename T, typename D, typename S>\nint launch_spec("),
    ("sym_family.cu",
     "  cudaError_t err = allow_smem(sym_family_kernel<T, D, S>, smem);\n"
     "  if (err != cudaSuccess) return int(err);\n"
     "  const unsigned grid = unsigned((n + kFamilyTile - 1) / kFamilyTile);\n"
     "  sym_family_kernel<T, D, S><<<grid, kTile, smem, st>>>(data, o, ndiag, h, n,\n"
     "                                                       a, partials);\n",
     "  (void)smem;\n"
     "  const long long ntiles = (n + kTile - 1) / kTile;\n"
     "  const size_t ring = (2 * size_t(ndiag) * (kTile + band_pad<T>(h)) +\n"
     "                       size_t(S::kMv) * (kTile + 2 * h) +\n"
     "                       S::kDots * kWarps) * sizeof(T);\n"
     "  cudaError_t err = allow_smem(sym_family_ring_kernel<T, D, S>, ring);\n"
     "  if (err != cudaSuccess) return int(err);\n"
     "  const unsigned g = persistent_grid(sym_family_ring_kernel<T, D, S>, ring, ntiles);\n"
     "  sym_family_ring_kernel<T, D, S><<<g, kTile, ring, st>>>(data, o, ndiag, h, n,\n"
     "                                                         a, partials);\n"),
]


def staged_band(helpers):
    """Edits that stage each block's band window in shared memory (the
    earlier design) with the staging of ``helpers``; both kernels then own
    one row a thread and compute their row products from shared memory
    (sym_row), under the earlier design's launch bounds."""
    return [
        ("sym_common.cuh", "constexpr int kWarps = kTile / 32;\n",
         helpers + "constexpr int kWarps = kTile / 32;\n"),
        ("sym_dia.cu", "  T* sv = reinterpret_cast<T*>(smem);  // NRHS windows of vw",
         "  T* sdata = reinterpret_cast<T*>(smem);\n"
         "  T* sv = sdata + size_t(ndiag) * (kTile + band_pad<T>(h));"),
        ("sym_dia.cu", "  load_window(v0, h, n, i0, vw, sv);",
         "  load_band(data, ndiag, h, n, i0, sdata);\n"
         "  load_window(v0, h, n, i0, vw, sv);"),
        ("sym_dia.cu",
         "  sym_rows<T, D, kSymDiaRows, NRHS>(data, n, i0, ndiag, soff, sv, vw, h,"
         "\n                                    acc);",
         "  acc[0][0] = sym_row(sdata, sv, ndiag, h, soff, threadIdx.x);\n"
         "  if (NRHS == 2)\n"
         "    acc[0][NRHS - 1] = sym_row(sdata, sv + vw, ndiag, h, soff,\n"
         "                               threadIdx.x);"),
        ("sym_dia.cu", "__launch_bounds__(kTile, kSymDiaMinBlocks<T>)",
         "__launch_bounds__(kTile)"),
        ("sym_dia.cu",
         "  const size_t smem = size_t(nrhs) * (kSymDiaTile + 2 * h) * "
         "sizeof(T);",
         "  const size_t smem = (size_t(ndiag) * (kTile + band_pad<T>(h)) +\n"
         "                       size_t(nrhs) * (kSymDiaTile + 2 * h)) *\n"
         "                      sizeof(T);"),
        ("sym_family.cu", "constexpr int kFamilyRows = 2;",
         "constexpr int kFamilyRows = 1;"),
        ("sym_family.cu",
         "  T* smv = reinterpret_cast<T*>(smem);   // S::kMv windows of vw",
         "  T* sdata = reinterpret_cast<T*>(smem);\n"
         "  T* smv = sdata + size_t(ndiag) * (kTile + band_pad<T>(h));"),
        ("sym_family.cu",
         "  load_offsets(o, ndiag, soff);\n  T keep[kFamilyRows][S::kKeep];",
         "  load_offsets(o, ndiag, soff);\n"
         "  load_band(data, ndiag, h, n, i0, sdata);\n"
         "  T keep[kFamilyRows][S::kKeep];"),
        ("sym_family.cu",
         "  sym_rows<T, D, kFamilyRows, S::kMv>(data, n, i0, ndiag, soff, smv, vw, h,"
         "\n                                      acc);",
         "#pragma unroll\n"
         "  for (int k = 0; k < S::kMv; ++k)\n"
         "    acc[0][k] = sym_row(sdata, smv + k * vw, ndiag, h, soff, t);"),
        ("sym_family.cu",
         "constexpr int kMinBlocks = sizeof(T) == 4 ? 5 : 3;",
         "constexpr int kMinBlocks = sizeof(T) == 4 ? 5 : 2;"),
        ("sym_family.cu",
         "  const size_t smem = (size_t(S::kMv) * (kFamilyTile + 2 * h) +",
         "  const size_t smem = (size_t(ndiag) * (kTile + band_pad<T>(h)) +\n"
         "                       size_t(S::kMv) * (kFamilyTile + 2 * h) +"),
    ]


#: the staged design the direct band replaced, as it was committed
SYM_STAGED = staged_band(STAGED_HELPERS)


def sym_bounds(family=None, spmv=None):
    """Edits that set the minimum-blocks launch bounds of the half-band
    family kernel and SpMV: (f32, f64) each, None to keep."""
    edits = []
    if family:
        edits.append(("sym_family.cu",
                      "constexpr int kMinBlocks = sizeof(T) == 4 ? 5 : 3;",
                      "constexpr int kMinBlocks = sizeof(T) == 4 ? {} : {};"
                      .format(*family)))
    if spmv:
        edits.append(("sym_dia.cu", "constexpr int kSymDiaMinBlocks = 8;",
                      "constexpr int kSymDiaMinBlocks = sizeof(T) == 4 ? {} : "
                      "{};".format(*spmv)))
    return edits


def rows_per_thread(family=None, spmv=None):
    """Edits that set the rows a thread owns in each half-band kernel."""
    edits = []
    if family:
        edits.append(("sym_family.cu", "constexpr int kFamilyRows = 2;",
                      f"constexpr int kFamilyRows = {family};"))
    if spmv:
        edits.append(("sym_dia.cu", "constexpr int kSymDiaRows = 1;",
                      f"constexpr int kSymDiaRows = {spmv};"))
    return edits


#: design options of rows 1, 2 and 2b, each timed against the committed
#: source in turns (``symopts``): what -> edits
SYM_OPTIONS = {
    "(a) staged band, the earlier design": SYM_STAGED,
    "(b) f32 forward band loads plain (no hint)": [
        ("sym_common.cuh", "    return widen(__ldcs(p));",
         "    return widen(*p);")],
    "(b) f32 forward band loads read-only (__ldg)": [
        ("sym_common.cuh", "    return widen(__ldcs(p));",
         "    return widen(__ldg(p));")],
    "(b) f64 forward band loads read-only (__ldg)": [
        ("sym_common.cuh", "    return widen(*p);",
         "    return widen(__ldg(p));")],
    "(b) f64 forward band loads evict-first (__ldcs)": [
        ("sym_common.cuh", "    return widen(*p);",
         "    return widen(__ldcs(p));")],
    "(c) staged band by 16-byte cp.async": staged_band(ASYNC_HELPERS),
    "(c) staged band by 16-byte cp.async, persistent blocks, two stages":
        SYM_RING,
    "(d) family kernel: 1 row per thread (256-row tiles)":
        rows_per_thread(family=1),
    "(d) family kernel: 4 rows per thread (1024-row tiles)":
        rows_per_thread(family=4),
    "(d) SpMV: 2 rows per thread (512-row tiles)": rows_per_thread(spmv=2),
    "(e) family kernel: launch bound 4 blocks": sym_bounds(family=(4, 4)),
    "(e) family kernel: launch bound 6 blocks": sym_bounds(family=(6, 6)),
    "(e) family kernel: launch bound 8 blocks": sym_bounds(family=(8, 8)),
    "(e) family kernel: no minimum blocks": sym_bounds(family=(1, 1)),
    "(e) SpMV: launch bound 4 blocks in f64": sym_bounds(spmv=(8, 4)),
    "(e) SpMV: launch bound 6 blocks": sym_bounds(spmv=(6, 6)),
    "diagonal loop unrolled by 2": [
        ("sym_common.cuh", "#pragma unroll 4\n  for (int d = 1;",
         "#pragma unroll 2\n  for (int d = 1;")],
    "diagonal loop unrolled by 8": [
        ("sym_common.cuh", "#pragma unroll 4\n  for (int d = 1;",
         "#pragma unroll 8\n  for (int d = 1;")],
    "carve-out: 25% of the SM's on-chip memory to shared memory": [
        ("sym_family.cu",
         "  cudaError_t err = allow_smem(sym_family_kernel<T, D, S>, smem);\n",
         "  cudaError_t err = allow_smem(sym_family_kernel<T, D, S>, smem);\n"
         "  cudaFuncSetAttribute(sym_family_kernel<T, D, S>,\n"
         "                       cudaFuncAttributePreferredSharedMemoryCarveout,"
         " 25);\n"),
        ("sym_dia.cu", "  cudaStream_t st = static_cast<cudaStream_t>(stream);\n",
         "  cudaStream_t st = static_cast<cudaStream_t>(stream);\n"
         "  cudaFuncSetAttribute(sym_dia_kernel<T, D, 1>,\n"
         "                       cudaFuncAttributePreferredSharedMemoryCarveout,"
         " 25);\n"
         "  cudaFuncSetAttribute(sym_dia_kernel<T, D, 2>,\n"
         "                       cudaFuncAttributePreferredSharedMemoryCarveout,"
         " 25);\n")],
}


#: the minimum-blocks launch bound of the half-band SpMV, the DIA SpMV and the
#: full-DIA family kernel: (source, text, replacement taking the bound)
LAUNCH_BOUNDS = (
    ("sym_dia.cu", "constexpr int kSymDiaMinBlocks = 8;",
     "constexpr int kSymDiaMinBlocks = {};"),
    ("dia_spmv.cu", "constexpr int kDiaMinBlocks = sizeof(T) == 4 ? 8 : 4;",
     "constexpr int kDiaMinBlocks = {};"),
    ("dia_family.cu",
     "constexpr int kDiaFamilyMinBlocks = sizeof(T) == 4 ? 6 : 3;",
     "constexpr int kDiaFamilyMinBlocks = {};"),
)


def emit(study, **fields):
    print(json.dumps({"study": study, **fields}), flush=True)


def build_edited(stack, edits, only=None):
    """Build a copy of the kernel sources with ``edits`` = [(source, text,
    replacement)] applied (text ``None``: the replacement is the whole
    file), in a temporary directory that lives as long as
    ``stack``; ``only``: the ``.cu`` sources to build (default all).
    Returns the loaded libraries by source (for ``_kernels.using``) and the
    build logs' register and spill lines."""
    from new_cg_variants_tpu_torch.ops import _kernels

    tmp = Path(stack.enter_context(
        tempfile.TemporaryDirectory(prefix="ncgv_study_")))
    shutil.copytree(CSRC, tmp / "csrc", ignore=None if only is None else (
        lambda d, names: [f for f in names
                          if f.endswith(".cu") and f not in only]))
    for source, text, replacement in edits:
        path = tmp / "csrc" / source
        if text is None:  # the whole file
            path.write_text(replacement)
            continue
        body = path.read_text()
        if body.count(text) != 1:
            raise ValueError(f"{source}: {text!r} found "
                             f"{body.count(text)} times, expected once")
        path.write_text(body.replace(text, replacement))
    paths = _kernels.build(csrc=tmp / "csrc", build_root=tmp / "_build")
    libs = {src: _kernels.load(src, p) for src, p in paths.items()}
    logs = {src: [ln for ln in p.with_suffix(".log").read_text().splitlines()
                  if "registers" in ln or "Compiling" in ln or "spill" in ln]
            for src, p in paths.items()}
    return libs, logs


def dia_checks(torch, card):
    """check_dia's checks, counted instead of raised and not timed: (checks,
    failed, worst error among the failed)."""
    lines = []
    failed = cs.dia_checks(torch, card, None, lines.append)
    errs = [max(r["max_err"], r.get("max_dot_err", 0.0)) for r in failed]
    honest = [max(r["max_err"], r.get("max_dot_err", 0.0)) for r in lines
              if r not in failed]
    return dict(checks=len(lines), failed=len(failed),
                failed_err_min=min(errs, default=None),
                failed_err_max=max(errs, default=None),
                passed_err_max=max(honest, default=None))


def sym_checks(torch, card):
    """The half-band checks, counted instead of raised and not timed."""
    lines = []
    failed = cs.sym_checks(torch, card, None, lines.append)
    errs = [max(r["max_err"], r.get("max_dot_err", 0.0)) for r in failed]
    return dict(checks=len(lines), failed=len(failed),
                failed_checks=sorted({(r["kernel"], r["n"], r["k"])
                                      for r in failed}),
                failed_err_min=min(errs, default=None),
                passed_err_max=max((max(r["max_err"], r.get("max_dot_err", 0.0))
                                    for r in lines if r not in failed),
                                   default=None))


def df_checks(torch, card):
    """check_df's checks, counted instead of raised and not timed."""
    lines = []
    failed = cs.df_checks(torch, card, None, lines.append)
    return dict(checks=len(lines), failed=len(failed),
                failed_checks=sorted({r["kernel"] for r in failed}),
                passed_checks=[(r["kernel"], r["n"]) for r in lines
                               if r not in failed],
                passed_abs_err_max=max((r["max_abs_err"] for r in lines
                                        if r not in failed), default=None))


def ell_checks(torch, card):
    """check_ell's checks, counted instead of raised and not timed; the
    lines that check a locality order counted apart."""
    lines = []
    failed = cs.ell_checks(torch, card, None, lines.append)
    errs = [r["max_err"] for r in failed]
    local = [r for r in lines if "locality" in r["orders"]]
    return dict(checks=len(lines), failed=len(failed),
                locality_checks=len(local),
                locality_failed=sum(r in failed for r in local),
                failed_err_min=min(errs, default=None),
                failed_err_max=max(errs, default=None),
                failed_not_same_bits=sum(
                    not r.get("same_bits_as_given", True) for r in failed),
                passed_checks=[(r["shape"], r["dtype"]) for r in lines
                               if r not in failed],
                passed_err_max=max((r["max_err"] for r in lines
                                    if r not in failed), default=None))


def bf16_checks(torch, card):
    """check_bf16's checks, counted instead of raised and not timed; the
    lines whose only fault is a bit difference from the float32 entry on
    the widened data counted apart."""
    lines = []
    failed = cs.bf16_checks(torch, card, None, lines.append)
    return dict(checks=len(lines), failed=len(failed),
                failed_checks=sorted({r["kernel"] for r in failed}),
                failed_bits_only=sum(r["max_err"] <= r["tol"]
                                     for r in failed),
                passed_err_max=max((r["max_err"] for r in lines
                                    if r not in failed), default=None))


def study_bf16check(torch, card):
    """The quick first call after touching a band kernel's bf16 entries:
    build, registers, check_bf16 (timed)."""
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = build_edited(stack, [])
        for src in ("sym_dia.cu", "sym_family.cu", "dia_spmv.cu",
                    "dia_family.cu", "ell_spmv.cu"):
            emit("bf16check", source=src, ptxas=logs[src])
        with _kernels.using(libs):
            timings = {}
            cs.check_bf16(torch, card, timings)
    emit("bf16check", ok=True,
         timed={name: {key: t.get(key) for key in ("ms", "f32_ms",
                                                   "bound_ms", "plain_ms")}
                for name, t in timings.items() if name.endswith(cs.BF16)})


def study_distcheck(torch, card):
    """The quick first call after touching the distributed layer
    (``parallel/``): check_dia (whose vector-phase records the row
    partition takes), then chip_smoke.py's check_dist, dist_f32 and
    dist_f64 in a world of one, and the native reader on a 32^3 file."""
    from new_cg_variants_tpu_torch import write_mtx
    from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy

    timings = {}
    cs.check_dia(torch, card, timings)
    cs.check_dist(torch, card, timings)
    with cs.dist_world() as mesh:
        launches = cs.dist_f32(torch, mesh, timings)
        cs.dist_f64(torch, mesh)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "hpcg27.mtx")
        write_mtx(path, coo_from_scipy(cs.stencil27(cs.CONV_GRID,
                                                    cs.PERM_SEED)),
                  symmetric=True)
        native = cs.read_mtx_seconds(path)
    emit("distcheck", ok=True, launches=launches, native=native,
         timed={name: {key: t.get(key) for key in ("ms", "bound_ms",
                                                   "plain_ms", "library_ms")}
                for name, t in timings.items() if name.endswith(cs.DIST)})


def study_check(torch, card):
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = build_edited(stack, [])
        for src, lines in logs.items():
            emit("check", source=src, ptxas=lines)
        with _kernels.using(libs):
            cs.check_dia(torch, card, {})
    emit("check", ok=True)


def study_symcheck(torch, card):
    """The quick first call after touching a half-band kernel: build,
    registers, the half-band checks (timed)."""
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = build_edited(stack, [])
        for src in ("sym_dia.cu", "sym_family.cu"):
            emit("symcheck", source=src, ptxas=logs[src])
        with _kernels.using(libs):
            cs.check_sym(torch, card, {})
    emit("symcheck", ok=True)


def sym_cases(torch, n, k, dtype, seed):
    """Name -> callable of every half-band kernel entry on one band, random
    inputs from ``seed``: the two SpMV entries and the eleven family
    entries."""
    from new_cg_variants_tpu_torch.ops import sym_dia as sd
    from new_cg_variants_tpu_torch.ops import sym_fused as sf

    rng = np.random.default_rng(seed)
    offs = tuple(range(k))
    data = cs.random_band(torch, offs, n, dtype, rng)
    vecs = {nm: torch.as_tensor(
        rng.uniform(0.5, 2.0, n) if nm == "d" else rng.standard_normal(n),
        dtype=dtype, device="cuda") for nm in "d x r w u p s rt st wt ut".split()}
    scal = {nm: torch.tensor(val, dtype=dtype, device="cuda")
            for nm, val in cs.SCALAR_VALUES.items()}
    v, w = vecs["x"], vecs["r"]
    cases = {
        "sym_dia_spmv": lambda: flat(sd.sym_dia_spmv(offs, data, v)),
        "sym_dia_spmv2": lambda: flat(sd.sym_dia_spmv2(offs, data, v, w)),
    }
    for entry, (ins, scs, _, _, _, _, kw, _) in cs.FAMILY.items():
        fn = getattr(sf, entry.split("/")[0])
        args = [vecs[nm] for nm in ins.split()] + [scal[nm] for nm in scs.split()]
        cases[entry] = (lambda fn=fn, args=args, kw=kw:
                        flat(fn(offs, data, *args, **kw)))
    return cases


def study_symopts(torch, card):
    """Rows 1, 2 and 2b's design options against the committed source,
    timed in turns at the main path's shape (n = 655,360, k = 32) in f32
    and f64; every option's outputs compared bit for bit with the committed
    kernels' there and on every shape of the half-band checks
    (chip_smoke.SYM_SHAPES), and the half-band checks run under each."""
    from new_cg_variants_tpu_torch.ops import _kernels

    cases = {}
    for dtype in (torch.float32, torch.float64):
        dn = cs.dtype_name(dtype)
        for name, fn in sym_cases(torch, cs.N, cs.K_BAND, dtype, 7).items():
            cases[f"{name}, {dn}"] = fn
    shape_cases = {}
    for dtype in (torch.float32, torch.float64):
        for n, k in cs.SYM_SHAPES:
            for name, fn in sym_cases(torch, n, k, dtype, n + k).items():
                shape_cases[(name, cs.dtype_name(dtype), n, k)] = fn

    # a staged band takes ndiag * (256 + h) values of shared memory a
    # block (two stages: twice that): 392 KB at k = 128 in f64, which no
    # block has
    staged = {name for name, edits in SYM_OPTIONS.items()
              if any("band_pad" in repl for _, _, repl in edits)}

    def check(variant):
        shapes = cs.SYM_SHAPES
        if variant in staged:
            cs.SYM_SHAPES = tuple(s for s in shapes if s[1] <= cs.K_BAND)
        try:
            lines = []
            failed = cs.sym_checks(torch, card, None, lines.append)
        finally:
            cs.SYM_SHAPES = shapes
        outs = {key: [t.clone() for t in fn()]
                for key, fn in shape_cases.items()
                if variant not in staged or key[3] <= cs.K_BAND}
        return dict(checks=len(lines), failed=len(failed),
                    passed_err_max=max(max(r["max_err"],
                                           r.get("max_dot_err", 0.0))
                                       for r in lines), outs=outs)

    variants = {"as committed": [], **SYM_OPTIONS}
    times, same, logs, checked = timed_in_turns(
        torch, variants, cases, rounds=5, iters=100,
        only=("sym_dia.cu", "sym_family.cu"), check=check)
    ref = checked["as committed"]["outs"]
    for name, by_src in logs.items():
        outs = checked[name].pop("outs")
        differ = sorted({f"{key[0]}, {key[1]}, n = {key[2]}, k = {key[3]}"
                         for key, got in outs.items()
                         if not all(bool(torch.equal(a, b))
                                    for a, b in zip(got, ref[key]))})
        emit("symopts", variant=name,
             ptxas=by_src["sym_dia.cu"] + by_src["sym_family.cu"],
             sym_checks=checked[name], check_shapes_compared=len(outs),
             check_shapes_same_bits_as_committed=not differ,
             check_shapes_differing=differ)
    for c in cases:
        emit("symopts", case=c, card=card,
             ms={v: [round(t, 5) for t in ts] for v, ts in times[c].items()},
             median_ms={v: round(float(np.median(ts)), 5)
                        for v, ts in times[c].items()},
             same_bits_as_committed=same[c])


def study_dfcheck(torch, card):
    """The quick first call after touching a double-word kernel: build,
    registers, the double-word checks (timed)."""
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = build_edited(stack, [])
        for src in ("df_spmv.cu", "df_pipe.cu"):
            emit("dfcheck", source=src, ptxas=logs[src])
        with _kernels.using(libs):
            cs.check_df(torch, card, {})
    emit("dfcheck", ok=True)


def study_ellcheck(torch, card):
    """The first call after touching the ELL kernel: build, registers,
    check_ell (timed).  Its mutants run in ``mutants``."""
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = build_edited(stack, [])
        emit("ellcheck", source="ell_spmv.cu", ptxas=logs["ell_spmv.cu"])
        with _kernels.using(libs):
            timings = {}
            cs.check_ell(torch, card, timings)
            emit("ellcheck", timings=timings)
    emit("ellcheck", ok=True)


def study_ellopts(torch, card):
    """Row 12's design options against the committed source, timed in turns
    at HPCG's pattern (f32): permuted in its RCM order (the path's shape)
    and in natural order; every option must give the committed bits."""
    from new_cg_variants_tpu_torch.ops import ell_spmv as es

    rng = np.random.default_rng(12)
    cases = {}
    for label, seed in (("RCM order", cs.PERM_SEED), ("natural order", None)):
        a = cs.stencil27(cs.HPCG_GRID, seed)
        perm = cs.locality_order(a)
        val, idx, _ = cs.ell_arrays(torch, a, rng, torch.float32)
        n = val.shape[0]
        v, w = (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                                device="cuda") for _ in range(2))
        p = None
        if perm is not None:
            p = es.check_perm(torch.from_numpy(perm).cuda(), n)
            bval_t, bidx_t = es.reorder(val.T, idx.T, p)
            val, idx = bval_t.T, bidx_t.T
        cases[f"ell_spmv, {label}"] = (
            lambda val=val, idx=idx, v=v, p=p: [es.ell_spmv(val, idx, v, p)])
        cases[f"ell_spmv2, {label}"] = (
            lambda val=val, idx=idx, v=v, w=w, p=p:
            list(es.ell_spmv2(val, idx, v, w, p)))
    variants = {"as committed": [], **ELL_OPTIONS}
    times, same, logs, _ = timed_in_turns(torch, variants, cases,
                                       only=("ell_spmv.cu",))
    for name, by_src in logs.items():
        emit("ellopts", variant=name, ptxas=by_src["ell_spmv.cu"])
    for c in cases:
        emit("ellopts", case=c, card=card,
             ms={v: [round(t, 5) for t in ts] for v, ts in times[c].items()},
             same_bits_as_committed=same[c])


def study_denseopts(torch, card):
    """Row 10's dense design options against the committed source, timed in
    turns at n = 4096 and 8192; every option must give the committed bits
    there and pass check_df_dense (n = 4096, 8192, 1000, 300, 5, 1)."""
    from new_cg_variants_tpu_torch import df_split3
    from new_cg_variants_tpu_torch.ops import df_spmv as ds

    cases = {}
    for n in (cs.DF_DENSE_N, 8192):
        rng = np.random.default_rng(n)
        mats = df_split3(rng.uniform(-1.0, 1.0, (n, n)), device="cuda")
        v, w = cs.df_vec(torch, rng, n), cs.df_vec(torch, rng, n)
        cases[f"df_dense_spmv, n = {n}"] = (
            lambda mats=mats, v=v: flat(ds.df_dense_spmv(*mats, v)))
        cases[f"df_dense_spmv2, n = {n}"] = (
            lambda mats=mats, v=v, w=w: flat(ds.df_dense_spmv2(*mats, v, w)))

    def check(variant):
        lines = []
        failed = cs.check_df_dense(torch, card, None, lines.append)
        return dict(checks=len(lines), failed=len(failed))

    variants = {"as committed": [], **DENSE_OPTIONS}
    times, same, logs, checked = timed_in_turns(
        torch, variants, cases, rounds=5, iters=200, only=("df_spmv.cu",),
        check=check)
    for name, by_src in logs.items():
        emit("denseopts", variant=name, ptxas=by_src["df_spmv.cu"],
             check_df_dense=checked[name])
    for c in cases:
        emit("denseopts", case=c, card=card,
             ms={v: [round(t, 5) for t in ts] for v, ts in times[c].items()},
             median_ms={v: round(float(np.median(ts)), 5)
                        for v, ts in times[c].items()},
             same_bits_as_committed=same[c])


def study_pipeopts(torch, card):
    """Row 11's design options against the committed source, timed in turns
    at n = 655,360 (the f32x2 path's shape), 4096 (the dense path's),
    4,194,304, and 65,536, 131,072 and 262,144 (256, 512 and 1024 tiles,
    about where a warp a tile starts to beat a block a tile: kWarpTiles);
    every option's outputs compared bit for bit with those of
    the PR 4 design (the first variant) there and at every shape of
    check_df_pipe (chip_smoke.DF_PIPE_NS), each shape run twice, and
    check_df_pipe run under each option."""
    from new_cg_variants_tpu_torch.ops import df_spmv as ds

    a1 = cs.df_scalar(0.3712345678901234)
    beta = cs.df_scalar(0.1298765432109876)

    def case(n, seed):
        rng = np.random.default_rng(seed)
        vecs = [cs.df_vec(torch, rng, n) for _ in range(6)]
        return lambda: flat(ds.df_pipe_vector_phase(*vecs, a1, beta))

    cases = {f"df_pipe_vector_phase, n = {n}": case(n, n)
             for n in (cs.N, cs.DF_DENSE_N, cs.WIDE_N, 65536, 131072,
                       262144)}
    shape_cases = {n: case(n, n + 1) for n in cs.DF_PIPE_NS}

    def check(variant):
        lines = []
        failed = cs.check_df_pipe(torch, card, None, lines.append)
        outs, repeat = {}, True
        for n, fn in shape_cases.items():
            outs[n] = [t.clone() for t in fn()]
            repeat &= all(bool(torch.equal(a, b))
                          for a, b in zip(fn(), outs[n]))
        return dict(checks=len(lines), failed=len(failed),
                    repeat_same_bits=repeat, outs=outs)

    variants = dict(PIPE_OPTIONS)
    first = next(iter(variants))
    variants = {first: variants.pop(first), "as committed": [], **variants}
    times, same, logs, checked = timed_in_turns(
        torch, variants, cases, rounds=5, iters=100, only=("df_pipe.cu",),
        check=check)
    ref = checked[first]["outs"]
    for name, by_src in logs.items():
        outs = checked[name].pop("outs")
        differ = [n for n, got in outs.items()
                  if not all(bool(torch.equal(a, b))
                             for a, b in zip(got, ref[n]))]
        emit("pipeopts", variant=name, ptxas=by_src["df_pipe.cu"],
             check_df_pipe=checked[name], shapes_compared=len(outs),
             same_bits_as_pr4_design=not differ, shapes_differing=differ)
    for c in cases:
        emit("pipeopts", case=c, card=card,
             ms={v: [round(t, 5) for t in ts] for v, ts in times[c].items()},
             median_ms={v: round(float(np.median(ts)), 5)
                        for v, ts in times[c].items()},
             same_bits_as_pr4_design=same[c])


def study_mutants(torch, card, family=None):
    """Every mutant, built in parallel, against the checks its kernel takes
    part in; each family of checks also runs on the committed kernels.
    ``family`` (dia, sym, df, ell or bf16): that family's mutants only."""
    from new_cg_variants_tpu_torch.ops import _kernels
    from new_cg_variants_tpu_torch.ops import df_spmv as ds

    families = {"dia": ("", MUTANTS, dia_checks),
                "sym": (" (half-band checks)", SYM_MUTANTS, sym_checks),
                "df": (" (double-word checks)", DF_MUTANTS, df_checks),
                "ell": (" (ELL checks)", ELL_MUTANTS, ell_checks),
                "bf16": (" (bf16 checks)", BF16_MUTANTS, bf16_checks)}
    runs = []
    for key, (label, mutants, checks) in families.items():
        if family not in (None, key):
            continue
        runs += [(what, edit, checks) for what, edit in
                 {"as committed" + label: None, **mutants}.items()]

    def only(edit):
        # a header's mutant rebuilds every source; committed runs build none
        if edit is None:
            return ()
        return (edit[0],) if edit[0].endswith(".cu") else None

    with contextlib.ExitStack() as stack:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            built = [pool.submit(build_edited, stack, [edit] if edit else [],
                                 only(edit)) for _, edit, _ in runs]
        for (what, edit, checks), fut in zip(runs, built):
            ds._TICKETS.clear()  # a mutant may leave its ticket counter set
            with _kernels.using(fut.result()[0]):
                emit("mutants", mutant=what, source=edit and edit[0],
                     **checks(torch, card))


def timed_in_turns(torch, variants, cases, rounds=2, iters=50, only=None,
                   check=None):
    """``variants``: name -> edits; ``cases``: name -> callable returning
    tensors.  Times every case under every variant in turns (A B .. B A per
    round, ``iters`` calls a time) and compares each case's outputs with the
    first variant's bit for bit.  Returns {case: {variant: [ms, ...]}},
    {case: {variant: same}}, the build logs by variant and, with ``check``,
    {variant: check(variant)} run under each variant."""
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        # one nvcc a variant, eight at a time
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            built = {name: pool.submit(build_edited, stack, edits, only)
                     for name, edits in variants.items()}
        libs = {name: f.result()[0] for name, f in built.items()}
        logs = {name: f.result()[1] for name, f in built.items()}
        names = list(variants)
        checked = {}
        if check is not None:
            for v in names:
                with _kernels.using(libs[v]):
                    checked[v] = check(v)
        times = {c: {v: [] for v in names} for c in cases}
        same = {c: {} for c in cases}
        for c, fn in cases.items():
            with _kernels.using(libs[names[0]]):
                ref = [t.clone() for t in fn()]
            for v in names:
                with _kernels.using(libs[v]):
                    out = fn()
                    torch.cuda.synchronize()
                same[c][v] = all(bool(torch.equal(a, b))
                                 for a, b in zip(out, ref))
            for _ in range(rounds):
                for v in names + names[::-1]:
                    with _kernels.using(libs[v]):
                        times[c][v].append(cs.time_ms(torch, fn, iters))
        return times, same, logs, checked


def flat(out):
    """The tensors of a wrapper's return value (vectors, then the dots)."""
    if not isinstance(out, (tuple, list)):
        return [out]
    return [t for o in out for t in flat(o)]


def study_bounds(torch, card):
    """Minimum-blocks launch bounds of the SpMV kernels and the full-DIA
    family kernel, against none, at the main path's shapes (f32)."""
    from new_cg_variants_tpu_torch.ops import fused_family as ff
    from new_cg_variants_tpu_torch.ops import fused_step as fs
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp
    from new_cg_variants_tpu_torch.ops import sym_dia as sd

    rng = np.random.default_rng(0)
    n, dt = cs.N, torch.float32
    vecs = {nm: torch.as_tensor(
        rng.uniform(0.5, 2.0, n) if nm == "d" else rng.standard_normal(n),
        dtype=dt, device="cuda") for nm in "d x r w u p s rt st wt ut".split()}
    v, w = vecs["x"], vecs["r"]
    sym_offs = tuple(range(cs.K_BAND))
    offs = cs.DIA_MAIN_OFFSETS
    sym = cs.random_band(torch, sym_offs, n, dt, rng)
    dia = cs.random_dia(torch, offs, n, dt, rng)
    wide = cs.random_dia(torch, cs.WIDE_OFFSETS, n, dt, rng)
    scal = {nm: torch.tensor(val, dtype=dt, device="cuda")
            for nm, val in cs.SCALAR_VALUES.items()}
    cases = {
        "sym_dia_spmv": lambda: flat(sd.sym_dia_spmv(sym_offs, sym, v)),
        "sym_dia_spmv2": lambda: flat(sd.sym_dia_spmv2(sym_offs, sym, v, w)),
        "dia_spmv": lambda: flat(sp.dia_spmv(offs, dia, v)),
        "dia_spmv2": lambda: flat(sp.dia_spmv2(offs, dia, v, w)),
        "dia_spmv2 wide": lambda: flat(sp.dia_spmv2(cs.WIDE_OFFSETS, wide, v, w)),
    }
    for module, table in ((fs, cs.DIA_STEP), (ff, cs.DIA_FAMILY)):
        for entry, (ins, scs, _, _, nmv, _, kw, _) in table.items():
            if nmv:
                fn = getattr(module, entry.split("/")[0])
                args = ([vecs[nm] for nm in ins.split()]
                        + [scal[nm] for nm in scs.split()])
                cases[entry] = (lambda fn=fn, args=args, kw=kw:
                                flat(fn(offs, dia, *args, **kw)))

    def variant(*blocks):
        return [(source, text, replacement.format(k))
                for (source, text, replacement), k in zip(LAUNCH_BOUNDS, blocks)]

    variants = {"as committed": [], "min blocks 1": variant(1, 1, 1),
                "min blocks 4": variant(4, 4, 4),
                "min blocks 5": variant(5, 5, 5),
                "min blocks 6": variant(5, 6, 6),
                "min blocks 8": variant(5, 8, 8)}
    times, same, logs, _ = timed_in_turns(torch, variants, cases)
    for name, by_src in logs.items():
        for src in ("sym_dia.cu", "dia_spmv.cu", "dia_family.cu"):
            emit("bounds", variant=name, source=src, ptxas=by_src[src])
    for c in cases:
        emit("bounds", case=c, card=card,
             ms={v: [round(t, 5) for t in ts] for v, ts in times[c].items()},
             same_bits_as_committed=same[c])


def study_halo(torch, card):
    """The whole-iteration kernel against the split formulation (vector-phase
    kernel, then the 2-RHS SpMV kernel) on a 5-diagonal band (-h, -1, 0, 1,
    h) and on a dense band of 2h+1 diagonals, as h grows to the kernel's
    limit; f32, n = 4,194,304 (5 diagonals) or 655,360 (dense band)."""
    from new_cg_variants_tpu_torch.ops import fused_step as fs
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp

    rng = np.random.default_rng(0)
    dt = torch.float32
    a1, beta = (torch.tensor(x, dtype=dt, device="cuda") for x in (0.37, 0.61))
    for kind, n, hs in (("5 diagonals", cs.WIDE_N, (16, 64, 128, 256)),
                        ("dense band", cs.N, (8, 31, 64))):
        vecs = [torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
                for _ in range(6)]
        for h in hs:
            offs = ((-h, -1, 0, 1, h) if kind == "5 diagonals"
                    else tuple(range(-h, h + 1)))
            data = cs.random_dia(torch, offs, n, dt, rng)

            def split():
                x, r, w, p, s, dots = fs.fused_pipe_vector_phase(*vecs, a1, beta)
                return sp.dia_spmv2(offs, data, s, r)

            full = cs.time_ms(
                torch, lambda: fs.fused_pipe_full_step(offs, data, *vecs, a1,
                                                       beta), 50)
            parts = cs.time_ms(torch, split, 50)
            full2 = cs.time_ms(
                torch, lambda: fs.fused_pipe_full_step(offs, data, *vecs, a1,
                                                       beta), 50)
            parts2 = cs.time_ms(torch, split, 50)
            emit("halo", band=kind, n=n, h=h, ndiag=len(offs), card=card,
                 full_step_ms=[full, full2], split_ms=[parts, parts2],
                 supports_full_step=fs.supports_full_step(offs))
            del data


#: permutations of chip_smoke.py's HPCG 27-point matrix (a) for `floors`
FLOOR_SEEDS = (cs.PERM_SEED, 1, 2)


def study_floors(torch, card):
    """chip_smoke.py's convergence matrix (a), HPCG's operator on 32^3 under
    three seeded permutations, with Jacobi and without: the suite on the card
    and on the CPU at CONV_ITERS, and ``row_compare``'s gaps between the two
    rows before the rounding floor and at it (the readings behind
    chip_smoke.py's CONV_FLOOR_TOL and CONV_NOISY_FLOOR_TOL)."""
    import tempfile
    import time
    import warnings

    from new_cg_variants_tpu_torch import write_mtx
    from new_cg_variants_tpu_torch.harness import convergence as hc
    from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy

    names = hc.DEFAULT_VARIANTS + ("exact_pcg",)
    for seed in FLOOR_SEEDS:
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            write_mtx(str(d / "hpcg27.mtx"),
                      coo_from_scipy(cs.stencil27(cs.CONV_GRID, seed)),
                      symmetric=True)
            for prec in ("jacobi", None):
                seconds = {}
                for dev in ("cuda", "cpu"):
                    t0 = time.perf_counter()
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")  # ELL's warning
                        hc.run_convergence_suite(
                            configs=[("hpcg27", cs.CONV_ITERS, prec)],
                            variants=hc.DEFAULT_VARIANTS,
                            table_variants=names, data_dir=d / dev,
                            fig_dir=d / "figures", matrix_dir=d,
                            include_exact=True, make_plots=False,
                            verbose=False, device=dev)
                    seconds[dev] = time.perf_counter() - t0
                rec, faults = cs.row_compare(hc, d / "cuda", d / "cpu",
                                             "hpcg27", prec, names)
                emit("floors", perm_seed=seed, preconditioner=prec,
                     iterations=cs.CONV_ITERS, seconds=seconds, **rec,
                     faults=faults, card=card)


def main(argv):
    import torch

    studies = {"check": study_check, "dfcheck": study_dfcheck,
               "symcheck": study_symcheck, "symopts": study_symopts,
               "ellcheck": study_ellcheck, "ellopts": study_ellopts,
               "bf16check": study_bf16check,
               "denseopts": study_denseopts, "pipeopts": study_pipeopts,
               "mutants": study_mutants,
               "bounds": study_bounds, "halo": study_halo,
               "floors": study_floors, "distcheck": study_distcheck}
    if not (len(argv) == 2 and argv[1] in studies
            or len(argv) == 3 and argv[1] == "mutants"
            and argv[2] in ("dia", "sym", "df", "ell", "bf16")):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_study: no CUDA device available", file=sys.stderr)
        return 1
    card = cs.card_line()
    emit(argv[1], card=card, torch=torch.__version__, cuda=torch.version.cuda)
    studies[argv[1]](torch, card, *argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
