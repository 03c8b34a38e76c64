// Double-word (f32x2) arithmetic for the kernels of df_spmv.cu and df_pipe.cu:
// a value is the unevaluated sum hi + lo of two floats.  These are the
// functions of ops/compensated.py, step for step and in the same order, so a
// kernel and its plain PyTorch version round at the same places and give the
// same bits.
//
// The fault to design against is contraction: nvcc fuses a * b + c into one
// fused multiply-add by default (--fmad=true), which rounds once where the
// transforms below need two roundings.  Dekker's split t = c a; hi = t - (t -
// a) then stops being a split, the error word of every product changes, and
// double-word results collapse toward single precision while still looking
// plausible.  So every step goes through rn_add / rn_sub / rn_mul, whose
// intrinsics round once each and are never fused.  No other float arithmetic
// may appear in a double-word computation.
#pragma once

#include "sym_common.cuh"

namespace ncgv {

__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }

struct Pair {
  float hi, lo;
};

// Knuth 2Sum: a + b = s + e exactly.
__device__ __forceinline__ Pair two_sum(float a, float b) {
  const float s = rn_add(a, b);
  const float bb = rn_sub(s, a);
  return {s, rn_add(rn_sub(a, rn_sub(s, bb)), rn_sub(b, bb))};
}

// Dekker fast 2Sum; needs |a| >= |b|.
__device__ __forceinline__ Pair fast_two_sum(float a, float b) {
  const float s = rn_add(a, b);
  return {s, rn_sub(b, rn_sub(s, a))};
}

// Dekker split against 2^12 + 1.
__device__ __forceinline__ Pair split(float a) {
  const float t = rn_mul(4097.0f, a);
  const float hi = rn_sub(t, rn_sub(t, a));
  return {hi, rn_sub(a, hi)};
}

// Dekker 2Prod: a b = p + e exactly;
// e = ((ah bh - p) + ah bl + al bh) + al bl.
__device__ __forceinline__ Pair two_prod(float a, float b) {
  const float p = rn_mul(a, b);
  const Pair x = split(a), y = split(b);
  float e = rn_sub(rn_mul(x.hi, y.hi), p);
  e = rn_add(e, rn_mul(x.hi, y.lo));
  e = rn_add(e, rn_mul(x.lo, y.hi));
  return {p, rn_add(e, rn_mul(x.lo, y.lo))};
}

// Accurate double-word addition (compensated.py:df_add): two 2Sums, two
// renormalisations.
__device__ __forceinline__ Pair df_add(Pair a, Pair b) {
  const Pair s = two_sum(a.hi, b.hi);
  const Pair t = two_sum(a.lo, b.lo);
  const Pair u = fast_two_sum(s.hi, rn_add(s.lo, t.hi));
  return fast_two_sum(u.hi, rn_add(u.lo, t.lo));
}

__device__ __forceinline__ Pair df_neg(Pair a) { return {-a.hi, -a.lo}; }

// Double-word product (compensated.py:df_mul).
__device__ __forceinline__ Pair df_mul(Pair a, Pair b) {
  const Pair p = two_prod(a.hi, b.hi);
  const float x = rn_add(rn_add(rn_mul(a.hi, b.lo), rn_mul(a.lo, b.hi)),
                         rn_mul(a.lo, b.lo));
  return fast_two_sum(p.hi, rn_add(p.lo, x));
}

// One product of a three-word matrix value a + al + al2 (exact for an f64
// source) and a double-word vector value vh + vl, not yet renormalised:
// (p, e) with p + e = a vh exactly and the cross terms in e, summed
// ((a vl + al vh) + al vl) + al2 vh as the plain versions sum them.
__device__ __forceinline__ Pair df_term(float a, float al, float al2, float vh,
                                        float vl) {
  const Pair p = two_prod(a, vh);
  const float x = rn_add(
      rn_add(rn_add(rn_mul(a, vl), rn_mul(al, vh)), rn_mul(al, vl)),
      rn_mul(al2, vh));
  return {p.hi, rn_add(p.lo, x)};
}

// One term of a double-word dot product (compensated.py:df_dot_words), not
// yet renormalised: a.hi b.hi exactly, the cross terms in the error word.
__device__ __forceinline__ Pair dot_term(Pair a, Pair b) {
  const Pair p = two_prod(a.hi, b.hi);
  const float x = rn_add(rn_add(rn_mul(a.hi, b.lo), rn_mul(a.lo, b.hi)),
                         rn_mul(a.lo, b.lo));
  return {p.hi, rn_add(p.lo, x)};
}

// Chunk of leaf m of a thread's in-thread tree of 2^depth leaves: the leaves
// are taken in bit-reversed order, so that the tree pairs neighbours.
__device__ __forceinline__ int leaf_chunk(int m, int depth) {
  return depth ? int(__brev(unsigned(m)) >> (32 - depth)) : 0;
}

__device__ __forceinline__ Pair shfl_xor(Pair v, int mask) {
  return {__shfl_xor_sync(0xffffffffu, v.hi, mask),
          __shfl_xor_sync(0xffffffffu, v.lo, mask)};
}

__device__ __forceinline__ Pair shfl_down(Pair v, int off) {
  return {__shfl_down_sync(0xffffffffu, v.hi, off),
          __shfl_down_sync(0xffffffffu, v.lo, off)};
}

// The last five levels of the halving tree of four sums over one warp (lane
// l holds element l of each), lane 0 ending with the four sums.  The sums
// split over the lanes as the tree narrows: at w = 32 lanes l and l + 16
// swap two of their four sums (l < 16 keeps sums 0 and 1), at w = 16 lanes
// l and l + 8 one of their two; sum d then halves over the lanes 8d ..
// 8d + 7 (w = 8, 4, 2), and lane 0 gathers the four.  Each lane adds six
// pairs, not twenty, and every addition is the halving tree's, operands in
// its order (element j, then element j + w/2), so the bits are its bits.
// Every lane of the warp must call it.
__device__ __forceinline__ void warp_tree_sum4(Pair (&v)[4]) {
  const int lane = threadIdx.x & 31;
  const bool low = lane < 16;
  Pair a[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const Pair keep = low ? v[k] : v[k + 2];
    const Pair got = shfl_xor(low ? v[k + 2] : v[k], 16);
    a[k] = df_add(low ? keep : got, low ? got : keep);
  }
  const bool first = (lane & 8) == 0;
  const Pair keep = first ? a[0] : a[1];
  const Pair got = shfl_xor(first ? a[1] : a[0], 8);
  Pair b = df_add(first ? keep : got, first ? got : keep);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) b = df_add(b, shfl_down(b, off));
#pragma unroll
  for (int d = 0; d < 4; ++d)
    v[d] = {__shfl_sync(0xffffffffu, b.hi, 8 * d),
            __shfl_sync(0xffffffffu, b.lo, 8 * d)};
}

// The halving tree over segments of `width` threads (a power of two that
// divides blockDim.x): each segment sums NR pairs, one a thread; level w adds
// element j + w/2 to element j, w = width, ..., 2, and the segment's first
// thread ends with the sums in v.  The levels w > 32 pair threads of
// different warps (t with t + 128, t + 64, t + 32) through shared memory, one
// region of sred a level; the last five pair lanes of one warp by shuffles
// with no barrier (four sums over a whole warp: warp_tree_sum4).  The pairs
// are the same either way, so the bits are too.  sred holds NR * blockDim.x
// pairs, one region a level, so that no level waits for the previous one's
// readers; every thread of the block must call it.
template <int NR>
__device__ __forceinline__ void block_tree_sum(Pair (&v)[NR], int width,
                                               Pair* sred) {
  const int t = threadIdx.x & (width - 1);
  Pair* region = sred + NR * (threadIdx.x - t);
  for (int w = width; w > 32; w >>= 1) {
    const int half = w >> 1;
    if (t >= half && t < w) {
#pragma unroll
      for (int r = 0; r < NR; ++r) region[r * half + t - half] = v[r];
    }
    __syncthreads();
    if (t < half) {
#pragma unroll
      for (int r = 0; r < NR; ++r) v[r] = df_add(v[r], region[r * half + t]);
    }
    region += NR * half;
  }
  if (t >= 32) return;  // whole warps: a segment's first, or all of a narrow one
  if constexpr (NR == 4) {
    if (width >= 32) {
      warp_tree_sum4(v);
      return;
    }
  }
  for (int off = (width < 32 ? width : 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < NR; ++r) v[r] = df_add(v[r], shfl_down(v[r], off));
  }
}

// Deepest in-thread tree tree_sum takes: width <= blockDim.x << 10.
constexpr int kMaxTreeDepth = 10;

// NR sums of the pairs leaf(c) over the columns c in [0, width), width a
// power of two (leaf gives (0, 0) past the data: the plain versions pad with
// zero pairs), by the halving tree of the plain versions
// (compensated.py:_df_tree_sum, _df_sum_axis1): element j + w/2 is added to
// element j for w = width, width / 2, ..., 2.
//
// Thread t (of teff = min(width, blockDim.x) that take part) owns the columns
// t + k teff, k < count = width / teff.  The levels w > teff pair k with
// k + count/2, ..., so they stay inside the thread: an adjacent-pairs tree
// over k taken in bit-reversed order (leaf_chunk), walked leaf by leaf with
// one partial sum per level like a binary counter.  The trailing ones of the
// leaf's index say how many levels it completes, walked by a loop that
// branches (the index is the same on every thread), so that no
// predicated-off addition is issued.  The last log2(teff) levels are
// block_tree_sum's.  leaf(c, vals) fills vals[r] for each of the NR sums.
// Every thread of the block must call it; thread 0 gets the sums.
template <int NR, typename Leaf>
__device__ __forceinline__ void tree_sum(int width, const Leaf& leaf,
                                         Pair* sred, Pair (&out)[NR]) {
  const int t = threadIdx.x;
  const int teff = width < int(blockDim.x) ? width : int(blockDim.x);
  const int count = width / teff;
  const int depth = 31 - __clz(count);
#pragma unroll
  for (int r = 0; r < NR; ++r) out[r] = {0.0f, 0.0f};
  if (t < teff) {
    Pair slot[NR][kMaxTreeDepth + 1];
    for (int m = 0; m < count; ++m) {
      Pair vals[NR];
      leaf(t + teff * leaf_chunk(m, depth), vals);
      const int tz = __ffs(~m) - 1;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        Pair carry = vals[r];
#pragma unroll 1
        for (int l = 0; l < tz; ++l) carry = df_add(slot[r][l], carry);
        slot[r][tz] = carry;
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) out[r] = slot[r][depth];
  }
  block_tree_sum<NR>(out, teff, sred);
}

// NR sums of the pairs term(words, c, vals) over the columns c in
// [0, width) of one row, width a power of two, on one warp, by the same
// halving tree as tree_sum: element j + w/2 is added to element j for
// w = width, ..., 2.
//
// Lane l owns the columns l + 32 k, k < count = width / 32 (for width < 32,
// lanes l < width own column l, count = 1).  The levels w > 32 pair k with
// k + count/2, ..., so they stay in the lane, an adjacent-pairs tree over k
// taken in bit-reversed order (leaf_chunk): groups of G = 2^LG consecutive
// leaves are summed by a fixed tree, and the group sums enter a binary
// counter of MAXD levels (count <= G << (MAXD - 1)).  fetch(cols, words)
// fills the words (of type Words) that the group's G leaves stream from
// device memory, at the columns cols[j] of this lane.  The last
// log2(min(width, 32)) levels pair lane l with lane l + w/2 through
// __shfl_down_sync: no shared memory, no block barrier.  Every lane of the
// warp must call it (with one width); lane 0 gets the sums.
template <int NR, int LG, int MAXD, typename Words, typename Fetch,
          typename Term>
__device__ __forceinline__ void warp_tree_sum(int width, const Fetch& fetch,
                                              const Term& term,
                                              Pair (&out)[NR]) {
  constexpr int G = 1 << LG;
  const int lane = threadIdx.x & 31;
  const int lanes = width < 32 ? width : 32;
  const int count = width / lanes;
  const int depth = 31 - __clz(count);
  const int groups = count >> LG;
  Pair slot[NR][MAXD];
  for (int g = 0; g < groups; ++g) {
    int cols[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      cols[j] = lane + 32 * leaf_chunk((g << LG) + j, depth);
    Words cur[G];
    fetch(cols, cur);
    Pair t[NR][G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      Pair vals[NR];
      term(cur[j], cols[j], vals);
#pragma unroll
      for (int r = 0; r < NR; ++r) t[r][j] = vals[r];
    }
#pragma unroll
    for (int s = 1; s < G; s <<= 1) {
#pragma unroll
      for (int j = 0; j < G; j += 2 * s) {
#pragma unroll
        for (int r = 0; r < NR; ++r) t[r][j] = df_add(t[r][j], t[r][j + s]);
      }
    }
    // the counter: the trailing ones of g say how many levels this group
    // sum completes; a loop that branches (g is the same on every lane), so
    // that no predicated-off addition is issued
    const int tz = __ffs(~g) - 1;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      Pair carry = t[r][0];
#pragma unroll 1
      for (int l = 0; l < tz; ++l) carry = df_add(slot[r][l], carry);
      slot[r][tz] = carry;
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) out[r] = slot[r][depth - LG];
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const Pair o = {__shfl_down_sync(0xffffffffu, out[r].hi, off),
                      __shfl_down_sync(0xffffffffu, out[r].lo, off)};
      out[r] = df_add(out[r], o);
    }
  }
}

// The smallest power of two >= x (x >= 1).
__host__ __device__ inline long long pow2_ceil(long long x) {
  long long m = 1;
  while (m < x) m <<= 1;
  return m;
}

}  // namespace ncgv
