// Shared pieces of the band kernels.  The half-band ones (sym_dia.cu,
// sym_family.cu) use all of it; the full-DIA ones (dia_spmv.cu, dia_family.cu)
// and pipe_vector.cu use the tile, the offsets and the reductions.
//
// Half-band storage:
// data[d, i] = A[i, i + off_d] for the stored offsets off_0 = 0 <
// off_1 < ... (main + upper diagonals), row-major (ndiag, n), explicit zeros
// past the matrix edge.  The half-band h is the largest stored offset.  Row i
// of the product is
//   (A v)_i = data[0, i] v_i
//           + sum_{d >= 1} (data[d, i] v_{i + off_d}             (forward)
//                           + data[d, i - off_d] v_{i - off_d})  (mirror).
//
// Every kernel gives each block a tile of rows starting at i0.  Blocks run in
// no order, so a block cannot inherit the mirror term from its neighbour (the
// TPU kernels carry it across a sequential grid in a spill scratch).  Instead
// the thread of row i reads both band values of a diagonal itself, straight
// from device memory (sym_rows): the forward value data[d, i], coalesced and
// used once, and the mirror value data[d, i - off], which lies on lines that
// this block's warps (or, for its first off rows, the previous block) loaded
// moments earlier, so it comes from L1 or L2 and the band crosses the memory
// bus about once.  What a row reuses is the right-hand side: each block
// stages its window v[i0 - h : i0 + tile + h) in shared memory (tile + 2h
// values per right-hand side; rows outside [0, n) are zeros, so no load goes
// out of bounds).
//
// The band is stored as D and computed with in T (storage.cuh).
#pragma once

#include "storage.cuh"

namespace ncgv {

constexpr int kTile = 256;       // rows per block == threads per block
constexpr int kMaxDiags = 256;   // stored diagonals a launch can take

// The stored offsets, passed by value as a kernel parameter.  Each block
// copies them to shared memory first (load_offsets), so the loop over the
// diagonals indexes shared memory, not the parameter block.
struct Offsets {
  int off[kMaxDiags];
};

__device__ __forceinline__ void load_offsets(const Offsets& o, int ndiag,
                                             int* soff) {
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) soff[d] = o.off[d];
}

// Stage v[i0 - h : i0 - h + vw) into sv.
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ v, int h,
                                            long long n, long long i0, int vw,
                                            T* sv) {
  for (int j = threadIdx.x; j < vw; j += blockDim.x) {
    const long long g = i0 - h + j;
    sv[j] = (g >= 0 && g < n) ? v[g] : T(0);
  }
}

// The forward band value: read once, coalesced.  In f32 and bf16 it streams
// (evict-first); in f64 a plain load is faster (chip_study.py symopts times
// each hint in both types).  The mirror loads are never evict-first: they
// need the lines the forward loads just brought in.
template <typename D>
__device__ __forceinline__ auto band_load(const D* p) {
  if constexpr (sizeof(D) <= 4) {
    return widen(__ldcs(p));
  } else {
    return widen(*p);
  }
}

// (A v)_i for each of thread t's R rows i = i0 + t + r kTile and each of the
// NMV staged windows smv (stride vw; row i at window position i - i0 + h),
// from one read of the band (stored as D, widened to T).  Same terms in the same order as the plain
// version (sym_dia.py:_mv_plain): the main term, then per diagonal the
// forward term and then the mirror term, each a multiply-add into the row's
// accumulator.  Where i - off < 0 the mirror value is a zero rather than a
// load, and the window holds a zero there too: the zero term is still added,
// as it was when the band was staged with zeros, so every sum keeps its bits
// (-0.0 included).  Rows at or past n read nothing and give zeros.
template <typename T, typename D, int R, int NMV>
__device__ __forceinline__ void sym_rows(const D* __restrict__ data,
                                         long long n, long long i0, int ndiag,
                                         const int* soff, const T* smv, int vw,
                                         int h, T (&acc)[R][NMV]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + t + r * kTile;
    const int c = t + r * kTile + h;
    const T a = i < n ? band_load(data + i) : T(0);
#pragma unroll
    for (int k = 0; k < NMV; ++k) acc[r][k] = a * smv[k * vw + c];
  }
#pragma unroll 4
  for (int d = 1; d < ndiag; ++d) {
    const int off = soff[d];
    const D* row = data + (long long)d * n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = i0 + t + r * kTile;
      const int c = t + r * kTile + h;
      const T af = i < n ? band_load(row + i) : T(0);
      const T am = (i < n && i >= off) ? widen(__ldg(row + i - off)) : T(0);
#pragma unroll
      for (int k = 0; k < NMV; ++k) {
        acc[r][k] += af * smv[k * vw + c + off];
        acc[r][k] += am * smv[k * vw + c - off];
      }
    }
  }
}

constexpr int kWarps = kTile / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_down_sync(0xffffffffu, v, m);
  return v;
}

// Sum each of the block's ND per-thread products in a fixed order (warp
// shuffles, then the warp sums in warp order) and write the ND sums to out.
// sred holds ND * kWarps values.  Every thread of the block must call it.
template <typename T, int ND>
__device__ __forceinline__ void block_dots(const T (&prod)[ND], T* sred,
                                           T* out) {
  const int t = threadIdx.x;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const T v = warp_sum(prod[d]);
    if ((t & 31) == 0) sred[d * kWarps + t / 32] = v;
  }
  __syncthreads();
  if (t < ND) {
    T acc = sred[t * kWarps];
    for (int k = 1; k < kWarps; ++k) acc += sred[t * kWarps + k];
    out[t] = acc;
  }
}

// Copy the host offsets into the by-value parameter block.
inline bool fill_offsets(const int* host, int ndiag, Offsets* o) {
  if (ndiag < 1 || ndiag > kMaxDiags) return false;
  for (int d = 0; d < ndiag; ++d) o->off[d] = host[d];
  return true;
}

// Full-DIA kernels: the rows a row's products reach before it, h_lo =
// max(-off, 0), and after it, h_hi = max(off, 0), over the stored offsets.
inline void halo_of(const int* offsets, int ndiag, int* h_lo, int* h_hi) {
  *h_lo = 0;
  *h_hi = 0;
  for (int d = 0; d < ndiag; ++d) {
    if (-offsets[d] > *h_lo) *h_lo = -offsets[d];
    if (offsets[d] > *h_hi) *h_hi = offsets[d];
  }
}

// Kernels above 48 KB of dynamic shared memory must opt in first.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace ncgv
