// Shared pieces of the band kernels.  The half-band ones (sym_dia.cu,
// sym_family.cu) use all of it; the full-DIA ones (dia_spmv.cu, dia_family.cu)
// and pipe_vector.cu use the tile, the offsets and the reductions.
//
// Half-band storage:
// data[d, i] = A[i, i + off_d] for the stored offsets off_0 = 0 <
// off_1 < ... (main + upper diagonals), row-major (ndiag, n), explicit zeros
// past the matrix edge.  The half-band h is the largest stored offset.
//
// Every kernel gives each block a tile of kTile rows [i0, i0 + kTile) and one
// thread per row.  Blocks run in no order, so a block cannot inherit the
// mirror term data[d, i - off] * v[i - off] from its neighbour (the TPU
// kernels carry it across a sequential grid in a spill scratch).  Instead
// every block stages what its rows need in shared memory:
//   data[:, i0 - h : i0 + kTile)      (ndiag * (kTile + h) values)
//   v[i0 - h : i0 + kTile + h)        (kTile + 2h values per right-hand side)
// so the band is read from device memory (1 + h / kTile) times, about once.
// Rows outside [0, n) are staged as zeros: they contribute nothing, and no
// load goes out of bounds.
#pragma once

#include <cuda_runtime.h>

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

// Stage data[:, i0 - h : i0 + kTile) into sdata (row stride kTile + h).
template <typename T>
__device__ __forceinline__ void load_band(const T* __restrict__ data,
                                          int ndiag, int h, long long n,
                                          long long i0, T* sdata) {
  const int dw = kTile + h;
  const int total = ndiag * dw;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int d = idx / dw;
    const long long g = i0 - h + (idx - d * dw);
    sdata[idx] = (g >= 0 && g < n) ? data[(long long)d * n + g] : T(0);
  }
}

// Stage v[i0 - h : i0 + kTile + h) into sv.
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ v, int h,
                                            long long n, long long i0,
                                            T* sv) {
  const int vw = kTile + 2 * h;
  for (int j = threadIdx.x; j < vw; j += blockDim.x) {
    const long long g = i0 - h + j;
    sv[j] = (g >= 0 && g < n) ? v[g] : T(0);
  }
}

// (A v)[i0 + t] from the staged band and window.  Same term order as the
// plain version (sym_dia.py:_mv_plain): main, then per diagonal the forward
// term data[d, i] v[i + off] and the mirror term data[d, i - off] v[i - off].
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
