// Double-word (f32x2) matrix-vector products, 1 or 2 right-hand sides, for a
// matrix held as an exact three-word split hi + lo + lo2 of its float64
// values (ops/doublefloat.py:df_split3) and double-word vectors vh + vl:
//
//   DIA:   y[i] = sum_d (hi + lo + lo2)[d, i] * v[i + off_d]   (v zero outside
//          [0, n)), each term a product with error-free transforms, the terms
//          added in stored order of the diagonals by double-word additions
//          (ops/df_spmv.py:_df_dia_mv_plain);
//   dense: y[i] = sum_j (hi + lo + lo2)[i, j] * v[j], the n terms of a row
//          summed by the double-word halving tree over the columns padded
//          with zero pairs to a power of two (ops/df_spmv.py:
//          _df_dense_mv_plain).
//
// Replaces the TPU kernels new_cg_variants_tpu/ops/df_spmv.py:_df_dia_kernel
// (entry points df_dia_spmv, df_dia_spmv2) and :_df_dense_kernel
// (df_dense_spmv, df_dense_spmv2).
//
// What bounds it on an H100: device-memory bytes and float32 operations about
// equally for the DIA product.  At n = 655,360 with 63 diagonals and 2
// right-hand sides it must read 3 words per stored value and 2 per vector
// entry and write 2 per result, 516 MB, 0.154 ms at 3.35 TB/s; the
// error-free product and the double-word addition are ~48 float32 operations
// per stored value and right-hand side, 3.96 G, 0.118 ms at 33.5 T
// operations/s (132 SMs x 128 lanes x 1.98 GHz; none of them may be a fused
// multiply-add).  The dense product at n = 4096 reads 3 n^2 words, 201 MB,
// 0.060 ms, against ~50 operations per value and right-hand side.
//
// What the design does about it:
// * DIA, as dia_spmv.cu: one thread per row, 256 rows per block, the three
//   band words read straight from device memory, coalesced, and shared by
//   both right-hand sides from registers; the hi and lo windows of each
//   vector staged in shared memory up to a combined halo of 1024 rows (the
//   wrapper's rule, ops/spmv_dia.py:stages_window), read through the
//   read-only cache beyond.  Any n, any offsets; rows outside [0, n) read 0.
// * Dense: one block of 256 threads per row.  The halving tree's order is
//   part of the result, so the kernel keeps it: thread t takes the columns
//   t, t + 256, ... of the padded width, the tree levels above 256 stay in
//   the thread (df_common.cuh:tree_sum), the last eight run in shared memory.
//   A block reads its row once, coalesced; the vector's words come from L2.
// * Every step as ops/compensated.py takes it, with the never-contracted
//   intrinsics of df_common.cuh, so the results are the plain versions' bits.

#include "df_common.cuh"

namespace ncgv {

// Largest staged window of each word array: kTile rows plus a combined halo
// of 1024 (ops/spmv_dia.py:MAX_STAGED_HALO).
constexpr int kDfMaxWindow = kTile + 1024;

// Device pointers of one launch: per right-hand side r, v[2r] / v[2r + 1]
// are its hi / lo words and y[2r] / y[2r + 1] those of its result.
struct DfVecs {
  const float* v[4];
  float* y[4];
};

template <int NRHS, bool STAGED>
__global__ void __launch_bounds__(kTile) df_dia_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo,
    const float* __restrict__ lo2, const __grid_constant__ Offsets o,
    int ndiag, int h_lo, int h_hi, long long n,
    const __grid_constant__ DfVecs a) {
  extern __shared__ __align__(16) float swin[];  // [2 NRHS][vw]
  __shared__ int soff[kMaxDiags];
  const int vw = kTile + h_lo + h_hi;
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kTile;

  load_offsets(o, ndiag, soff);
  if (STAGED) {
    for (int j = t; j < vw; j += kTile) {
      const long long g = i0 - h_lo + j;
      const bool in = g >= 0 && g < n;
#pragma unroll
      for (int q = 0; q < 2 * NRHS; ++q) swin[q * vw + j] = in ? a.v[q][g] : 0.0f;
    }
  }
  __syncthreads();

  const long long i = i0 + t;
  if (i >= n) return;
  Pair acc[NRHS];
#pragma unroll
  for (int r = 0; r < NRHS; ++r) acc[r] = {0.0f, 0.0f};
  for (int d = 0; d < ndiag; ++d) {
    const long long at = (long long)d * n + i;
    const float ah = __ldg(hi + at), al = __ldg(lo + at), al2 = __ldg(lo2 + at);
    const int off = soff[d];
#pragma unroll
    for (int r = 0; r < NRHS; ++r) {
      float vh, vl;
      if (STAGED) {
        vh = swin[(2 * r) * vw + t + h_lo + off];
        vl = swin[(2 * r + 1) * vw + t + h_lo + off];
      } else {
        const long long g = i + off;
        const bool in = g >= 0 && g < n;
        vh = in ? __ldg(a.v[2 * r] + g) : 0.0f;
        vl = in ? __ldg(a.v[2 * r + 1] + g) : 0.0f;
      }
      const Pair e = df_term(ah, al, al2, vh, vl);
      acc[r] = df_add(acc[r], fast_two_sum(e.hi, e.lo));
    }
  }
#pragma unroll
  for (int r = 0; r < NRHS; ++r) {
    a.y[2 * r][i] = acc[r].hi;
    a.y[2 * r + 1][i] = acc[r].lo;
  }
}

// Threads per row of the dense product.
constexpr int kDenseThreads = 256;

template <int NRHS>
__global__ void __launch_bounds__(kDenseThreads) df_dense_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo,
    const float* __restrict__ lo2, long long n, int width,
    const __grid_constant__ DfVecs a) {
  __shared__ Pair sred[NRHS * kDenseThreads];
  const long long row = (long long)blockIdx.x * n;
  auto leaf = [&](int c, Pair (&vals)[NRHS]) {
    if (c >= n) {
#pragma unroll
      for (int r = 0; r < NRHS; ++r) vals[r] = {0.0f, 0.0f};
      return;
    }
    const float ah = __ldg(hi + row + c), al = __ldg(lo + row + c),
                al2 = __ldg(lo2 + row + c);
#pragma unroll
    for (int r = 0; r < NRHS; ++r)
      vals[r] = df_term(ah, al, al2, __ldg(a.v[2 * r] + c),
                        __ldg(a.v[2 * r + 1] + c));
  };
  Pair sums[NRHS];
  tree_sum<NRHS>(width, leaf, sred, sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < NRHS; ++r) {
      a.y[2 * r][blockIdx.x] = sums[r].hi;
      a.y[2 * r + 1][blockIdx.x] = sums[r].lo;
    }
  }
}

DfVecs vectors_of(const void* const* v, void* const* y, int nrhs) {
  DfVecs a = {};
  for (int q = 0; q < 2 * nrhs; ++q) {
    a.v[q] = static_cast<const float*>(v[q]);
    a.y[q] = static_cast<float*>(y[q]);
  }
  return a;
}

int launch_df_dia(const void* hi, const void* lo, const void* lo2,
                  const int* offsets, int ndiag, long long n,
                  const void* const* v, void* const* y, int nrhs, int staged,
                  int device, void* stream) {
  Offsets o;
  if (!fill_offsets(offsets, ndiag, &o) || n <= 0 || (nrhs != 1 && nrhs != 2))
    return int(cudaErrorInvalidValue);
  int h_lo, h_hi;
  halo_of(offsets, ndiag, &h_lo, &h_hi);
  if (staged && kTile + h_lo + h_hi > kDfMaxWindow)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const DfVecs a = vectors_of(v, y, nrhs);
  const float* h = static_cast<const float*>(hi);
  const float* l = static_cast<const float*>(lo);
  const float* l2 = static_cast<const float*>(lo2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = unsigned((n + kTile - 1) / kTile);
  const size_t smem =
      staged ? size_t(2 * nrhs) * (kTile + h_lo + h_hi) * sizeof(float) : 0;
#define NCGV_DF_DIA(NRHS, STAGED)                                            \
  df_dia_kernel<NRHS, STAGED><<<grid, kTile, smem, st>>>(h, l, l2, o, ndiag, \
                                                         h_lo, h_hi, n, a)
  if (nrhs == 1) {
    if (staged) NCGV_DF_DIA(1, true);
    else NCGV_DF_DIA(1, false);
  } else {
    if (staged) NCGV_DF_DIA(2, true);
    else NCGV_DF_DIA(2, false);
  }
#undef NCGV_DF_DIA
  return int(cudaGetLastError());
}

int launch_df_dense(const void* hi, const void* lo, const void* lo2,
                    long long n, const void* const* v, void* const* y,
                    int nrhs, int device, void* stream) {
  const long long width = pow2_ceil(n);
  if (n <= 0 || (nrhs != 1 && nrhs != 2) ||
      width > ((long long)kDenseThreads << kMaxTreeDepth) || n > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const DfVecs a = vectors_of(v, y, nrhs);
  const float* h = static_cast<const float*>(hi);
  const float* l = static_cast<const float*>(lo);
  const float* l2 = static_cast<const float*>(lo2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nrhs == 1) {
    df_dense_kernel<1><<<unsigned(n), kDenseThreads, 0, st>>>(h, l, l2, n,
                                                              int(width), a);
  } else {
    df_dense_kernel<2><<<unsigned(n), kDenseThreads, 0, st>>>(h, l, l2, n,
                                                              int(width), a);
  }
  return int(cudaGetLastError());
}

}  // namespace ncgv

extern "C" {

// hi / lo / lo2: the (ndiag, n) band words; v / y: 2 nrhs device pointers
// (hi and lo words of each right-hand side and of each result); staged != 0
// asks for the shared-memory windows.
int df_dia_spmv_f32(const void* hi, const void* lo, const void* lo2,
                    const int* offsets, int ndiag, long long n,
                    const void* const* v, void* const* y, int nrhs, int staged,
                    int device, void* stream) {
  return ncgv::launch_df_dia(hi, lo, lo2, offsets, ndiag, n, v, y, nrhs,
                             staged, device, stream);
}

// hi / lo / lo2: the (n, n) matrix words, row-major; v / y as above.
int df_dense_spmv_f32(const void* hi, const void* lo, const void* lo2,
                      long long n, const void* const* v, void* const* y,
                      int nrhs, int device, void* stream) {
  return ncgv::launch_df_dense(hi, lo, lo2, n, v, y, nrhs, device, stream);
}

}  // extern "C"
