// Half-band symmetric SpMV, y = A v (1 right-hand side) or (A v, A w) (2).
//
// Replaces the TPU kernel new_cg_variants_tpu/ops/sym_dia.py:_sym_kernel
// (entry points sym_dia_spmv / sym_dia_spmv2).
//
// What bounds it on an H100: device-memory bytes.  Per call it must read the
// band (ndiag * n values) and each right-hand side once and write each result
// once; at n = 655,360, ndiag = 32, f32 that is 89.1 MB (1 RHS) or 94.4 MB
// (2 RHS), about 27 / 28 us at 3.35 TB/s; with the band stored in bf16
// (sym_dia_spmv_bf16: 2-byte band values, float32 vectors) 47.2 / 52.4 MB,
// 14 / 16 us.  The arithmetic (4 operations per
// stored value per RHS) is two orders of magnitude below the f32 peak, and the
// band is larger than the 50 MB L2, so nothing stays resident between calls.
//
// What the design does about it (sym_common.cuh): each thread reads the band
// values of its rows straight from device memory, the forward value coalesced
// and the mirror value from lines its block (or the previous one) just
// brought into L1 / L2, so the band crosses the memory bus about once and no
// block waits for a staging loop before its first product.  Each band value
// is loaded once for both right-hand sides.  The right-hand sides, which
// every row reads 2 ndiag - 1 times, are staged per block in shared memory
// (tile + 2h values each), which leaves occupancy to the registers: see
// kSymDiaMinBlocks.

#include "sym_common.cuh"

namespace ncgv {

// Blocks per SM the compiler must leave registers for (32 a thread); the
// windows take a few KB of shared memory per block and are never the limit.
template <typename T>
constexpr int kSymDiaMinBlocks = 8;

// Rows a thread owns (t + r kTile), and so rows a block owns.
constexpr int kSymDiaRows = 1;
constexpr int kSymDiaTile = kSymDiaRows * kTile;

template <typename T, typename D, int NRHS>
__global__ void __launch_bounds__(kTile, kSymDiaMinBlocks<T>)
    sym_dia_kernel(const D* __restrict__ data, const __grid_constant__ Offsets o,
                   int ndiag, int h, long long n, const T* __restrict__ v0,
                   const T* __restrict__ v1, T* __restrict__ y0,
                   T* __restrict__ y1) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const int vw = kSymDiaTile + 2 * h;
  T* sv = reinterpret_cast<T*>(smem);  // NRHS windows of vw
  const long long i0 = (long long)blockIdx.x * kSymDiaTile;

  load_offsets(o, ndiag, soff);
  load_window(v0, h, n, i0, vw, sv);
  if (NRHS == 2) load_window(v1, h, n, i0, vw, sv + vw);
  __syncthreads();

  T acc[kSymDiaRows][NRHS];
  sym_rows<T, D, kSymDiaRows, NRHS>(data, n, i0, ndiag, soff, sv, vw, h,
                                    acc);
#pragma unroll
  for (int r = 0; r < kSymDiaRows; ++r) {
    const long long i = i0 + threadIdx.x + r * kTile;
    if (i < n) {
      y0[i] = acc[r][0];
      if (NRHS == 2) y1[i] = acc[r][NRHS - 1];
    }
  }
}

// T: the vectors' type; D: the band's (T, or __nv_bfloat16 with T = float)
template <typename T, typename D = T>
int launch_sym_dia(const void* data, const int* offsets, int ndiag, int h,
                   long long n, const void* v0, const void* v1, void* y0,
                   void* y1, int nrhs, int device, void* stream) {
  Offsets o;
  if (!fill_offsets(offsets, ndiag, &o) || n <= 0 || h < 0 ||
      (nrhs != 1 && nrhs != 2))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t smem = size_t(nrhs) * (kSymDiaTile + 2 * h) * sizeof(T);
  const unsigned grid = unsigned((n + kSymDiaTile - 1) / kSymDiaTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const D* d = static_cast<const D*>(data);
  const T* a = static_cast<const T*>(v0);
  const T* b = static_cast<const T*>(v1);
  T* ya = static_cast<T*>(y0);
  T* yb = static_cast<T*>(y1);
  if (nrhs == 1) {
    err = allow_smem(sym_dia_kernel<T, D, 1>, smem);
    if (err != cudaSuccess) return int(err);
    sym_dia_kernel<T, D, 1><<<grid, kTile, smem, st>>>(d, o, ndiag, h, n, a,
                                                       b, ya, yb);
  } else {
    err = allow_smem(sym_dia_kernel<T, D, 2>, smem);
    if (err != cudaSuccess) return int(err);
    sym_dia_kernel<T, D, 2><<<grid, kTile, smem, st>>>(d, o, ndiag, h, n, a,
                                                       b, ya, yb);
  }
  return int(cudaGetLastError());
}

}  // namespace ncgv

extern "C" {

int sym_dia_spmv_f32(const void* data, const int* offsets, int ndiag, int h,
                     long long n, const void* v0, const void* v1, void* y0,
                     void* y1, int nrhs, int device, void* stream) {
  return ncgv::launch_sym_dia<float>(data, offsets, ndiag, h, n, v0, v1, y0,
                                     y1, nrhs, device, stream);
}

int sym_dia_spmv_f64(const void* data, const int* offsets, int ndiag, int h,
                     long long n, const void* v0, const void* v1, void* y0,
                     void* y1, int nrhs, int device, void* stream) {
  return ncgv::launch_sym_dia<double>(data, offsets, ndiag, h, n, v0, v1, y0,
                                      y1, nrhs, device, stream);
}

// data in bf16, v0 / v1 / y0 / y1 in float32
int sym_dia_spmv_bf16(const void* data, const int* offsets, int ndiag, int h,
                      long long n, const void* v0, const void* v1, void* y0,
                      void* y1, int nrhs, int device, void* stream) {
  return ncgv::launch_sym_dia<float, __nv_bfloat16>(
      data, offsets, ndiag, h, n, v0, v1, y0, y1, nrhs, device, stream);
}

}  // extern "C"
