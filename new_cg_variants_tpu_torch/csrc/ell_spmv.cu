// Padded-ELL SpMV, y = A v (1 right-hand side) or (A v, A w) (2), for a
// general sparse matrix stored as L slots per row:
//   y[i] = sum_l val[i, l] * v[idx[i, l]],
// padding slots holding value 0 and index i.  The arrays arrive slot-major:
// val_t[l * n + i] = val[i, l], idx_t[l * n + i] = idx[i, l] (int32).
//
// Replaces the TPU kernel new_cg_variants_tpu/ops/ell_pallas.py:_ell_kernel
// (entry points ell_spmv, ell_spmv2).  That kernel tiles 512 rows and keeps
// the whole vector in VMEM (n <= 4M); both are TPU limits and are not
// carried over: any n < 2^31, any L >= 1.
//
// What bounds it on an H100: device-memory bytes.  Per call it must read
// val and idx once (n L (s + 4) bytes, s the value size), each right-hand
// side once and write each result once: at n = 1,124,864 and L = 27 in f32
// (HPCG's 27-point operator) 252 MB, 75 us at 3.35 TB/s (2 RHS: 78 us),
// against ~1 us of arithmetic (2 operations per slot per RHS) at 67 TFLOP/s.
// The gathers of v are the other cost: each reads a 32-byte sector for one
// value.  v (4.5 MB in f32) fits the 50 MB L2, so a gather in a scattered
// (permuted) order is an L2 hit, not a device-memory read; in natural order
// neighbouring rows gather neighbouring columns and share sectors.
//
// What the design does about it:
// * One thread per row, 256 rows per block.  Slot-major storage makes
//   slot l of 32 neighbouring rows one coalesced 128-byte read (the
//   row-major (n, L) layout would stride the warp by L values).
// * v is gathered through the read-only path (__ldg); val and idx are read
//   once and never staged: there is nothing to reuse.
// * With 2 right-hand sides each val / idx word is read once for both.
// * Terms are added in slot order; no atomics, no shared memory.

#include <cuda_runtime.h>

namespace ncgv {

constexpr int kEllThreads = 256;

template <typename T, int NRHS>
__global__ void __launch_bounds__(kEllThreads) ell_spmv_kernel(
    const T* __restrict__ val_t, const int* __restrict__ idx_t, int L,
    long long n, const T* __restrict__ v0, const T* __restrict__ v1,
    T* __restrict__ y0, T* __restrict__ y1) {
  const long long i = (long long)blockIdx.x * kEllThreads + threadIdx.x;
  if (i >= n) return;
  const T* a = val_t + i;
  const int* c = idx_t + i;
  T acc0 = T(0), acc1 = T(0);
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    const long long o = (long long)l * n;
    const T x = __ldg(a + o);
    const int j = __ldg(c + o);
    acc0 += x * __ldg(v0 + j);
    if (NRHS == 2) acc1 += x * __ldg(v1 + j);
  }
  y0[i] = acc0;
  if (NRHS == 2) y1[i] = acc1;
}

template <typename T>
int launch_ell_spmv(const void* val_t, const void* idx_t, int L, long long n,
                    const void* v0, const void* v1, void* y0, void* y1,
                    int nrhs, int device, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || L < 1 || (nrhs != 1 && nrhs != 2))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = unsigned((n + kEllThreads - 1) / kEllThreads);
  const T* a = static_cast<const T*>(val_t);
  const int* c = static_cast<const int*>(idx_t);
  const T* x0 = static_cast<const T*>(v0);
  const T* x1 = static_cast<const T*>(v1);
  T* r0 = static_cast<T*>(y0);
  T* r1 = static_cast<T*>(y1);
  if (nrhs == 1)
    ell_spmv_kernel<T, 1><<<grid, kEllThreads, 0, st>>>(a, c, L, n, x0, x1,
                                                        r0, r1);
  else
    ell_spmv_kernel<T, 2><<<grid, kEllThreads, 0, st>>>(a, c, L, n, x0, x1,
                                                        r0, r1);
  return int(cudaGetLastError());
}

}  // namespace ncgv

extern "C" {

// val_t / idx_t: (L, n) slot-major, contiguous; v1 / y1 unused when nrhs = 1.
int ell_spmv_f32(const void* val_t, const void* idx_t, int L, long long n,
                 const void* v0, const void* v1, void* y0, void* y1, int nrhs,
                 int device, void* stream) {
  return ncgv::launch_ell_spmv<float>(val_t, idx_t, L, n, v0, v1, y0, y1,
                                      nrhs, device, stream);
}

int ell_spmv_f64(const void* val_t, const void* idx_t, int L, long long n,
                 const void* v0, const void* v1, void* y0, void* y1, int nrhs,
                 int device, void* stream) {
  return ncgv::launch_ell_spmv<double>(val_t, idx_t, L, n, v0, v1, y0, y1,
                                       nrhs, device, stream);
}

}  // extern "C"
