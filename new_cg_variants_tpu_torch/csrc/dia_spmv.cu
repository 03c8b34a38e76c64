// Full-DIA SpMV, y = A v (1 right-hand side) or (A v, A w) (2), for a banded
// matrix stored by diagonals at arbitrary offsets:
//   y[i] = sum_d data[d, i] * V[i + off_d],   data row-major (ndiag, n),
// with V[j] = v[j + vorg] where 0 <= j + vorg < vlen and 0 elsewhere.  For a
// whole matrix vorg = 0 and vlen = n (zeros outside [0, n) are the matrix
// edge); for a row shard whose vector arrives as [left h | v | right h]
// (the _ext entries) vorg = h and vlen = n + 2h.
//
// Replaces the TPU kernel new_cg_variants_tpu/ops/spmv_pallas.py:_dia_kernel
// (entry points dia_spmv, dia_spmv2, dia_spmv_ext, dia_spmv2_ext).
//
// What bounds it on an H100: device-memory bytes.  Per call it must read the
// band (ndiag * n values) and each right-hand side once and write each result
// once; at n = 655,360 with 63 diagonals in f32 that is 170.4 MB (1 RHS) or
// 175.6 MB (2 RHS), 51 / 52 us at 3.35 TB/s, against 1.2-2.5 us of f32
// arithmetic (2 operations per stored value per RHS) at the 67 TFLOP/s peak.
// The band is larger than the 50 MB L2, so nothing stays resident.  With the
// band stored in bf16 (dia_spmv_bf16: 2-byte band values, float32 vectors;
// sym_common.cuh, "Storage and compute types") 87.8 / 93.1 MB, 26 / 28 us.
//
// What the design does about it:
// * One thread per row, 256 rows per block.  Every stored value is used once
//   (there is no mirror term as in the half-band kernel), so the band is NOT
//   staged in shared memory: data[d, i0 + t] is read straight from device
//   memory, coalesced across the block, and shared by both right-hand sides
//   from a register.
// * The vector is what gets reused (ndiag times), so a block stages its window
//   V[i0 - h_lo, i0 + 256 + h_hi) in shared memory once (h_lo = max(-off),
//   h_hi = max(off)) and every product reads shared memory.  When the offsets
//   reach far (a 5-diagonal grid operator with offsets +-2048) the window
//   would be many times the values read from it; the wrapper then asks for
//   the direct form, which reads V through the read-only cache.
// * Any n, any offsets, negative ones too; the ragged last block and the
//   matrix edge are masked, no padded copies of the operands are made (the
//   TPU kernel pads both and passes the padded vector twice to fake a
//   window).
// * Terms are added in stored order of the diagonals, as the plain version
//   adds them.
// * Occupancy: the loop over the diagonals is all loads, so the more blocks
//   an SM holds the better the latency hides; see kDiaMinBlocks.

#include "sym_common.cuh"

namespace ncgv {

// Largest staged window (values per right-hand side): kTile rows plus a
// combined halo of 1024 (ops/spmv_dia.py:MAX_STAGED_HALO).
constexpr int kMaxWindow = kTile + 1024;

// Blocks per SM the compiler must leave registers for (shared memory is a
// few KB per block and never the limit).
template <typename T>
constexpr int kDiaMinBlocks = sizeof(T) == 4 ? 8 : 4;

template <typename T, typename D, int NRHS, bool STAGED>
__global__ void __launch_bounds__(kTile, kDiaMinBlocks<T>) dia_spmv_kernel(
    const D* __restrict__ data, const __grid_constant__ Offsets o, int ndiag,
    int h_lo, int h_hi, long long n, const T* __restrict__ v0,
    const T* __restrict__ v1, long long vorg, long long vlen,
    T* __restrict__ y0, T* __restrict__ y1) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const int vw = kTile + h_lo + h_hi;
  T* sv0 = reinterpret_cast<T*>(smem);
  T* sv1 = sv0 + vw;
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kTile;

  load_offsets(o, ndiag, soff);
  if (STAGED) {
    for (int j = t; j < vw; j += kTile) {
      const long long g = i0 - h_lo + j + vorg;
      const bool in = g >= 0 && g < vlen;
      sv0[j] = in ? v0[g] : T(0);
      if (NRHS == 2) sv1[j] = in ? v1[g] : T(0);
    }
  }
  __syncthreads();

  const long long i = i0 + t;
  if (i >= n) return;
  const D* col = data + i;
  const int c = t + h_lo;  // row i in window coordinates
  T acc0 = T(0), acc1 = T(0);
#pragma unroll 8
  for (int d = 0; d < ndiag; ++d) {
    const T a = widen(__ldg(col + (long long)d * n));
    const int off = soff[d];
    T x0, x1 = T(0);
    if (STAGED) {
      x0 = sv0[c + off];
      if (NRHS == 2) x1 = sv1[c + off];
    } else {
      const long long g = i + off + vorg;
      const bool in = g >= 0 && g < vlen;
      x0 = in ? __ldg(v0 + g) : T(0);
      if (NRHS == 2) x1 = in ? __ldg(v1 + g) : T(0);
    }
    acc0 += a * x0;
    if (NRHS == 2) acc1 += a * x1;
  }
  y0[i] = acc0;
  if (NRHS == 2) y1[i] = acc1;
}

template <typename T, typename D, int NRHS, bool STAGED>
int launch_dia_kernel(const D* data, const Offsets& o, int ndiag, int h_lo,
                      int h_hi, long long n, const T* v0, const T* v1,
                      long long vorg, long long vlen, T* y0, T* y1,
                      cudaStream_t st) {
  const size_t smem =
      STAGED ? size_t(NRHS) * (kTile + h_lo + h_hi) * sizeof(T) : 0;
  const unsigned grid = unsigned((n + kTile - 1) / kTile);
  dia_spmv_kernel<T, D, NRHS, STAGED><<<grid, kTile, smem, st>>>(
      data, o, ndiag, h_lo, h_hi, n, v0, v1, vorg, vlen, y0, y1);
  return int(cudaGetLastError());
}

// T: the vectors' type; D: the band's (T, or __nv_bfloat16 with T = float)
template <typename T, typename D = T>
int launch_dia_spmv(const void* data, const int* offsets, int ndiag,
                    long long n, const void* v0, const void* v1,
                    long long vorg, long long vlen, void* y0, void* y1,
                    int nrhs, int staged, int device, void* stream) {
  Offsets o;
  if (!fill_offsets(offsets, ndiag, &o) || n <= 0 || vlen <= 0 ||
      (nrhs != 1 && nrhs != 2))
    return int(cudaErrorInvalidValue);
  int h_lo, h_hi;
  halo_of(offsets, ndiag, &h_lo, &h_hi);
  if (staged && kTile + h_lo + h_hi > kMaxWindow)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const D* d = static_cast<const D*>(data);
  const T* a = static_cast<const T*>(v0);
  const T* b = static_cast<const T*>(v1);
  T* ya = static_cast<T*>(y0);
  T* yb = static_cast<T*>(y1);
#define NCGV_DIA(NRHS, STAGED)                                               \
  return launch_dia_kernel<T, D, NRHS, STAGED>(d, o, ndiag, h_lo, h_hi, n,   \
                                               a, b, vorg, vlen, ya, yb, st)
  if (nrhs == 1) {
    if (staged) NCGV_DIA(1, true);
    NCGV_DIA(1, false);
  }
  if (staged) NCGV_DIA(2, true);
  NCGV_DIA(2, false);
#undef NCGV_DIA
}

}  // namespace ncgv

extern "C" {

// v0 / v1: the right-hand side(s), of length vlen, whose element vorg is
// column 0 of the matrix; staged != 0 asks for the shared-memory window.
int dia_spmv_f32(const void* data, const int* offsets, int ndiag, long long n,
                 const void* v0, const void* v1, long long vorg,
                 long long vlen, void* y0, void* y1, int nrhs, int staged,
                 int device, void* stream) {
  return ncgv::launch_dia_spmv<float>(data, offsets, ndiag, n, v0, v1, vorg,
                                      vlen, y0, y1, nrhs, staged, device,
                                      stream);
}

int dia_spmv_f64(const void* data, const int* offsets, int ndiag, long long n,
                 const void* v0, const void* v1, long long vorg,
                 long long vlen, void* y0, void* y1, int nrhs, int staged,
                 int device, void* stream) {
  return ncgv::launch_dia_spmv<double>(data, offsets, ndiag, n, v0, v1, vorg,
                                       vlen, y0, y1, nrhs, staged, device,
                                       stream);
}

// data in bf16, v0 / v1 / y0 / y1 in float32
int dia_spmv_bf16(const void* data, const int* offsets, int ndiag,
                  long long n, const void* v0, const void* v1,
                  long long vorg, long long vlen, void* y0, void* y1,
                  int nrhs, int staged, int device, void* stream) {
  return ncgv::launch_dia_spmv<float, __nv_bfloat16>(
      data, offsets, ndiag, n, v0, v1, vorg, vlen, y0, y1, nrhs, staged,
      device, stream);
}

}  // extern "C"
