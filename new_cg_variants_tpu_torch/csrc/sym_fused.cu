// One whole pipe-P / pipe-PR CG iteration on half-band storage, in one pass:
//
//   r2 = r - a1 s     w2 = w - a1 u     s2 = w2 + beta s
//   p2 = r2 + beta p  x2 = x + a1 p
//   u2 = A s2         w_out = A r2 (recompute) or w2 (no recompute)
//   block partials of p2.s2, r2.s2, s2.s2, r2.r2
//
// Replaces the TPU kernel new_cg_variants_tpu/ops/sym_fused.py:
// _sym_family_kernel as reached by fused_sym_pipe_full_step (the pipe entry,
// update order of _pipe_update / _pipe_update_norec).
//
// What bounds it on an H100: device-memory bytes.  It must read the band and
// six vectors and write six vectors: at n = 655,360, ndiag = 32, f32 that is
// 83.9 MB + 31.5 MB = 115.3 MB, about 34 us at 3.35 TB/s, against ~2.7 us of
// f32 arithmetic at the 67 TFLOP/s peak.
//
// What the design does about it:
// * The SpMV inputs s2 and r2 are never written and re-read: each block
//   applies the update to the rows it owns AND to the h rows on each side
//   that its SpMV reads (the TPU kernel gets the front halo from XLA and
//   carries the back one across its sequential grid; blocks here run in no
//   order).  The halo rows are computed by the same code as the owned rows
//   (one loop over the window, pipe_update below), so a row's value is the
//   same bit pattern in every block that computes it, FMA contraction
//   included.
// * Inputs and outputs are distinct buffers: a neighbour block reads the OLD
//   r, w, u, s of a row while its owner writes the new ones.
// * The four dot products leave the kernel as one (4,) partial per block,
//   reduced in a fixed order (warp shuffles, then warp sums in warp order);
//   the wrapper sums the (nblocks, 4) partials.  No atomics: runs repeat bit
//   for bit.
// * a1 and beta are read from device memory, so the host never waits for
//   the scalars of the previous iteration.

#include "sym_common.cuh"

namespace ncgv {

constexpr int kWarps = kTile / 32;

template <typename T>
__device__ __forceinline__ void pipe_update(T a1, T beta, T r, T w, T u, T s,
                                            T& r2, T& w2, T& s2) {
  r2 = r - a1 * s;
  w2 = w - a1 * u;
  s2 = w2 + beta * s;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_down_sync(0xffffffffu, v, m);
  return v;
}

template <typename T, bool RECOMPUTE>
__global__ void __launch_bounds__(kTile) sym_pipe_step_kernel(
    const T* __restrict__ data, const __grid_constant__ Offsets o, int ndiag,
    int h, long long n, const T* __restrict__ x, const T* __restrict__ r,
    const T* __restrict__ w, const T* __restrict__ u, const T* __restrict__ p,
    const T* __restrict__ s, const T* __restrict__ a1p,
    const T* __restrict__ betap, T* __restrict__ x2o, T* __restrict__ r2o,
    T* __restrict__ wo, T* __restrict__ p2o, T* __restrict__ s2o,
    T* __restrict__ u2o, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const int vw = kTile + 2 * h;
  T* sdata = reinterpret_cast<T*>(smem);
  T* ss2 = sdata + size_t(ndiag) * (kTile + h);
  T* sr2 = ss2 + vw;
  T* sred = sr2 + vw;  // 4 * kWarps
  const T a1 = *a1p;
  const T beta = *betap;
  const long long i0 = (long long)blockIdx.x * kTile;

  load_offsets(o, ndiag, soff);
  load_band(data, ndiag, h, n, i0, sdata);
  // r2 and s2 over the window [i0 - h, i0 + kTile + h): owned rows and halo
  for (int j = threadIdx.x; j < vw; j += blockDim.x) {
    const long long g = i0 - h + j;
    T r2 = T(0), w2 = T(0), s2 = T(0);
    if (g >= 0 && g < n) {
      pipe_update(a1, beta, r[g], w[g], u[g], s[g], r2, w2, s2);
      if (!RECOMPUTE && j >= h && j < h + kTile) wo[g] = w2;
    }
    sr2[j] = r2;
    ss2[j] = s2;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const long long i = i0 + t;
  T mu = T(0), delta = T(0), gamma = T(0), nu = T(0);
  if (i < n) {
    const T r2 = sr2[t + h];
    const T s2 = ss2[t + h];
    const T pv = p[i];
    const T p2 = r2 + beta * pv;
    x2o[i] = x[i] + a1 * pv;
    r2o[i] = r2;
    p2o[i] = p2;
    s2o[i] = s2;
    u2o[i] = sym_row(sdata, ss2, ndiag, h, soff, t);
    if (RECOMPUTE) wo[i] = sym_row(sdata, sr2, ndiag, h, soff, t);
    mu = p2 * s2;
    delta = r2 * s2;
    gamma = s2 * s2;
    nu = r2 * r2;
  }
  mu = warp_sum(mu);
  delta = warp_sum(delta);
  gamma = warp_sum(gamma);
  nu = warp_sum(nu);
  const int warp = t / 32;
  if ((t & 31) == 0) {
    sred[0 * kWarps + warp] = mu;
    sred[1 * kWarps + warp] = delta;
    sred[2 * kWarps + warp] = gamma;
    sred[3 * kWarps + warp] = nu;
  }
  __syncthreads();
  if (t < 4) {
    T acc = sred[t * kWarps];
    for (int k = 1; k < kWarps; ++k) acc += sred[t * kWarps + k];
    partials[size_t(blockIdx.x) * 4 + t] = acc;
  }
}

template <typename T>
int launch_sym_pipe_step(const void* data, const int* offsets, int ndiag,
                         int h, long long n, const void* const* in,
                         const void* a1, const void* beta, void* const* out,
                         void* partials, int recompute, int device,
                         void* stream) {
  Offsets o;
  if (!fill_offsets(offsets, ndiag, &o) || n <= 0 || h < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t smem = (size_t(ndiag) * (kTile + h) +
                       2 * size_t(kTile + 2 * h) + 4 * kWarps) *
                      sizeof(T);
  const unsigned grid = unsigned((n + kTile - 1) / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto I = [&](int k) { return static_cast<const T*>(in[k]); };
  auto O = [&](int k) { return static_cast<T*>(out[k]); };
  const T* d = static_cast<const T*>(data);
  const T* pa = static_cast<const T*>(a1);
  const T* pb = static_cast<const T*>(beta);
  T* part = static_cast<T*>(partials);
  // in: x r w u p s;  out: x2 r2 w_out p2 s2 u2
  if (recompute) {
    err = allow_smem(sym_pipe_step_kernel<T, true>, smem);
    if (err != cudaSuccess) return int(err);
    sym_pipe_step_kernel<T, true><<<grid, kTile, smem, st>>>(
        d, o, ndiag, h, n, I(0), I(1), I(2), I(3), I(4), I(5), pa, pb, O(0),
        O(1), O(2), O(3), O(4), O(5), part);
  } else {
    err = allow_smem(sym_pipe_step_kernel<T, false>, smem);
    if (err != cudaSuccess) return int(err);
    sym_pipe_step_kernel<T, false><<<grid, kTile, smem, st>>>(
        d, o, ndiag, h, n, I(0), I(1), I(2), I(3), I(4), I(5), pa, pb, O(0),
        O(1), O(2), O(3), O(4), O(5), part);
  }
  return int(cudaGetLastError());
}

}  // namespace ncgv

extern "C" {

// in: 6 device pointers (x r w u p s); out: 6 (x2 r2 w_out p2 s2 u2);
// partials: (ceil(n / 256), 4) device buffer; a1, beta: device scalars.
int sym_pipe_step_f32(const void* data, const int* offsets, int ndiag, int h,
                      long long n, const void* const* in, const void* a1,
                      const void* beta, void* const* out, void* partials,
                      int recompute, int device, void* stream) {
  return ncgv::launch_sym_pipe_step<float>(data, offsets, ndiag, h, n, in, a1,
                                           beta, out, partials, recompute,
                                           device, stream);
}

int sym_pipe_step_f64(const void* data, const int* offsets, int ndiag, int h,
                      long long n, const void* const* in, const void* a1,
                      const void* beta, void* const* out, void* partials,
                      int recompute, int device, void* stream) {
  return ncgv::launch_sym_pipe_step<double>(data, offsets, ndiag, h, n, in,
                                            a1, beta, out, partials,
                                            recompute, device, stream);
}

}  // extern "C"
