// The vector phase of a pipelined predict(-and-recompute) CG iteration in one
// pass: the AXPY-class updates and the four dot products of the iteration's
// single synchronization phase, with no SpMV.
//
//   unpreconditioned (6 in, 5 out):
//     x2 = x + a1 p;  r2 = r - a1 s;  w2 = w - a1 u;
//     p2 = r2 + beta p;  s2 = w2 + beta s;
//     dots = (p2.s2, r2.s2, s2.s2, r2.r2)
//   preconditioned (10 in, 8 out; the tilde vectors are carried, the PCApply
//   itself stays outside: it applies to the products that follow):
//     x2 r2 w2 as above;  rt2 = rt - a1 st;  wt2 = wt - a1 ut;
//     p2 = rt2 + beta p;  s2 = w2 + beta s;  st2 = wt2 + beta st;
//     dots = (p2.s2, r2.st2, st2.s2, rt2.r2)
//
// Replaces the TPU kernels new_cg_variants_tpu/ops/fused_step.py:_kernel
// (entry point fused_pipe_vector_phase) and :_prec_kernel
// (fused_pipe_vector_phase_prec).
//
// What bounds it on an H100: device-memory bytes.  11 (or 18) vectors cross
// the memory bus once each; at n = 655,360 in f32 that is 28.8 MB (47.2 MB),
// 8.6 us (14.1 us) at 3.35 TB/s, against 0.2-0.3 us of f32 arithmetic (18 or
// 28 operations per row) at the 67 TFLOP/s peak.
//
// What the design does about it: one thread per row, every vector read once
// and written once, coalesced, nothing kept between; plain PyTorch makes the
// same updates as ~15 launches that each re-read their operands.  Dots leave
// as one (4,) partial per block, summed in a fixed order (block_dots), and
// the wrapper sums the (nblocks, 4) partials: no atomics, runs repeat bit for
// bit.  a1 and beta are read from device memory, so no step waits for the
// host.  Inputs and outputs are distinct buffers.

#include "sym_common.cuh"

namespace ncgv {

constexpr int kVecMaxIn = 10;
constexpr int kVecMaxOut = 8;

// Device pointers of one launch, passed by value.
template <typename T>
struct VectorArgs {
  const T* in[kVecMaxIn];
  T* out[kVecMaxOut];
  const T* sc[2];
};

template <typename T, bool PREC>
__global__ void __launch_bounds__(kTile) pipe_vector_kernel(
    long long n, const __grid_constant__ VectorArgs<T> a,
    T* __restrict__ partials) {
  __shared__ T sred[4 * kWarps];
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const T a1 = *a.sc[0];
  const T beta = *a.sc[1];
  T prod[4] = {T(0), T(0), T(0), T(0)};
  if (i < n) {
    const T pv = __ldg(a.in[4] + i);
    const T sv = __ldg(a.in[5] + i);
    const T x2 = __ldg(a.in[0] + i) + a1 * pv;
    const T r2 = __ldg(a.in[1] + i) - a1 * sv;
    const T w2 = __ldg(a.in[2] + i) - a1 * __ldg(a.in[3] + i);
    const T s2 = w2 + beta * sv;
    a.out[0][i] = x2;
    a.out[1][i] = r2;
    a.out[2][i] = w2;
    if (PREC) {
      // in: x r w u p s rt st wt ut;  out: x2 r2 w2 rt2 wt2 p2 s2 st2
      const T stv = __ldg(a.in[7] + i);
      const T rt2 = __ldg(a.in[6] + i) - a1 * stv;
      const T wt2 = __ldg(a.in[8] + i) - a1 * __ldg(a.in[9] + i);
      const T p2 = rt2 + beta * pv;
      const T st2 = wt2 + beta * stv;
      a.out[3][i] = rt2;
      a.out[4][i] = wt2;
      a.out[5][i] = p2;
      a.out[6][i] = s2;
      a.out[7][i] = st2;
      prod[0] = p2 * s2;    // mu
      prod[1] = r2 * st2;   // delta
      prod[2] = st2 * s2;   // gamma
      prod[3] = rt2 * r2;   // nu
    } else {
      // in: x r w u p s;  out: x2 r2 w2 p2 s2
      const T p2 = r2 + beta * pv;
      a.out[3][i] = p2;
      a.out[4][i] = s2;
      prod[0] = p2 * s2;   // mu
      prod[1] = r2 * s2;   // delta
      prod[2] = s2 * s2;   // gamma
      prod[3] = r2 * r2;   // nu
    }
  }
  block_dots(prod, sred, partials + size_t(blockIdx.x) * 4);
}

template <typename T>
int launch_pipe_vector(int prec, long long n, const void* const* in, int nin,
                       const void* const* sc, int nsc, void* const* out,
                       int nout, void* partials, int device, void* stream) {
  if (n <= 0 || nsc != 2 || nin != (prec ? 10 : 6) || nout != (prec ? 8 : 5))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  VectorArgs<T> a = {};
  for (int k = 0; k < nin; ++k) a.in[k] = static_cast<const T*>(in[k]);
  for (int k = 0; k < nout; ++k) a.out[k] = static_cast<T*>(out[k]);
  for (int k = 0; k < nsc; ++k) a.sc[k] = static_cast<const T*>(sc[k]);
  T* part = static_cast<T*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = unsigned((n + kTile - 1) / kTile);
  if (prec) {
    pipe_vector_kernel<T, true><<<grid, kTile, 0, st>>>(n, a, part);
  } else {
    pipe_vector_kernel<T, false><<<grid, kTile, 0, st>>>(n, a, part);
  }
  return int(cudaGetLastError());
}

}  // namespace ncgv

extern "C" {

// in / sc / out: device pointers in the entry's order (prec: 10 in, 8 out;
// else 6 in, 5 out; sc = a1, beta); partials: (ceil(n / 256), 4).
int pipe_vector_f32(int prec, long long n, const void* const* in, int nin,
                    const void* const* sc, int nsc, void* const* out, int nout,
                    void* partials, int device, void* stream) {
  return ncgv::launch_pipe_vector<float>(prec, n, in, nin, sc, nsc, out, nout,
                                         partials, device, stream);
}

int pipe_vector_f64(int prec, long long n, const void* const* in, int nin,
                    const void* const* sc, int nsc, void* const* out, int nout,
                    void* partials, int device, void* stream) {
  return ncgv::launch_pipe_vector<double>(prec, n, in, nin, sc, nsc, out,
                                          nout, partials, device, stream);
}

}  // extern "C"
