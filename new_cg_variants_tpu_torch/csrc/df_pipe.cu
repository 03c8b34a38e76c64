// The vector phase of a pipelined predict(-and-recompute) CG iteration in
// double-word (f32x2) arithmetic, in one pass: five double-word AXPYs and the
// four double-word dot products of the iteration's single synchronisation
// phase, with no SpMV.  Every vector is a pair of word arrays (hi, lo), a1 and
// beta are double-word scalars:
//
//   x2 = x + a1 p;  r2 = r - a1 s;  w2 = w - a1 u;
//   p2 = r2 + beta p;  s2 = w2 + beta s;
//   dots = (p2.s2, r2.s2, s2.s2, r2.r2) = (mu, delta, gamma, nu)
//
// each operation as the double-word values of ops/doublefloat.py compute it
// (ops/df_spmv.py:_df_pipe_vector_phase_plain).
//
// Replaces the TPU kernel new_cg_variants_tpu/ops/df_spmv.py:_df_pipe_kernel
// (entry point df_pipe_vector_phase), and the cross-tile combine that the JAX
// package does outside it.
//
// What bounds it on an H100: device-memory bytes.  12 word arrays are read
// and 10 written once each; at n = 655,360 that is 57.7 MB, 0.0172 ms at
// 3.35 TB/s, against ~350 float32 operations per row (none of them a fused
// multiply-add), 0.0069 ms at 33.5 T operations/s.
//
// What the design does about it: one thread per row, 256 rows per block,
// every word array read once and written once, coalesced; a1 and beta are
// read from device memory, so no step waits for the host.  Each block sums
// its rows' dot terms with the double-word halving tree and writes one (hi,
// lo) partial per dot; a second launch, one block, sums the partials with the
// same tree over their count padded with zero pairs to a power of two.  (The
// JAX package halves the tile count as if it were a power of two and drops
// partials when it is not; ROADMAP.md section 3.)  No atomics: runs repeat
// bit for bit.  Every step uses the never-contracted intrinsics of
// df_common.cuh, so the vectors are the plain version's bits; only the dots
// sum in another order than the plain version's tree.

#include "df_common.cuh"

namespace ncgv {

constexpr int kPipeIn = 12;
constexpr int kPipeOut = 10;

// Device pointers of one launch, passed by value.  in: the hi and lo words
// of x r w u p s; out: those of x2 r2 w2 p2 s2; sc: a1 hi, a1 lo, beta hi,
// beta lo.
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
    terms[0] = dot_term(p2, s2);  // mu
    terms[1] = dot_term(r2, s2);  // delta
    terms[2] = dot_term(s2, s2);  // gamma
    terms[3] = dot_term(r2, r2);  // nu
  }
  Pair sums[4];
  block_tree_sum<4>(terms, kTile, sred, sums);
  if (threadIdx.x == 0) {
    for (int d = 0; d < 4; ++d) {
      partials[(2 * d) * (long long)nblocks + blockIdx.x] = sums[d].hi;
      partials[(2 * d + 1) * (long long)nblocks + blockIdx.x] = sums[d].lo;
    }
  }
}

// One block: the four dots from the (8, nblocks) partials.
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
  tree_sum<4>(width, leaf, sred, sums);
  if (threadIdx.x == 0) {
    for (int d = 0; d < 4; ++d) {
      dots[2 * d] = sums[d].hi;
      dots[2 * d + 1] = sums[d].lo;
    }
  }
}

int launch_df_pipe(long long n, const void* const* in, int nin,
                   const void* const* sc, int nsc, void* const* out, int nout,
                   void* partials, void* dots, int device, void* stream) {
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

}  // namespace ncgv

extern "C" {

// in / out: the word arrays' device pointers in the order above; sc: a1 hi,
// a1 lo, beta hi, beta lo (device pointers); partials: (8, ceil(n / 256))
// scratch; dots: (4, 2), the hi and lo words of mu, delta, gamma, nu.
int df_pipe_f32(long long n, const void* const* in, int nin,
                const void* const* sc, int nsc, void* const* out, int nout,
                void* partials, void* dots, int device, void* stream) {
  return ncgv::launch_df_pipe(n, in, nin, sc, nsc, out, nout, partials, dots,
                              device, stream);
}

}  // extern "C"
