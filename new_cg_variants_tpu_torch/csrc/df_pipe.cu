// The vector phase of a pipelined predict(-and-recompute) CG iteration in
// double-word (f32x2) arithmetic, in one launch: five double-word AXPYs and
// the four double-word dot products of the iteration's single
// synchronisation phase, with no SpMV.  Every vector is a pair of word arrays
// (hi, lo), a1 and beta are double-word scalars:
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
// 3.35 TB/s, against ~406 float32 operations per row (none of them a fused
// multiply-add; chip_smoke.py:DF_OPS["pipe"]), 0.0080 ms at 33.5 T
// operations/s.
//
// What the design does about it: every word array read once (evict-first:
// each word is used once) and written once, 128 coalesced bytes a warp; a1
// and beta read from device memory, so no step waits for the host.  The four
// dots are the double-word halving tree over all rows, 256-row tile by tile
// and then over the tiles padded with zero pairs to a power of two, W; the
// kernel keeps that order exactly, so the dots keep the bits of the earlier
// two-launch design, and runs repeat bit for bit.  Within a tile the first
// three levels pair rows 128, 64 and 32 apart (the 32-row chunks c and c + 4,
// + 2, + 1) and the last five pair lanes of a warp, by shuffles that split the
// four dots over the lanes (warp_tree_sum4).
//
// With W >= kWarpTiles tiles (the paths' n = 655,360 has 2560) each warp
// takes a tile, lane l the rows l + 32 c, so the chunk levels are additions in
// the lane: no shared memory, no barrier, and each warp goes at its own pace.
// Warp w of block b takes the tile b + w G (G = W / 8 blocks), so the block's
// eight tiles are those the tiles' tree pairs first (8 tiles apart by G, 4 G,
// 2 G): the block sums them in shared memory and leaves one (hi, lo) partial
// per dot.  With fewer tiles a warp's eight chunks in a row would be a chain
// too long for the few warps there are, so each block takes a tile, a warp a
// chunk, the chunk levels in shared memory (block_tree_sum).
//
// The dots need every block's partial, and blocks run in no order, so the
// block that finishes last sums them, in the same launch: each block stores
// and fences its partials before it draws a ticket from a device counter
// (atomicInc, which puts the counter back to 0 with the last ticket, ready
// for the next launch on its stream); the block that draws the last ticket
// reads them past L1, sums them by the tree's remaining levels (tree_sum, a
// branching counter) and writes the dots.  (The JAX package halves the tile
// count as if it were a power of two and drops partials when it is not;
// ROADMAP.md section 3.)  Every step uses the never-contracted intrinsics
// of df_common.cuh, so the vectors are the plain version's bits; only the
// dots sum in another order than the plain version's tree.

#include "df_common.cuh"

namespace ncgv {

constexpr int kPipeIn = 12;
constexpr int kPipeOut = 10;
constexpr int kChunks = kTile / 32;  // 32-row chunks of a tile
constexpr int kPipeThreads = 32 * kChunks;
// Tiles, padded to a power of two, from which each warp takes a whole tile
// (else a block a tile): where the two designs cross (chip_study.py
// pipeopts on an NVIDIA H100 80GB HBM3 at 700 W: a block a tile is faster
// at 512 tiles, a warp a tile at 1024).
constexpr long long kWarpTiles = 1024;
// Blocks an SM holds at least: up to 64 registers a thread, with which the
// compiler brings more of a lane's loads forward (chip_study.py pipeopts).
constexpr int kPipeMinBlocks = 4;

// Device pointers of one launch, passed by value.  in: the hi and lo words
// of x r w u p s; out: those of x2 r2 w2 p2 s2; sc: a1 hi, a1 lo, beta hi,
// beta lo.
struct DfPipeArgs {
  const float* in[kPipeIn];
  float* out[kPipeOut];
  const float* sc[4];
};

// The input words, each read once.
__device__ __forceinline__ float stream(const float* p) { return __ldcs(p); }

__device__ __forceinline__ Pair load(const float* const* w, int k,
                                     long long i) {
  return {stream(w[2 * k] + i), stream(w[2 * k + 1] + i)};
}

__device__ __forceinline__ void store(float* const* w, int k, long long i,
                                      Pair v) {
  w[2 * k][i] = v.hi;
  w[2 * k + 1][i] = v.lo;
}

// Row i: the five vectors' words stored, the four dots' terms (mu, delta,
// gamma, nu) returned; zero terms past n.
__device__ __forceinline__ void pipe_row(const DfPipeArgs& a, long long n,
                                         long long i, Pair a1, Pair beta,
                                         Pair (&terms)[4]) {
#pragma unroll
  for (int d = 0; d < 4; ++d) terms[d] = {0.0f, 0.0f};
  if (i >= n) return;
  const Pair p = load(a.in, 4, i), s = load(a.in, 5, i);
  const Pair x2 = df_add(load(a.in, 0, i), df_mul(a1, p));
  const Pair r2 = df_add(load(a.in, 1, i), df_neg(df_mul(a1, s)));
  const Pair w2 =
      df_add(load(a.in, 2, i), df_neg(df_mul(a1, load(a.in, 3, i))));
  const Pair p2 = df_add(r2, df_mul(beta, p));
  const Pair s2 = df_add(w2, df_mul(beta, s));
  store(a.out, 0, i, x2);
  store(a.out, 1, i, r2);
  store(a.out, 2, i, w2);
  store(a.out, 3, i, p2);
  store(a.out, 4, i, s2);
  terms[0] = dot_term(p2, s2);
  terms[1] = dot_term(r2, s2);
  terms[2] = dot_term(s2, s2);
  terms[3] = dot_term(r2, r2);
}

// The sums of one tile by one warp, every lane ending with them: lane l's
// rows l + 32 c in pairs of chunks (c, c + 4), the level w = 256, taken in
// the order c = 0, 2, 1, 3 so that the levels w = 128 (c with c + 2) and 64
// (c with c + 1) close as they come; then the lanes (warp_tree_sum4).
__device__ __forceinline__ void warp_tile(const DfPipeArgs& a, long long n,
                                          long long tile, Pair a1, Pair beta,
                                          Pair (&sums)[4]) {
  const long long row = tile * kTile + (threadIdx.x & 31);
  Pair first[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c = (m & 1) * 2 + (m >> 1);
    Pair t0[4], t1[4];
    pipe_row(a, n, row + 32 * c, a1, beta, t0);
    pipe_row(a, n, row + 32 * (c + 4), a1, beta, t1);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const Pair e = df_add(t0[d], t1[d]);
      if (m == 0 || m == 2) {
        first[d] = e;
      } else if (m == 1) {
        sums[d] = df_add(first[d], e);
      } else {
        sums[d] = df_add(sums[d], df_add(first[d], e));
      }
    }
  }
  warp_tree_sum4(sums);
}

// One (hi, lo) partial per dot and block g, at partials[2 d parts + g]
// (parts = gridDim.x): WARP_TILES, the block's tiles are g + w parts, one a
// warp w; else the tile g.  The last block sums the partials over `width`
// columns (a power of two >= parts; zero pairs past parts).
template <bool WARP_TILES>
__global__ void __launch_bounds__(kPipeThreads, kPipeMinBlocks) df_pipe_kernel(
    long long n, const __grid_constant__ DfPipeArgs a,
    float* __restrict__ partials, long long ntiles, int width,
    float* __restrict__ dots, unsigned* __restrict__ tickets) {
  __shared__ Pair sred[4 * kPipeThreads];
  __shared__ Pair group[4];
  __shared__ bool last;
  const Pair a1 = {*a.sc[0], *a.sc[1]};
  const Pair beta = {*a.sc[2], *a.sc[3]};
  const int g = blockIdx.x, parts = gridDim.x;
  if constexpr (WARP_TILES) {
    const int warp = threadIdx.x / 32;
    const long long tile = g + (long long)warp * parts;
    Pair sums[4] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
    if (tile < ntiles) warp_tile(a, n, tile, a1, beta, sums);
    // the block's tiles pair at the tiles' tree's first levels: warp w
    // with w + 4, + 2, + 1; thread d sums dot d
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int d = 0; d < 4; ++d) sred[d * kChunks + warp] = sums[d];
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      const int d = threadIdx.x;
      Pair v[kChunks];
#pragma unroll
      for (int w = 0; w < kChunks; ++w) v[w] = sred[d * kChunks + w];
#pragma unroll
      for (int half = kChunks / 2; half > 0; half >>= 1) {
#pragma unroll
        for (int w = 0; w < half; ++w) v[w] = df_add(v[w], v[w + half]);
      }
      group[d] = v[0];
    }
  } else {
    Pair terms[4];
    pipe_row(a, n, (long long)g * kTile + threadIdx.x, a1, beta, terms);
    block_tree_sum<4>(terms, kPipeThreads, sred);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int d = 0; d < 4; ++d) group[d] = terms[d];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      partials[(2 * d) * parts + g] = group[d].hi;
      partials[(2 * d + 1) * parts + g] = group[d].lo;
    }
    // the partials reach device memory before the block draws its ticket,
    // so the block that draws the last one sees them all
    __threadfence();
    last = atomicInc(tickets, gridDim.x - 1) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  auto leaf = [&](int c, Pair (&v)[4]) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      v[d] = c < parts ? Pair{__ldcg(partials + (2 * d) * parts + c),
                              __ldcg(partials + (2 * d + 1) * parts + c)}
                       : Pair{0.0f, 0.0f};
    }
  };
  Pair sums[4];
  tree_sum<4>(width, leaf, sred, sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      dots[2 * d] = sums[d].hi;
      dots[2 * d + 1] = sums[d].lo;
    }
  }
}

int launch_df_pipe(long long n, const void* const* in, int nin,
                   const void* const* sc, int nsc, void* const* out, int nout,
                   void* partials, void* dots, void* tickets, int device,
                   void* stream) {
  if (n <= 0 || nin != kPipeIn || nout != kPipeOut || nsc != 4)
    return int(cudaErrorInvalidValue);
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long width = pow2_ceil(ntiles);  // the tiles' tree
  if (width > ((long long)kPipeThreads << kMaxTreeDepth))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  DfPipeArgs a = {};
  for (int k = 0; k < kPipeIn; ++k) a.in[k] = static_cast<const float*>(in[k]);
  for (int k = 0; k < kPipeOut; ++k) a.out[k] = static_cast<float*>(out[k]);
  for (int k = 0; k < 4; ++k) a.sc[k] = static_cast<const float*>(sc[k]);
  const bool warp_tiles = width >= kWarpTiles;
  // groups of eight tiles (W / 8 of them) or single tiles: at most ntiles
  const long long parts =
      warp_tiles ? (width > kChunks ? width / kChunks : 1) : ntiles;
  auto kernel = warp_tiles ? df_pipe_kernel<true> : df_pipe_kernel<false>;
  kernel<<<unsigned(parts), kPipeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, a, static_cast<float*>(partials), ntiles,
      int(warp_tiles ? parts : width), static_cast<float*>(dots),
      static_cast<unsigned*>(tickets));
  return int(cudaGetLastError());
}

}  // namespace ncgv

extern "C" {

// in / out: the word arrays' device pointers in the order above; sc: a1 hi,
// a1 lo, beta hi, beta lo (device pointers); partials: (8, ceil(n / 256))
// scratch; dots: (4, 2), the hi and lo words of mu, delta, gamma, nu;
// tickets: one unsigned int, 0 before the launch and 0 after it; launches
// that may run at once (on different streams) each need their own.
int df_pipe_f32(long long n, const void* const* in, int nin,
                const void* const* sc, int nsc, void* const* out, int nout,
                void* partials, void* dots, void* tickets, int device,
                void* stream) {
  return ncgv::launch_df_pipe(n, in, nin, sc, nsc, out, nout, partials, dots,
                              tickets, device, stream);
}

}  // extern "C"
