// The CG families' fused phases on half-band storage, one kernel template
// over a small "family spec": the family's elementwise update, the half-band
// SpMV of the updated vector(s), an optional finish on the product (the
// Jacobi PCApply d * (A v)) and the phase's dot products, in one pass.
//
//   entry            scalars  update (in order)                     SpMV of
//   hs               beta     p2 = r + beta p                        p2
//   pr               a1 beta  x2 r2; p2 = r2 + beta p                p2
//   cgcg             a1       x2 r2                                  r2
//   gv               a1       x2 r2; w2 = w - a1 u                   w2
//   pr_prec          a1 beta  x2 r2; rt2 = rt - a1 st;
//                             p2 = rt2 + beta p                      p2
//   cgcg_prec        a1       x2 r2; rt2 = d r2                      rt2
//   gv_prec          a1       x2 r2 rt2 w2; wt2 = d w2               wt2
//   pipe_prec        a1 beta  r2 w2 rt2 wt2 p2 s2 st2 x2             st2, rt2
//   pipe_prec_norec  a1 beta  the same                               st2
//   pipe             a1 beta  r2; w2 = w - a1 u; s2 = w2 + beta s;
//                             p2 = r2 + beta p; x2                   s2, r2
//   pipe_norec       a1 beta  the same                               s2
// with x2 = x + a1 p and r2 = r - a1 s throughout (the specs below give each
// entry's vectors, finish and dots in full).
//
// Replaces the TPU kernel new_cg_variants_tpu/ops/sym_fused.py:
// _sym_family_kernel as reached by fused_sym_hs_matvec_phase,
// fused_sym_pr_full_step, fused_sym_cgcg_matvec_phase,
// fused_sym_gv_matvec_phase, their *_prec twins, fused_sym_pipe_full_step and
// fused_sym_pipe_full_step_prec (update programs of ops/fused_family.py and
// _pipe_update / _pipe_prec_update and their _norec forms).
//
// What bounds it on an H100: device-memory bytes.  Every entry must read the
// band (ndiag * n values) and its 2-11 vectors once and write its 2-10
// vectors once; at n = 655,360, ndiag = 32, f32 that is 94 MB (hs) to 139 MB
// (pipe_prec), 28-42 us at 3.35 TB/s, against at most ~5 us of f32
// arithmetic at the 67 TFLOP/s peak.
//
// What the design does about it:
// * One block per kTile rows, one thread per row.  The band columns
//   [i0 - h, i0 + kTile) and, per SpMV input, the window
//   [i0 - h, i0 + kTile + h) are staged in shared memory (sym_common.cuh).
// * The SpMV input is never written and re-read: each block applies the
//   spec's update to the rows it owns AND to the h rows on each side, from
//   the OLD vectors, in one loop with one call of Spec::update (the TPU
//   kernel gets the front halo from XLA and carries the back one across its
//   sequential grid; blocks here run in no order).  A thread's
//   first turn of that loop is the row it owns, whose values it keeps in
//   registers for the finish; later turns fill the halo.  Halo and owned
//   rows go through the same code, so a row of the SpMV input has one bit
//   pattern in every block that computes it.  Vectors that only the owned
//   row needs (x everywhere; r, s where the product is of another vector)
//   are not read for halo rows.
// * Inputs and outputs are distinct buffers: a neighbour block reads the old
//   vectors of a row while its owner writes the new ones.
// * The finish runs on owned rows only, after the row product, so dots that
//   use a finished vector (r2.st2, st2.s2) are formed last.
// * Dots leave the kernel as one (kDots,) partial per block, reduced in a
//   fixed order (block_dots); the wrapper sums the (nblocks, kDots) partials.
//   No atomics: runs repeat bit for bit.
// * Scalars are read from device memory, so the host never waits for the
//   previous iteration.
// * Occupancy sets the time more than the vectors do: see the launch bound
//   at the kernel.

#include "sym_common.cuh"

namespace ncgv {

constexpr int kMaxIn = 11;
constexpr int kMaxOut = 10;

// Device pointers of one launch, passed by value.
template <typename T>
struct FamilyArgs {
  const T* in[kMaxIn];
  T* out[kMaxOut];
  const T* sc[2];
};

// A spec gives
//   kIn, kOut, kSc, kMv, kDots, kKeep   counts: inputs, outputs, scalars,
//                                       SpMV inputs, dots, values kept
//   update(a, sc, g, owned, keep, mv)   row g from the old vectors: the SpMV
//                                       inputs into mv (every window row),
//                                       the rest into keep (owned rows)
//   finish(a, i, keep, mv, acc, prod)   owned row i: write every output,
//                                       form the dot products
// Inputs go through the read-only path (__ldg): no output aliases them.

struct HsSpec {  // in: r p;  out: p2 s2;  dots: p2.s2
  static constexpr int kIn = 2, kOut = 2, kSc = 1, kMv = 1, kDots = 1,
                       kKeep = 1;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    mv[0] = __ldg(a.in[0] + g) + sc[0] * __ldg(a.in[1] + g);  // p2
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    a.out[0][i] = mv[0];
    a.out[1][i] = acc[0];
    prod[0] = mv[0] * acc[0];
  }
};

struct PrSpec {  // in: x r p s;  out: x2 r2 p2 s2;  dots: p.s r.s s.s r.r
  static constexpr int kIn = 4, kOut = 4, kSc = 2, kMv = 1, kDots = 4,
                       kKeep = 2;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    const T pv = __ldg(a.in[2] + g);
    const T r2 = __ldg(a.in[1] + g) - sc[0] * __ldg(a.in[3] + g);
    mv[0] = r2 + sc[1] * pv;  // p2
    if (owned) {
      keep[0] = __ldg(a.in[0] + g) + sc[0] * pv;  // x2
      keep[1] = r2;
    }
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    const T r2 = keep[1], p2 = mv[0], s2 = acc[0];
    a.out[0][i] = keep[0];
    a.out[1][i] = r2;
    a.out[2][i] = p2;
    a.out[3][i] = s2;
    prod[0] = p2 * s2;
    prod[1] = r2 * s2;
    prod[2] = s2 * s2;
    prod[3] = r2 * r2;
  }
};

struct CgcgSpec {  // in: x r p s;  out: x2 r2 w2;  dots: r.r w.r
  static constexpr int kIn = 4, kOut = 3, kSc = 1, kMv = 1, kDots = 2,
                       kKeep = 1;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    mv[0] = __ldg(a.in[1] + g) - sc[0] * __ldg(a.in[3] + g);  // r2
    if (owned) keep[0] = __ldg(a.in[0] + g) + sc[0] * __ldg(a.in[2] + g);
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    const T r2 = mv[0], w2 = acc[0];
    a.out[0][i] = keep[0];
    a.out[1][i] = r2;
    a.out[2][i] = w2;
    prod[0] = r2 * r2;
    prod[1] = w2 * r2;
  }
};

struct GvSpec {  // in: x r w u p s;  out: x2 r2 w2 t;  dots: r.r w.r
  static constexpr int kIn = 6, kOut = 4, kSc = 1, kMv = 1, kDots = 2,
                       kKeep = 2;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    mv[0] = __ldg(a.in[2] + g) - sc[0] * __ldg(a.in[3] + g);  // w2
    if (owned) {
      keep[0] = __ldg(a.in[0] + g) + sc[0] * __ldg(a.in[4] + g);  // x2
      keep[1] = __ldg(a.in[1] + g) - sc[0] * __ldg(a.in[5] + g);  // r2
    }
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    const T r2 = keep[1], w2 = mv[0];
    a.out[0][i] = keep[0];
    a.out[1][i] = r2;
    a.out[2][i] = w2;
    a.out[3][i] = acc[0];
    prod[0] = r2 * r2;
    prod[1] = w2 * r2;
  }
};

struct PrPrecSpec {  // in: d x r p s rt st;  out: x2 r2 rt2 p2 s2 st2
  static constexpr int kIn = 7, kOut = 6, kSc = 2, kMv = 1, kDots = 4,
                       kKeep = 3;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    const T pv = __ldg(a.in[3] + g);
    const T rt2 = __ldg(a.in[5] + g) - sc[0] * __ldg(a.in[6] + g);
    mv[0] = rt2 + sc[1] * pv;  // p2
    if (owned) {
      keep[0] = __ldg(a.in[1] + g) + sc[0] * pv;                  // x2
      keep[1] = __ldg(a.in[2] + g) - sc[0] * __ldg(a.in[4] + g);  // r2
      keep[2] = rt2;
    }
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    const T r2 = keep[1], rt2 = keep[2], p2 = mv[0], s2 = acc[0];
    const T st2 = __ldg(a.in[0] + i) * s2;
    a.out[0][i] = keep[0];
    a.out[1][i] = r2;
    a.out[2][i] = rt2;
    a.out[3][i] = p2;
    a.out[4][i] = s2;
    a.out[5][i] = st2;
    prod[0] = p2 * s2;    // mu
    prod[1] = r2 * st2;   // delta
    prod[2] = st2 * s2;   // gamma
    prod[3] = rt2 * r2;   // nu
  }
};

struct CgcgPrecSpec {  // in: d x r p s;  out: x2 r2 rt2 w2;  dots: r.rt w.rt
  static constexpr int kIn = 5, kOut = 4, kSc = 1, kMv = 1, kDots = 2,
                       kKeep = 2;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    const T r2 = __ldg(a.in[2] + g) - sc[0] * __ldg(a.in[4] + g);
    mv[0] = __ldg(a.in[0] + g) * r2;  // rt2: the PCApply, on the window too
    if (owned) {
      keep[0] = __ldg(a.in[1] + g) + sc[0] * __ldg(a.in[3] + g);  // x2
      keep[1] = r2;
    }
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    const T r2 = keep[1], rt2 = mv[0], w2 = acc[0];
    a.out[0][i] = keep[0];
    a.out[1][i] = r2;
    a.out[2][i] = rt2;
    a.out[3][i] = w2;
    prod[0] = r2 * rt2;
    prod[1] = w2 * rt2;
  }
};

struct GvPrecSpec {  // in: d x r w u p s rt st;  out: x2 r2 rt2 w2 wt2 t
  static constexpr int kIn = 9, kOut = 6, kSc = 1, kMv = 1, kDots = 2,
                       kKeep = 4;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    const T w2 = __ldg(a.in[3] + g) - sc[0] * __ldg(a.in[4] + g);
    mv[0] = __ldg(a.in[0] + g) * w2;  // wt2
    if (owned) {
      keep[0] = __ldg(a.in[1] + g) + sc[0] * __ldg(a.in[5] + g);  // x2
      keep[1] = __ldg(a.in[2] + g) - sc[0] * __ldg(a.in[6] + g);  // r2
      keep[2] = __ldg(a.in[7] + g) - sc[0] * __ldg(a.in[8] + g);  // rt2
      keep[3] = w2;
    }
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    const T r2 = keep[1], rt2 = keep[2], w2 = keep[3];
    a.out[0][i] = keep[0];
    a.out[1][i] = r2;
    a.out[2][i] = rt2;
    a.out[3][i] = w2;
    a.out[4][i] = mv[0];
    a.out[5][i] = acc[0];
    prod[0] = r2 * rt2;
    prod[1] = w2 * rt2;
  }
};

// in: x r w u p s;  out: x2 r2 w_out p2 s2 u2;  dots: p.s r.s s.s r.r
// RECOMPUTE: w_out = A r2 (from the same read of the band as u2 = A s2);
// else w_out = w2.
template <bool RECOMPUTE>
struct PipeSpec {
  static constexpr int kIn = 6, kOut = 6, kSc = 2, kMv = RECOMPUTE ? 2 : 1,
                       kDots = 4, kKeep = 4;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    const T sv = __ldg(a.in[5] + g);
    const T w2 = __ldg(a.in[2] + g) - sc[0] * __ldg(a.in[3] + g);
    mv[0] = w2 + sc[1] * sv;  // s2
    if (RECOMPUTE || owned) {
      const T r2 = __ldg(a.in[1] + g) - sc[0] * sv;
      if constexpr (RECOMPUTE) mv[1] = r2;
      if (owned) {
        const T pv = __ldg(a.in[4] + g);
        keep[0] = __ldg(a.in[0] + g) + sc[0] * pv;  // x2
        keep[1] = r2;
        keep[2] = w2;
        keep[3] = r2 + sc[1] * pv;                  // p2
      }
    }
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    const T r2 = keep[1], p2 = keep[3], s2 = mv[0];
    a.out[0][i] = keep[0];
    a.out[1][i] = r2;
    if constexpr (RECOMPUTE) {
      a.out[2][i] = acc[1];
    } else {
      a.out[2][i] = keep[2];
    }
    a.out[3][i] = p2;
    a.out[4][i] = s2;
    a.out[5][i] = acc[0];
    prod[0] = p2 * s2;   // mu
    prod[1] = r2 * s2;   // delta
    prod[2] = s2 * s2;   // gamma
    prod[3] = r2 * r2;   // nu
  }
};

// in: d x r w u p s rt st wt ut
// out: x2 r2 w_out p2 s2 u2 rt2 st2 wt_out ut2;  dots: p.s r.st st.s rt.r
// RECOMPUTE: w_out = A rt2, wt_out = d w_out; else w_out = w2, wt_out = wt2.
template <bool RECOMPUTE>
struct PipePrecSpec {
  static constexpr int kIn = 11, kOut = 10, kSc = 2, kMv = RECOMPUTE ? 2 : 1,
                       kDots = 4, kKeep = 7;
  template <typename T>
  static __device__ __forceinline__ void update(const FamilyArgs<T>& a,
                                                const T* sc, long long g,
                                                bool owned, T* keep, T* mv) {
    const T stv = __ldg(a.in[8] + g);
    const T rt2 = __ldg(a.in[7] + g) - sc[0] * stv;
    const T wt2 = __ldg(a.in[9] + g) - sc[0] * __ldg(a.in[10] + g);
    mv[0] = wt2 + sc[1] * stv;  // st2
    if constexpr (RECOMPUTE) mv[1] = rt2;
    if (owned) {
      const T pv = __ldg(a.in[5] + g);
      const T sv = __ldg(a.in[6] + g);
      const T w2 = __ldg(a.in[3] + g) - sc[0] * __ldg(a.in[4] + g);
      keep[0] = __ldg(a.in[1] + g) + sc[0] * pv;  // x2
      keep[1] = __ldg(a.in[2] + g) - sc[0] * sv;  // r2
      keep[2] = w2;
      keep[3] = rt2 + sc[1] * pv;                 // p2
      keep[4] = w2 + sc[1] * sv;                  // s2
      keep[5] = rt2;
      keep[6] = wt2;
    }
  }
  template <typename T>
  static __device__ __forceinline__ void finish(const FamilyArgs<T>& a,
                                                long long i, const T* keep,
                                                const T* mv, const T* acc,
                                                T* prod) {
    const T dv = __ldg(a.in[0] + i);
    const T r2 = keep[1], p2 = keep[3], s2 = keep[4], rt2 = keep[5];
    const T st2 = mv[0], u2 = acc[0];
    a.out[0][i] = keep[0];
    a.out[1][i] = r2;
    a.out[3][i] = p2;
    a.out[4][i] = s2;
    a.out[5][i] = u2;
    a.out[6][i] = rt2;
    a.out[7][i] = st2;
    a.out[9][i] = dv * u2;  // ut2
    if constexpr (RECOMPUTE) {
      a.out[2][i] = acc[1];       // w3 = A rt2
      a.out[8][i] = dv * acc[1];  // wt3
    } else {
      a.out[2][i] = keep[2];  // w2
      a.out[8][i] = keep[6];  // wt2
    }
    prod[0] = p2 * s2;    // mu
    prod[1] = r2 * st2;   // delta
    prod[2] = st2 * s2;   // gamma
    prod[3] = rt2 * r2;   // nu
  }
};

// Blocks per SM the compiler must leave registers for.  In f32 at k = 32 a
// block stages ~38 KB, so shared memory admits five, and the bound holds the
// compiler to the 48 registers per thread that five need.  Left to itself it
// takes 60-80 and only three or four blocks fit: the same entries then run
// 2-50% slower (pr_prec 0.152 against 0.102 ms on an H100, PERF.md).  In f64
// the staged band is twice as large and admits two blocks, so nothing is
// gained by squeezing (48 registers spill there).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 5 : 2;

template <typename T, typename S>
__global__ void __launch_bounds__(kTile, kMinBlocks<T>) sym_family_kernel(
    const T* __restrict__ data, const __grid_constant__ Offsets o, int ndiag,
    int h, long long n, const __grid_constant__ FamilyArgs<T> a,
    T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const int vw = kTile + 2 * h;
  T* sdata = reinterpret_cast<T*>(smem);
  T* smv = sdata + size_t(ndiag) * (kTile + h);  // S::kMv windows of vw
  T* sred = smv + size_t(S::kMv) * vw;           // S::kDots * kWarps
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kTile;
  T sc[2];
  sc[0] = *a.sc[0];
  sc[1] = S::kSc > 1 ? *a.sc[1] : T(0);

  load_offsets(o, ndiag, soff);
  load_band(data, ndiag, h, n, i0, sdata);
  // The update over the window [i0 - h, i0 + kTile + h).  Turn idx of the
  // loop is window position (idx + h) mod vw: the first turn of thread t is
  // the row it owns (i0 + t), the later turns are the back and front halo.
  T keep[S::kKeep];
#pragma unroll
  for (int k = 0; k < S::kKeep; ++k) keep[k] = T(0);
  for (int idx = t; idx < vw; idx += kTile) {
    int j = idx + h;
    if (j >= vw) j -= vw;
    const long long g = i0 - h + j;
    T mv[S::kMv];
#pragma unroll
    for (int k = 0; k < S::kMv; ++k) mv[k] = T(0);
    if (g >= 0 && g < n) S::update(a, sc, g, idx < kTile, keep, mv);
#pragma unroll
    for (int k = 0; k < S::kMv; ++k) smv[k * vw + j] = mv[k];
  }
  __syncthreads();

  const long long i = i0 + t;
  T prod[S::kDots];
#pragma unroll
  for (int k = 0; k < S::kDots; ++k) prod[k] = T(0);
  if (i < n) {
    T mv[S::kMv], acc[S::kMv];
#pragma unroll
    for (int k = 0; k < S::kMv; ++k) {
      mv[k] = smv[k * vw + t + h];
      acc[k] = sym_row(sdata, smv + k * vw, ndiag, h, soff, t);
    }
    S::finish(a, i, keep, mv, acc, prod);
  }
  block_dots(prod, sred, partials + size_t(blockIdx.x) * S::kDots);
}

template <typename T, typename S>
int launch_spec(const T* data, const Offsets& o, int ndiag, int h,
                long long n, const void* const* in, int nin,
                const void* const* sc, int nsc, void* const* out, int nout,
                T* partials, cudaStream_t st) {
  if (nin != S::kIn || nsc != S::kSc || nout != S::kOut)
    return int(cudaErrorInvalidValue);
  FamilyArgs<T> a = {};
  for (int k = 0; k < nin; ++k) a.in[k] = static_cast<const T*>(in[k]);
  for (int k = 0; k < nout; ++k) a.out[k] = static_cast<T*>(out[k]);
  for (int k = 0; k < nsc; ++k) a.sc[k] = static_cast<const T*>(sc[k]);
  const size_t smem = (size_t(ndiag) * (kTile + h) +
                       size_t(S::kMv) * (kTile + 2 * h) + S::kDots * kWarps) *
                      sizeof(T);
  cudaError_t err = allow_smem(sym_family_kernel<T, S>, smem);
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned((n + kTile - 1) / kTile);
  sym_family_kernel<T, S><<<grid, kTile, smem, st>>>(data, o, ndiag, h, n, a,
                                                    partials);
  return int(cudaGetLastError());
}

// entry: the order of ops/sym_fused.py:_FAMILY_ENTRIES
template <typename T>
int launch_sym_family(int entry, const void* data, const int* offsets,
                      int ndiag, int h, long long n, const void* const* in,
                      int nin, const void* const* sc, int nsc,
                      void* const* out, int nout, void* partials, int device,
                      void* stream) {
  Offsets o;
  if (!fill_offsets(offsets, ndiag, &o) || n <= 0 || h < 0 || nin < 0 ||
      nin > kMaxIn || nout < 0 || nout > kMaxOut || nsc < 0 || nsc > 2)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const T* d = static_cast<const T*>(data);
  T* part = static_cast<T*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NCGV_ENTRY(k, Spec)                                                  \
  case k:                                                                    \
    return launch_spec<T, Spec>(d, o, ndiag, h, n, in, nin, sc, nsc, out,    \
                                nout, part, st)
  switch (entry) {
    NCGV_ENTRY(0, HsSpec);
    NCGV_ENTRY(1, PrSpec);
    NCGV_ENTRY(2, CgcgSpec);
    NCGV_ENTRY(3, GvSpec);
    NCGV_ENTRY(4, PrPrecSpec);
    NCGV_ENTRY(5, CgcgPrecSpec);
    NCGV_ENTRY(6, GvPrecSpec);
    NCGV_ENTRY(7, PipePrecSpec<true>);
    NCGV_ENTRY(8, PipePrecSpec<false>);
    NCGV_ENTRY(9, PipeSpec<true>);
    NCGV_ENTRY(10, PipeSpec<false>);
  }
#undef NCGV_ENTRY
  return int(cudaErrorInvalidValue);
}

}  // namespace ncgv

extern "C" {

// in / sc / out: nin / nsc / nout device pointers in the entry's order;
// partials: (ceil(n / 256), dots of the entry) device buffer.
int sym_family_f32(int entry, const void* data, const int* offsets, int ndiag,
                   int h, long long n, const void* const* in, int nin,
                   const void* const* sc, int nsc, void* const* out, int nout,
                   void* partials, int device, void* stream) {
  return ncgv::launch_sym_family<float>(entry, data, offsets, ndiag, h, n, in,
                                        nin, sc, nsc, out, nout, partials,
                                        device, stream);
}

int sym_family_f64(int entry, const void* data, const int* offsets, int ndiag,
                   int h, long long n, const void* const* in, int nin,
                   const void* const* sc, int nsc, void* const* out, int nout,
                   void* partials, int device, void* stream) {
  return ncgv::launch_sym_family<double>(entry, data, offsets, ndiag, h, n,
                                         in, nin, sc, nsc, out, nout,
                                         partials, device, stream);
}

}  // extern "C"
