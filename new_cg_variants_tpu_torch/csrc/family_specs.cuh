// The CG families' update programs ("family specs"), shared by the fused
// kernels of both band storages: sym_family.cu (half-band) and dia_family.cu
// (full DIA).  A spec knows nothing of how the matrix is stored: it forms the
// SpMV inputs and the other updated vectors of a row from the old vectors,
// and finishes an owned row from the row product(s) the kernel hands it.
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
#pragma once

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

// The update over a block's window [i0 - h_lo, i0 - h_lo + vw) of the SpMV
// inputs, into the S::kMv shared-memory windows smv (stride vw).  Turn idx of
// the loop is window position (idx + h_lo) mod vw: the first turn of thread t
// is the row it owns (i0 + t), whose other updated values it keeps in
// registers (keep) for the finish; the later turns are the back and front
// halo.  Rows outside [0, n) are zeros.  Halo and owned rows go through the
// same call of S::update, so a row of an SpMV input has one bit pattern in
// every block that computes it.
template <typename T, typename S>
__device__ __forceinline__ void update_window(const FamilyArgs<T>& a,
                                              const T* sc, long long n,
                                              long long i0, int h_lo, int vw,
                                              T* keep, T* smv) {
#pragma unroll
  for (int k = 0; k < S::kKeep; ++k) keep[k] = T(0);
  for (int idx = threadIdx.x; idx < vw; idx += kTile) {
    int j = idx + h_lo;
    if (j >= vw) j -= vw;
    const long long g = i0 - h_lo + j;
    T mv[S::kMv];
#pragma unroll
    for (int k = 0; k < S::kMv; ++k) mv[k] = T(0);
    if (g >= 0 && g < n) S::update(a, sc, g, idx < kTile, keep, mv);
#pragma unroll
    for (int k = 0; k < S::kMv; ++k) smv[k * vw + j] = mv[k];
  }
}

// The pointers of one launch as a FamilyArgs, or false when their counts are
// not the spec's.
template <typename T, typename S>
inline bool family_args(const void* const* in, int nin, const void* const* sc,
                        int nsc, void* const* out, int nout,
                        FamilyArgs<T>* a) {
  if (nin != S::kIn || nsc != S::kSc || nout != S::kOut) return false;
  *a = FamilyArgs<T>{};
  for (int k = 0; k < nin; ++k) a->in[k] = static_cast<const T*>(in[k]);
  for (int k = 0; k < nout; ++k) a->out[k] = static_cast<T*>(out[k]);
  for (int k = 0; k < nsc; ++k) a->sc[k] = static_cast<const T*>(sc[k]);
  return true;
}

}  // namespace ncgv
