// The CG families' fused phases on full-DIA storage (diagonals at arbitrary
// offsets, data[d, i] = A[i, i + off_d]): one kernel template over the family
// specs of family_specs.cuh, as sym_family.cu is for half-band storage, with
// the full-band row product dia_row in place of sym_rows, and the same eleven
// entries: hs, pr, cgcg, gv and their Jacobi twins, and the whole pipe-P/PR
// iteration, unpreconditioned,
//
//   r2 = r - a1 s;  w2 = w - a1 u;  s2 = w2 + beta s;  p2 = r2 + beta p;
//   x2 = x + a1 p;  u2 = A s2;  w_out = A r2 (recompute) or w2;
//   dots = (p2.s2, r2.s2, s2.s2, r2.r2)
//
// and with Jacobi (the tilde vectors carried, u2 = A st2, ut2 = d u2 and with
// recompute w_out = A rt2, wt_out = d w_out), each with recompute on and off.
//
// Replaces the TPU kernels of the full-DIA whole-iteration fusions:
// new_cg_variants_tpu/ops/fused_step.py:_full_kernel (entry point
// fused_pipe_full_step), new_cg_variants_tpu/ops/fused_step.py:
// _full_kernel_prec (fused_pipe_full_step_prec) and
// new_cg_variants_tpu/ops/fused_family.py:_family_kernel (fused_pr_full_step,
// fused_cgcg_matvec_phase, fused_gv_matvec_phase, fused_hs_matvec_phase and
// their *_prec twins).
//
// What bounds it on an H100: device-memory bytes.  An entry must read the
// band (ndiag * n values) and its 2-11 vectors once and write its 2-10
// vectors once; at n = 655,360 with 63 diagonals in f32 that is 175.6 MB (hs)
// to 220.2 MB (pipe with Jacobi), 52-66 us at 3.35 TB/s, against at most
// ~6 us of f32 arithmetic (2 operations per stored value per SpMV plus 4-32
// per row) at the 67 TFLOP/s peak.  With the band stored in bf16
// (dia_family_bf16: 2-byte band values, float32 vectors) 93.1-137.6 MB,
// 28-41 us.
//
// What the design does about it:
// * One block per kTile rows, one thread per row.  Every stored value is used
//   once per SpMV, so the band is read straight from device memory,
//   coalesced, and serves both products from a register.
// * The SpMV inputs (s2, and r2 with recompute) are never written and
//   re-read: each block applies the spec's update to its own rows AND to the
//   h_lo rows before and the h_hi rows after them, from the OLD vectors
//   (update_window), into shared-memory windows that the row products read.
//   The TPU kernel has XLA compute those halo rows into 1024-element pieces
//   and needs n to be a multiple of its tile; here any n and any offsets
//   whose combined halo fits kMaxHalo do (the wrapper sends wider bands to
//   the split formulation: vector-phase kernel, then the SpMV kernel).
// * Inputs and outputs are distinct buffers: a neighbour block reads the old
//   vectors of a row while its owner writes the new ones.
// * Dots leave the kernel as one (kDots,) partial per block, reduced in a
//   fixed order; the wrapper sums the (nblocks, kDots) partials.  No atomics.
// * Scalars are read from device memory, so the host never waits.

#include "family_specs.cuh"

namespace ncgv {

// Largest combined halo h_lo + h_hi (ops/fused_step.py:MAX_FULL_STEP_HALO):
// each 256-row block recomputes that many halo rows of the SpMV inputs, so
// at 512 the update is done three times over.
constexpr int kMaxHalo = 512;

// Blocks per SM the compiler must leave registers for; the windows take a few
// KB of shared memory per block and are never the limit.
template <typename T>
constexpr int kDiaFamilyMinBlocks = sizeof(T) == 4 ? 6 : 3;

// (A v)[i0 + t] for each of NMV staged windows, from one read of the band
// (stored as D, widened to T).  Terms in stored order of the diagonals, as
// the plain version adds them.
template <typename T, typename D, int NMV>
__device__ __forceinline__ void dia_row(const D* __restrict__ data,
                                        long long n, long long i, int ndiag,
                                        const int* soff, const T* smv, int vw,
                                        int c, T* acc) {
#pragma unroll
  for (int k = 0; k < NMV; ++k) acc[k] = T(0);
  const D* col = data + i;
#pragma unroll 8
  for (int d = 0; d < ndiag; ++d) {
    const T a = widen(__ldg(col + (long long)d * n));
    const int j = c + soff[d];
#pragma unroll
    for (int k = 0; k < NMV; ++k) acc[k] += a * smv[k * vw + j];
  }
}

template <typename T, typename D, typename S>
__global__ void __launch_bounds__(kTile, kDiaFamilyMinBlocks<T>)
    dia_family_kernel(const D* __restrict__ data,
                      const __grid_constant__ Offsets o, int ndiag, int h_lo,
                      int h_hi, long long n,
                      const __grid_constant__ FamilyArgs<T> a,
                      T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const int vw = kTile + h_lo + h_hi;
  T* smv = reinterpret_cast<T*>(smem);   // S::kMv windows of vw
  T* sred = smv + size_t(S::kMv) * vw;   // S::kDots * kWarps
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kTile;
  T sc[2];
  sc[0] = *a.sc[0];
  sc[1] = S::kSc > 1 ? *a.sc[1] : T(0);

  load_offsets(o, ndiag, soff);
  T keep[S::kKeep];
  update_window<T, S>(a, sc, n, i0, h_lo, vw, keep, smv);
  __syncthreads();

  const long long i = i0 + t;
  T prod[S::kDots];
#pragma unroll
  for (int k = 0; k < S::kDots; ++k) prod[k] = T(0);
  if (i < n) {
    T mv[S::kMv], acc[S::kMv];
#pragma unroll
    for (int k = 0; k < S::kMv; ++k) mv[k] = smv[k * vw + t + h_lo];
    dia_row<T, D, S::kMv>(data, n, i, ndiag, soff, smv, vw, t + h_lo, acc);
    S::finish(a, i, keep, mv, acc, prod);
  }
  block_dots(prod, sred, partials + size_t(blockIdx.x) * S::kDots);
}

template <typename T, typename D, typename S>
int launch_dia_spec(const D* data, const Offsets& o, int ndiag, int h_lo,
                    int h_hi, long long n, const void* const* in, int nin,
                    const void* const* sc, int nsc, void* const* out,
                    int nout, T* partials, cudaStream_t st) {
  FamilyArgs<T> a;
  if (!family_args<T, S>(in, nin, sc, nsc, out, nout, &a))
    return int(cudaErrorInvalidValue);
  const size_t smem =
      (size_t(S::kMv) * (kTile + h_lo + h_hi) + S::kDots * kWarps) * sizeof(T);
  const unsigned grid = unsigned((n + kTile - 1) / kTile);
  dia_family_kernel<T, D, S><<<grid, kTile, smem, st>>>(data, o, ndiag, h_lo,
                                                       h_hi, n, a, partials);
  return int(cudaGetLastError());
}

// entry: the numbering of launch_sym_family (sym_family.cu); T: the
// vectors', scalars' and partials' type; D: the band's (T, or
// __nv_bfloat16 with T = float)
template <typename T, typename D = T>
int launch_dia_family(int entry, const void* data, const int* offsets,
                      int ndiag, long long n, const void* const* in, int nin,
                      const void* const* sc, int nsc, void* const* out,
                      int nout, void* partials, int device, void* stream) {
  Offsets o;
  if (!fill_offsets(offsets, ndiag, &o) || n <= 0 || nin < 0 ||
      nin > kMaxIn || nout < 0 || nout > kMaxOut || nsc < 0 || nsc > 2)
    return int(cudaErrorInvalidValue);
  int h_lo, h_hi;
  halo_of(offsets, ndiag, &h_lo, &h_hi);
  if (h_lo + h_hi > kMaxHalo) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const D* d = static_cast<const D*>(data);
  T* part = static_cast<T*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NCGV_ENTRY(k, Spec)                                                  \
  case k:                                                                    \
    return launch_dia_spec<T, D, Spec>(d, o, ndiag, h_lo, h_hi, n, in, nin,  \
                                       sc, nsc, out, nout, part, st)
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
int dia_family_f32(int entry, const void* data, const int* offsets, int ndiag,
                   long long n, const void* const* in, int nin,
                   const void* const* sc, int nsc, void* const* out, int nout,
                   void* partials, int device, void* stream) {
  return ncgv::launch_dia_family<float>(entry, data, offsets, ndiag, n, in,
                                        nin, sc, nsc, out, nout, partials,
                                        device, stream);
}

int dia_family_f64(int entry, const void* data, const int* offsets, int ndiag,
                   long long n, const void* const* in, int nin,
                   const void* const* sc, int nsc, void* const* out, int nout,
                   void* partials, int device, void* stream) {
  return ncgv::launch_dia_family<double>(entry, data, offsets, ndiag, n, in,
                                         nin, sc, nsc, out, nout, partials,
                                         device, stream);
}

// data in bf16; vectors, scalars and partials in float32
int dia_family_bf16(int entry, const void* data, const int* offsets,
                    int ndiag, long long n, const void* const* in, int nin,
                    const void* const* sc, int nsc, void* const* out,
                    int nout, void* partials, int device, void* stream) {
  return ncgv::launch_dia_family<float, __nv_bfloat16>(
      entry, data, offsets, ndiag, n, in, nin, sc, nsc, out, nout, partials,
      device, stream);
}

}  // extern "C"
