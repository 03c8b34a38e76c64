// The CG families' fused phases on half-band storage, one kernel template
// over a small "family spec": the family's elementwise update, the half-band
// SpMV of the updated vector(s), an optional finish on the product (the
// Jacobi PCApply d * (A v)) and the phase's dot products, in one pass.
//
// The update programs (the specs) are in family_specs.cuh, shared with the
// full-DIA kernel dia_family.cu.
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
// arithmetic at the 67 TFLOP/s peak.  With the band stored in bf16
// (sym_family_bf16: 2-byte band values, float32 vectors) the band's share
// halves: 52 MB (hs) to 97 MB (pipe_prec), 16-29 us.
//
// What the design does about it:
// * One block per kFamilyTile rows, one thread per kFamilyRows of them.  Each
//   thread reads its rows' band values straight from device memory, the
//   forward value coalesced and the mirror value from lines just brought into
//   L1 / L2 (sym_common.cuh:sym_rows), once for all of the entry's SpMV
//   inputs: the band crosses the memory bus about once and no block waits
//   for a staging loop.
// * The SpMV inputs are never written and re-read: each block applies the
//   spec's update to the rows it owns AND to the h rows on each side, from
//   the OLD vectors, into shared-memory windows [i0 - h, i0 + tile + h)
//   (sym_window; the TPU kernel gets the front halo from XLA and carries the
//   back one across its sequential grid; blocks here run in no order).  A
//   thread's first turns of that loop are the rows it owns, whose values it
//   keeps in registers for the finish; later turns fill the halo.  Halo and
//   owned rows go through the same call of Spec::update, so a row of the
//   SpMV input has one bit pattern in every block that computes it.  Vectors
//   that only the owned row needs (x everywhere; r, s where the product is
//   of another vector) are not read for halo rows.
// * Inputs and outputs are distinct buffers: a neighbour block reads the old
//   vectors of a row while its owner writes the new ones.
// * The finish runs on owned rows only, after the row product, so dots that
//   use a finished vector (r2.st2, st2.s2) are formed last.
// * Dots leave the kernel as one (kDots,) partial per kTile rows, reduced in
//   a fixed order (block_dots); the wrapper sums the (ceil(n / kTile), kDots)
//   partials.  No atomics: runs repeat bit for bit.
// * Scalars are read from device memory, so the host never waits for the
//   previous iteration.
// * Shared memory holds only the windows (a few KB), so occupancy is set by
//   the registers: see the launch bound at the kernel.

#include "family_specs.cuh"

namespace ncgv {

// Blocks per SM the compiler must leave registers for: 48 registers a
// thread in f32, 80 in f64 (chip_study.py symopts times 4, 6, 8 and none).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 5 : 3;

// Rows a thread owns (t + r kTile), and so rows a block owns
// (ops/_kernels.py:SYM_FAMILY_TILE).  Two rows a thread halve the halo rows
// a block updates besides its own (2h per block).
constexpr int kFamilyRows = 2;
constexpr int kFamilyTile = kFamilyRows * kTile;

// The update over a block's window [i0 - h, i0 - h + vw) of the SpMV inputs
// into the S::kMv shared-memory windows smv (stride vw), as update_window
// (family_specs.cuh) with kFamilyRows owned rows a thread: turn r of thread
// t is row i0 + t + r kTile, whose other updated values go to keep[r]; the
// later turns are the back and front halo.  Rows outside [0, n) are zeros.
template <typename T, typename S>
__device__ __forceinline__ void sym_window(const FamilyArgs<T>& a,
                                           const T* sc, long long n,
                                           long long i0, int h, int vw,
                                           T (&keep)[kFamilyRows][S::kKeep],
                                           T* smv) {
  auto turn = [&](int idx, bool owned, T* kept) {
    int j = idx + h;
    if (j >= vw) j -= vw;
    const long long g = i0 - h + j;
    T mv[S::kMv];
#pragma unroll
    for (int k = 0; k < S::kMv; ++k) mv[k] = T(0);
    if (g >= 0 && g < n) S::update(a, sc, g, owned, kept, mv);
#pragma unroll
    for (int k = 0; k < S::kMv; ++k) smv[k * vw + j] = mv[k];
  };
#pragma unroll
  for (int r = 0; r < kFamilyRows; ++r) {
#pragma unroll
    for (int k = 0; k < S::kKeep; ++k) keep[r][k] = T(0);
    turn(threadIdx.x + r * kTile, true, keep[r]);
  }
  for (int idx = threadIdx.x + kFamilyTile; idx < vw; idx += kTile)
    turn(idx, false, keep[0]);
}

template <typename T, typename D, typename S>
__global__ void __launch_bounds__(kTile, kMinBlocks<T>) sym_family_kernel(
    const D* __restrict__ data, const __grid_constant__ Offsets o, int ndiag,
    int h, long long n, const __grid_constant__ FamilyArgs<T> a,
    T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const int vw = kFamilyTile + 2 * h;
  T* smv = reinterpret_cast<T*>(smem);   // S::kMv windows of vw
  T* sred = smv + size_t(S::kMv) * vw;   // kFamilyRows * S::kDots * kWarps
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kFamilyTile;
  T sc[2];
  sc[0] = *a.sc[0];
  sc[1] = S::kSc > 1 ? *a.sc[1] : T(0);

  load_offsets(o, ndiag, soff);
  T keep[kFamilyRows][S::kKeep];
  sym_window<T, S>(a, sc, n, i0, h, vw, keep, smv);
  __syncthreads();

  T acc[kFamilyRows][S::kMv];
  sym_rows<T, D, kFamilyRows, S::kMv>(data, n, i0, ndiag, soff, smv, vw, h,
                                      acc);
#pragma unroll
  for (int r = 0; r < kFamilyRows; ++r) {
    const long long i = i0 + t + r * kTile;
    T prod[S::kDots];
#pragma unroll
    for (int k = 0; k < S::kDots; ++k) prod[k] = T(0);
    if (i < n) {
      T mv[S::kMv];
#pragma unroll
      for (int k = 0; k < S::kMv; ++k) mv[k] = smv[k * vw + t + r * kTile + h];
      S::finish(a, i, keep[r], mv, acc[r], prod);
    }
    // one partial per kTile rows; none for rows wholly past n
    if (i0 + r * kTile < n)
      block_dots(prod, sred + r * S::kDots * kWarps,
                 partials + size_t(blockIdx.x * kFamilyRows + r) * S::kDots);
  }
}

template <typename T, typename D, typename S>
int launch_spec(const D* data, const Offsets& o, int ndiag, int h,
                long long n, const void* const* in, int nin,
                const void* const* sc, int nsc, void* const* out, int nout,
                T* partials, cudaStream_t st) {
  FamilyArgs<T> a;
  if (!family_args<T, S>(in, nin, sc, nsc, out, nout, &a))
    return int(cudaErrorInvalidValue);
  const size_t smem = (size_t(S::kMv) * (kFamilyTile + 2 * h) +
                       size_t(kFamilyRows) * S::kDots * kWarps) *
                      sizeof(T);
  cudaError_t err = allow_smem(sym_family_kernel<T, D, S>, smem);
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned((n + kFamilyTile - 1) / kFamilyTile);
  sym_family_kernel<T, D, S><<<grid, kTile, smem, st>>>(data, o, ndiag, h, n,
                                                       a, partials);
  return int(cudaGetLastError());
}

// entry: the order of ops/sym_fused.py:_FAMILY_ENTRIES; T: the vectors',
// scalars' and partials' type; D: the band's (T, or __nv_bfloat16 with
// T = float)
template <typename T, typename D = T>
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
  const D* d = static_cast<const D*>(data);
  T* part = static_cast<T*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NCGV_ENTRY(k, Spec)                                                  \
  case k:                                                                    \
    return launch_spec<T, D, Spec>(d, o, ndiag, h, n, in, nin, sc, nsc, out, \
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

// data in bf16; vectors, scalars and partials in float32
int sym_family_bf16(int entry, const void* data, const int* offsets,
                    int ndiag, int h, long long n, const void* const* in,
                    int nin, const void* const* sc, int nsc, void* const* out,
                    int nout, void* partials, int device, void* stream) {
  return ncgv::launch_sym_family<float, __nv_bfloat16>(
      entry, data, offsets, ndiag, h, n, in, nin, sc, nsc, out, nout,
      partials, device, stream);
}

}  // extern "C"
