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
// halves: 52 MB (hs) to 97 MB (pipe_prec), 16-29 us.  Tensor cores have no
// role: ~4 operations per stored value and SpMV input is no matrix product.
//
// What the design does about it:
// * One block per kFamilyTile rows, one thread per kFamilyRows of them.  Each
//   thread reads its rows' band values straight from device memory, the
//   forward value coalesced and the mirror value from lines just brought into
//   L1 / L2 (sym_common.cuh:sym_rows), once for all of the entry's SpMV
//   inputs: the band crosses the memory bus about once and no block waits
//   for a staging loop.  A band stored in bf16 comes through a ring of
//   bulk copies in shared memory instead (sym_common.cuh:sym_rows_ring),
//   started before the update so the two overlap.
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
//   partials.  No atomics on the sums: runs repeat bit for bit.
// * Scalars are read from device memory, so the host never waits for the
//   previous iteration.
// * The unpreconditioned pipe entries also come with their scalar epilogue
//   (Scalars<PipeSpec<R>>, sym_family_pipe_scalars_*), which would otherwise
//   be ~15 launches of tiny torch kernels a step: every thread forms beta
//   from the previous state's nu, delta, gamma and alpha, and the block that
//   finishes last (a ticket counter, as csrc/df_pipe.cu) sums the partials
//   in a fixed order and writes mu, delta, gamma, nu, alpha and beta.  The
//   formulas are those of solvers/families.py in torch's operation order,
//   each operation rounded on its own (no contraction), so beta and alpha
//   are the torch epilogue's bits on the same dots; only the partials' sum
//   runs in another order than torch's.
// * Shared memory holds only the windows (a few KB), so occupancy is set by
//   the registers: see the launch bound at the kernel.

#include "family_specs.cuh"

namespace ncgv {

// Blocks per SM the compiler must leave registers for, by the band's storage
// type: 48 registers a thread in f32, 80 in f64 (chip_study.py symopts times
// 4, 6, 8 and none); 31 with a bf16 band, whose ring takes 17 KB of shared
// memory more at h = 31 (bf16opts times 4, 6, 8 and none).
template <typename D>
constexpr int kMinBlocks = sizeof(D) == 8 ? 3 : 5;

// The scalar epilogue of a pipe entry: the previous state's nu, delta,
// gamma and alpha in; mu, delta, gamma, nu, alpha and beta out; the ticket
// counter (0 before a launch and after it) and the prediction (PR or
// Meurant).
template <typename T>
struct PipeScalars {
  const T* prev[4];
  T* out;
  unsigned* tickets;
  int meurant;
};

// A spec with the scalar epilogue: no scalar pointers of its own (a1 and
// beta come from PipeScalars).
template <typename S>
struct Scalars : S {
  static constexpr int kSc = 0;
};
template <typename S>
constexpr bool kScalars = false;
template <typename S>
constexpr bool kScalars<Scalars<S>> = true;

// Each operation rounded on its own, as torch's 0-d kernels round them.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// solvers/families.py:_safe_div: num / den, 0 where den is exactly 0.
template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return den != T(0) ? div_rn(num, den) : T(0);
}

// beta = safe_div(nu_pred, nu1), nu_pred as solvers/families.py:_predict_nu:
// PR (nu1 - (2 a1) delta1) + (a1 a1) gamma1, Meurant -nu1 + (a1 a1) gamma1.
template <typename T>
__device__ __forceinline__ T predicted_beta(const PipeScalars<T>& e, T a1) {
  const T nu1 = *e.prev[0], delta1 = *e.prev[1], gamma1 = *e.prev[2];
  const T tail = mul_rn(mul_rn(a1, a1), gamma1);
  const T pred =
      e.meurant ? add_rn(-nu1, tail)
                : add_rn(sub_rn(nu1, mul_rn(mul_rn(T(2), a1), delta1)), tail);
  return safe_div(pred, nu1);
}

// The block that draws the last ticket sums the partials (rows of kDots,
// one per kTile rows): thread t the rows t, t + kTile, ... in turn, then
// the threads as block_dots sums them; and writes the epilogue's scalars.
// Every block calls it after its partials are written.
template <typename T, int ND>
__device__ __forceinline__ void pipe_epilogue(const PipeScalars<T>& e,
                                              const T* partials, long long n,
                                              T beta, T* sred) {
  static_assert(ND == 4, "the pipe entries' dots: mu, delta, gamma, nu");
  __shared__ bool last;
  const int t = threadIdx.x;
  // the partials reach device memory before the block draws its ticket, so
  // the block that draws the last one sees them all
  if (t < ND) __threadfence();
  __syncthreads();
  if (t == 0) {
    last = atomicInc(e.tickets, gridDim.x - 1) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const long long rows = (n + kTile - 1) / kTile;
  T sum[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) sum[d] = T(0);
#pragma unroll 4
  for (long long j = t; j < rows; j += kTile) {
#pragma unroll
    for (int d = 0; d < ND; ++d) sum[d] += __ldcg(partials + j * ND + d);
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const T v = warp_sum(sum[d]);
    if ((t & 31) == 0) sred[d * kWarps + t / 32] = v;
  }
  __syncthreads();
  if (t == 0) {
    T dot[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      T acc = sred[d * kWarps];
      for (int k = 1; k < kWarps; ++k) acc += sred[d * kWarps + k];
      dot[d] = acc;
      e.out[d] = acc;  // mu, delta, gamma, nu
    }
    e.out[4] = safe_div(dot[3], dot[0]);  // alpha = nu / mu
    e.out[5] = beta;
  }
}

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
__global__ void __launch_bounds__(kTile, kMinBlocks<D>) sym_family_kernel(
    const D* __restrict__ data, const __grid_constant__ Offsets o, int ndiag,
    int h, long long n, const __grid_constant__ FamilyArgs<T> a,
    T* __restrict__ partials, const __grid_constant__ PipeScalars<T> e) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int soff[kMaxDiags];
  const int vw = kFamilyTile + 2 * h;
  T* smv = reinterpret_cast<T*>(smem);   // S::kMv windows of vw
  T* sred = smv + size_t(S::kMv) * vw;   // kFamilyRows * S::kDots * kWarps
  // a bf16 band's ring, behind them
  [[maybe_unused]] D* ring = reinterpret_cast<D*>(
      smem + ring_at((size_t(S::kMv) * vw + kFamilyRows * S::kDots * kWarps) *
                     sizeof(T)));
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kFamilyTile;
  T sc[2];
  if constexpr (kScalars<S>) {
    sc[0] = *e.prev[3];  // a1: the previous state's alpha
    sc[1] = predicted_beta(e, sc[0]);
  } else {
    sc[0] = *a.sc[0];
    sc[1] = S::kSc > 1 ? *a.sc[1] : T(0);
  }

  load_offsets(o, ndiag, soff);
  if constexpr (kRingBand<D>)
    ring_start<kFamilyTile>(data, n, ndiag, h, i0, ring);
  T keep[kFamilyRows][S::kKeep];
  sym_window<T, S>(a, sc, n, i0, h, vw, keep, smv);
  __syncthreads();

  T acc[kFamilyRows][S::kMv];
  if constexpr (kRingBand<D>) {
    sym_rows_ring<T, D, kFamilyRows, S::kMv>(data, n, ndiag, o.off, smv, vw,
                                             h, i0, ring, acc);
  } else {
    sym_rows<T, D, kFamilyRows, S::kMv>(data, n, i0, ndiag, soff, smv, vw,
                                        h, acc);
  }
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
  if constexpr (kScalars<S>)
    pipe_epilogue<T, S::kDots>(e, partials, n, sc[1], sred);
}

template <typename T, typename D, typename S>
int launch_spec(const D* data, const Offsets& o, int ndiag, int h,
                long long n, const void* const* in, int nin,
                const void* const* sc, int nsc, void* const* out, int nout,
                T* partials, cudaStream_t st,
                const PipeScalars<T>& e = PipeScalars<T>{}) {
  FamilyArgs<T> a;
  if (!family_args<T, S>(in, nin, sc, nsc, out, nout, &a))
    return int(cudaErrorInvalidValue);
  const size_t smem = (size_t(S::kMv) * (kFamilyTile + 2 * h) +
                       size_t(kFamilyRows) * S::kDots * kWarps) *
                      sizeof(T);
  const size_t ring = kRingBand<D> ? ring_at(smem) - smem +
                                         ring_bytes<kFamilyTile, D>(h)
                                   : 0;
  cudaError_t err = allow_smem(sym_family_kernel<T, D, S>, smem + ring);
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned((n + kFamilyTile - 1) / kFamilyTile);
  sym_family_kernel<T, D, S><<<grid, kTile, smem + ring, st>>>(
      data, o, ndiag, h, n, a, partials, e);
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

// The pipe entry (recompute or not) with its scalar epilogue: in, out as
// entries 9 and 10; prev: nu, delta, gamma, alpha of the previous state;
// scalars: (6,) out, mu delta gamma nu alpha beta.
template <typename T, typename D = T>
int launch_pipe_scalars(int recompute, int meurant, const void* data,
                        const int* offsets, int ndiag, int h, long long n,
                        const void* const* in, int nin,
                        const void* const* prev, void* const* out, int nout,
                        void* partials, void* scalars, void* tickets,
                        int device, void* stream) {
  Offsets o;
  if (!fill_offsets(offsets, ndiag, &o) || n <= 0 || h < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  PipeScalars<T> e;
  for (int k = 0; k < 4; ++k) e.prev[k] = static_cast<const T*>(prev[k]);
  e.out = static_cast<T*>(scalars);
  e.tickets = static_cast<unsigned*>(tickets);
  e.meurant = meurant;
  const D* d = static_cast<const D*>(data);
  T* part = static_cast<T*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (recompute)
    return launch_spec<T, D, Scalars<PipeSpec<true>>>(
        d, o, ndiag, h, n, in, nin, nullptr, 0, out, nout, part, st, e);
  return launch_spec<T, D, Scalars<PipeSpec<false>>>(
      d, o, ndiag, h, n, in, nin, nullptr, 0, out, nout, part, st, e);
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

// prev: the previous state's nu, delta, gamma, alpha (device pointers);
// scalars: (6,) device buffer, mu delta gamma nu alpha beta; tickets: one
// unsigned int, 0 before the launch and 0 after it; launches that may run at
// once (on different streams) each need their own.
int sym_family_pipe_scalars_f32(int recompute, int meurant,
                                const void* data, const int* offsets,
                                int ndiag, int h, long long n,
                                const void* const* in, int nin,
                                const void* const* prev, void* const* out,
                                int nout, void* partials, void* scalars,
                                void* tickets, int device, void* stream) {
  return ncgv::launch_pipe_scalars<float>(
      recompute, meurant, data, offsets, ndiag, h, n, in, nin, prev, out,
      nout, partials, scalars, tickets, device, stream);
}

int sym_family_pipe_scalars_f64(int recompute, int meurant,
                                const void* data, const int* offsets,
                                int ndiag, int h, long long n,
                                const void* const* in, int nin,
                                const void* const* prev, void* const* out,
                                int nout, void* partials, void* scalars,
                                void* tickets, int device, void* stream) {
  return ncgv::launch_pipe_scalars<double>(
      recompute, meurant, data, offsets, ndiag, h, n, in, nin, prev, out,
      nout, partials, scalars, tickets, device, stream);
}

int sym_family_pipe_scalars_bf16(int recompute, int meurant,
                                 const void* data, const int* offsets,
                                 int ndiag, int h, long long n,
                                 const void* const* in, int nin,
                                 const void* const* prev, void* const* out,
                                 int nout, void* partials, void* scalars,
                                 void* tickets, int device, void* stream) {
  return ncgv::launch_pipe_scalars<float, __nv_bfloat16>(
      recompute, meurant, data, offsets, ndiag, h, n, in, nin, prev, out,
      nout, partials, scalars, tickets, device, stream);
}

}  // extern "C"
