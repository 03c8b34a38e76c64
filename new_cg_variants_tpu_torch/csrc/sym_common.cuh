// Shared pieces of the band kernels.  The half-band ones (sym_dia.cu,
// sym_family.cu) use all of it; the full-DIA ones (dia_spmv.cu, dia_family.cu)
// and pipe_vector.cu use the tile, the offsets and the reductions.
//
// Half-band storage:
// data[d, i] = A[i, i + off_d] for the stored offsets off_0 = 0 <
// off_1 < ... (main + upper diagonals), row-major (ndiag, n), explicit zeros
// past the matrix edge.  The half-band h is the largest stored offset.  Row i
// of the product is
//   (A v)_i = data[0, i] v_i
//           + sum_{d >= 1} (data[d, i] v_{i + off_d}             (forward)
//                           + data[d, i - off_d] v_{i - off_d})  (mirror).
//
// Every kernel gives each block a tile of rows starting at i0.  Blocks run in
// no order, so a block cannot inherit the mirror term from its neighbour (the
// TPU kernels carry it across a sequential grid in a spill scratch).  Instead
// the thread of row i reads both band values of a diagonal itself, straight
// from device memory (sym_rows): the forward value data[d, i], coalesced and
// used once, and the mirror value data[d, i - off], which lies on lines that
// this block's warps (or, for its first off rows, the previous block) loaded
// moments earlier, so it comes from L1 or L2 and the band crosses the memory
// bus about once.  What a row reuses is the right-hand side: each block
// stages its window v[i0 - h : i0 + tile + h) in shared memory (tile + 2h
// values per right-hand side; rows outside [0, n) are zeros, so no load goes
// out of bounds).
//
// The band is stored as D and computed with in T (storage.cuh).  A band
// stored in bf16 is not read that way: a 2-byte load per row and diagonal
// moves half the bytes of a float32 one for the same load instructions, so
// those kernels took the float32 entry's time on half its bytes.  Each block
// stages its bf16 band segment through a ring in shared memory instead
// (sym_rows_ring below).
#pragma once

#include "storage.cuh"

namespace ncgv {

constexpr int kTile = 256;       // rows per block == threads per block
constexpr int kMaxDiags = 256;   // stored diagonals a launch can take

// The stored offsets, passed by value as a kernel parameter.  Each block
// copies them to shared memory first (load_offsets), so the loop over the
// diagonals indexes shared memory, not the parameter block.
struct Offsets {
  int off[kMaxDiags];
};

__device__ __forceinline__ void load_offsets(const Offsets& o, int ndiag,
                                             int* soff) {
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) soff[d] = o.off[d];
}

// Stage v[i0 - h : i0 - h + vw) into sv.
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ v, int h,
                                            long long n, long long i0, int vw,
                                            T* sv) {
  for (int j = threadIdx.x; j < vw; j += blockDim.x) {
    const long long g = i0 - h + j;
    sv[j] = (g >= 0 && g < n) ? v[g] : T(0);
  }
}

// The forward band value: read once, coalesced.  In f32 it streams
// (evict-first); in f64 a plain load is faster (chip_study.py symopts times
// each hint in both types).  The mirror loads are never evict-first: they
// need the lines the forward loads just brought in.  (A bf16 band takes
// sym_rows_ring; chip_study.py bf16opts times it read this way too.)
template <typename D>
__device__ __forceinline__ auto band_load(const D* p) {
  if constexpr (sizeof(D) <= 4) {
    return widen(__ldcs(p));
  } else {
    return widen(*p);
  }
}

// (A v)_i for each of thread t's R rows i = i0 + t + r kTile and each of the
// NMV staged windows smv (stride vw; row i at window position i - i0 + h),
// from one read of the band (stored as D, widened to T).  Same terms in the same order as the plain
// version (sym_dia.py:_mv_plain): the main term, then per diagonal the
// forward term and then the mirror term, each a multiply-add into the row's
// accumulator.  Where i - off < 0 the mirror value is a zero rather than a
// load, and the window holds a zero there too: the zero term is still added,
// as it was when the band was staged with zeros, so every sum keeps its bits
// (-0.0 included).  Rows at or past n read nothing and give zeros.
template <typename T, typename D, int R, int NMV>
__device__ __forceinline__ void sym_rows(const D* __restrict__ data,
                                         long long n, long long i0, int ndiag,
                                         const int* soff, const T* smv, int vw,
                                         int h, T (&acc)[R][NMV]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + t + r * kTile;
    const int c = t + r * kTile + h;
    const T a = i < n ? band_load(data + i) : T(0);
#pragma unroll
    for (int k = 0; k < NMV; ++k) acc[r][k] = a * smv[k * vw + c];
  }
#pragma unroll 4
  for (int d = 1; d < ndiag; ++d) {
    const int off = soff[d];
    const D* row = data + (long long)d * n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = i0 + t + r * kTile;
      const int c = t + r * kTile + h;
      const T af = i < n ? band_load(row + i) : T(0);
      const T am = (i < n && i >= off) ? widen(__ldg(row + i - off)) : T(0);
#pragma unroll
      for (int k = 0; k < NMV; ++k) {
        acc[r][k] += af * smv[k * vw + c + off];
        acc[r][k] += am * smv[k * vw + c - off];
      }
    }
  }
}

// The bf16 band through a ring in shared memory (kRingBand storage types).
// A block owns rows [i0, i0 + tile); for diagonal d its rows need
// data[d, i0 - off_d : i0 + tile), the forward values and the mirror values
// together.  Each stage of the ring holds kRingGroup diagonals' segments
// data[d, i0 - hp : i0 + tile) (hp: h rounded up to 16 bytes; kRingValues
// values of the block's rows a stage, 16 diagonals of the SpMV's 256 rows or
// 8 of the family kernel's 512, so both do the same work between barriers),
// stored as D and widened where a row reads them, so both band values of a
// row come from shared memory and each band value crosses the memory bus
// once (through L2: a block's first hp values are the previous block's last
// ones).  One thread fills a stage by bulk copies (cp.async.bulk, the copy
// engine behind TMA; one copy a diagonal) and counts their bytes on the
// stage's mbarrier, which every thread waits on before it reads the stage.
// While the block computes one group of diagonals, the copies of the next
// kRingStages - 1 groups are in flight into the other stages, so no block
// waits for its whole band before its first product, and the ring's size
// does not grow with the number of diagonals.  Where n or the band's address
// leaves the rows off 16-byte boundaries, plain 2-byte loads fill the same
// layout.  The products are sym_rows' terms in sym_rows' order, so the bits
// are the float32 entry's on the widened band.  (chip_study.py bf16opts
// times the alternatives: 16-byte cp.async copies, other stage sizes and
// depths, the offsets' copy in shared memory.)
template <typename D>
constexpr bool kRingBand = sizeof(D) == 2;

constexpr int kRingValues = 4096;  // band values of a block's rows a stage
constexpr int kRingStages = 2;     // stages of the ring
template <int TILE>
constexpr int kRingGroup = kRingValues / TILE;  // diagonals a stage holds

// The staged rows' lead: h rounded up to whole 16-byte chunks of D.
template <typename D>
__host__ __device__ inline int ring_lead(int h) {
  constexpr int V = 16 / int(sizeof(D));
  return (h + V - 1) / V * V;
}

// Bytes of a ring for blocks of TILE rows, and where it starts after `used`
// bytes of shared memory (on a 16-byte boundary).
template <int TILE, typename D>
__host__ __device__ inline size_t ring_bytes(int h) {
  return size_t(kRingStages) * kRingGroup<TILE> * (TILE + ring_lead<D>(h)) *
         sizeof(D);
}
__host__ __device__ inline size_t ring_at(size_t used) {
  return (used + 15) / 16 * 16;
}

// The stages' mbarriers, in the block's static shared memory.
__device__ __forceinline__ unsigned long long* ring_bars() {
  __shared__ unsigned long long bars[kRingStages];
  return bars;
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// The stage's one arrival, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Fill `stage` (row stride TILE + hp) with group g: row j holds data[g G + j,
// i0 - hp : i0 + TILE) (G = kRingGroup<TILE>), zeros outside [0, n).  The
// stage's mbarrier gets its one arrival (no bytes past the last group, or
// where the rows are filled by plain loads).
template <int TILE, typename D>
__device__ __forceinline__ void ring_issue(const D* __restrict__ data,
                                           long long n, int ndiag, int hp,
                                           long long i0, int g, D* stage) {
  constexpr int G = kRingGroup<TILE>;
  const int w = TILE + hp;
  const int d0 = g * G;
  const int nd = min(G, ndiag - d0);
  unsigned long long* bar = ring_bars() + g % kRingStages;
  const bool wide = n % (16 / sizeof(D)) == 0 &&
                    (reinterpret_cast<unsigned long long>(data) & 15) == 0;
  if (nd > 0 && wide) {
    // stage positions [lo, hi) lie in [0, n): copied; the rest are zeros
    const long long s0 = max(i0 - hp, 0LL);
    const int lo = int(s0 - (i0 - hp));
    const int hi = int(min(i0 + TILE, n) - (i0 - hp));
    if (lo > 0 || hi < w) {
      for (int idx = threadIdx.x; idx < nd * w; idx += blockDim.x) {
        const int m = idx % w;
        if (m < lo || m >= hi) stage[idx] = __ushort_as_bfloat16(0);
      }
    }
    if (threadIdx.x == 0) {
      // the block's reads of the stage's last group before the copies
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const unsigned bytes = unsigned(hi - lo) * sizeof(D);
      mbar_expect_tx(bar, unsigned(nd) * bytes);
      for (int j = 0; j < nd; ++j)
        bulk_copy(stage + j * w + lo, data + (long long)(d0 + j) * n + s0,
                  bytes, bar);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < nd * w; idx += blockDim.x) {
    const int j = idx / w;
    const long long s = i0 - hp + (idx - j * w);
    stage[idx] = (s >= 0 && s < n) ? data[(long long)(d0 + j) * n + s]
                                   : __ushort_as_bfloat16(0);
  }
  if (threadIdx.x == 0) mbar_expect_tx(bar, 0);
}

// Start a block's ring: its mbarriers, then the copies of its first
// kRingStages - 1 groups, issued before the block stages its vector windows,
// so the two overlap (the barrier after the windows makes the mbarriers'
// initialisation visible to the block).
template <int TILE, typename D>
__device__ __forceinline__ void ring_start(const D* __restrict__ data,
                                           long long n, int ndiag, int h,
                                           long long i0, D* ring) {
  const int hp = ring_lead<D>(h);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) mbar_init(ring_bars() + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int g = 0; g < kRingStages - 1; ++g)
    ring_issue<TILE>(data, n, ndiag, hp, i0, g,
                     ring + size_t(g) * kRingGroup<TILE> * (TILE + hp));
}

// sym_rows from the ring: thread t's R rows i0 + t + r kTile (window position
// i - i0 + h, staged position i - i0 + hp).  At group g the block's barrier
// says that every thread is done with the stage of group g - 1, into which
// the copies of group g + kRingStages - 1 then go; group g is read from stage
// g % kRingStages once its mbarrier's phase g / kRingStages has completed.
// `offs`: the stored offsets in the kernel's parameter block (a warp-uniform
// index, read through the constant cache, not shared memory).
template <typename T, typename D, int R, int NMV>
__device__ __forceinline__ void sym_rows_ring(const D* __restrict__ data,
                                              long long n, int ndiag,
                                              const int* offs, const T* smv,
                                              int vw, int h, long long i0,
                                              D* ring, T (&acc)[R][NMV]) {
  constexpr int kRows = R * kTile;
  constexpr int G = kRingGroup<kRows>;
  const int t = threadIdx.x;
  const int hp = ring_lead<D>(h);
  const int w = kRows + hp;
  const size_t sw = size_t(G) * w;  // values a stage
  const int ngroups = (ndiag + G - 1) / G;
  for (int g = 0; g < ngroups; ++g) {
    __syncthreads();
    const int next = g + kRingStages - 1;
    ring_issue<kRows>(data, n, ndiag, hp, i0, next,
                      ring + (next % kRingStages) * sw);
    mbar_wait(ring_bars() + g % kRingStages, unsigned(g / kRingStages) & 1u);
    const D* stage = ring + (g % kRingStages) * sw;
    const int d0 = g * G;
    const int nd = min(G, ndiag - d0);
    int j = 0;
    if (g == 0) {  // the main diagonal
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T a = widen(stage[t + r * kTile + hp]);
#pragma unroll
        for (int k = 0; k < NMV; ++k)
          acc[r][k] = a * smv[k * vw + t + r * kTile + h];
      }
      j = 1;
    }
    // four row products a step: four diagonals of one row, or two of two
#pragma unroll (4 / R)
    for (; j < nd; ++j) {
      const int off = offs[d0 + j];
      const D* seg = stage + j * w;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = t + r * kTile + hp;
        const T bf = widen(seg[b]);
        const T bm = widen(seg[b - off]);
#pragma unroll
        for (int k = 0; k < NMV; ++k) {
          const T* x = smv + k * vw + t + r * kTile + h;
          acc[r][k] += bf * x[off];
          acc[r][k] += bm * x[-off];
        }
      }
    }
  }
}

constexpr int kWarps = kTile / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_down_sync(0xffffffffu, v, m);
  return v;
}

// Sum each of the block's ND per-thread products in a fixed order (warp
// shuffles, then the warp sums in warp order) and write the ND sums to out.
// sred holds ND * kWarps values.  Every thread of the block must call it.
template <typename T, int ND>
__device__ __forceinline__ void block_dots(const T (&prod)[ND], T* sred,
                                           T* out) {
  const int t = threadIdx.x;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const T v = warp_sum(prod[d]);
    if ((t & 31) == 0) sred[d * kWarps + t / 32] = v;
  }
  __syncthreads();
  if (t < ND) {
    T acc = sred[t * kWarps];
    for (int k = 1; k < kWarps; ++k) acc += sred[t * kWarps + k];
    out[t] = acc;
  }
}

// Copy the host offsets into the by-value parameter block.
inline bool fill_offsets(const int* host, int ndiag, Offsets* o) {
  if (ndiag < 1 || ndiag > kMaxDiags) return false;
  for (int d = 0; d < ndiag; ++d) o->off[d] = host[d];
  return true;
}

// Full-DIA kernels: the rows a row's products reach before it, h_lo =
// max(-off, 0), and after it, h_hi = max(off, 0), over the stored offsets.
inline void halo_of(const int* offsets, int ndiag, int* h_lo, int* h_hi) {
  *h_lo = 0;
  *h_hi = 0;
  for (int d = 0; d < ndiag; ++d) {
    if (-offsets[d] > *h_lo) *h_lo = -offsets[d];
    if (offsets[d] > *h_hi) *h_hi = offsets[d];
  }
}

// Kernels above 48 KB of dynamic shared memory must opt in first.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace ncgv
