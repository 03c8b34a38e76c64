// Double-word (f32x2) matrix-vector products, 1 or 2 right-hand sides, for a
// matrix held as an exact three-word split hi + lo + lo2 of its float64
// values (ops/doublefloat.py:df_split3) and double-word vectors vh + vl:
//
//   DIA:   y[i] = sum_d (hi + lo + lo2)[d, i] * V[i + off_d], each term a
//          product with error-free transforms, the terms added in stored
//          order of the diagonals by double-word additions
//          (ops/df_spmv.py:_df_dia_mv_plain), with V[j] = v[j + vorg] where
//          0 <= j + vorg < vlen and 0 elsewhere.  For a whole matrix vorg = 0
//          and vlen = n (zeros outside [0, n) are the matrix edge); for a row
//          shard whose words arrive as [left h | v | right h] (the _ext
//          entries, ops/df_spmv.py:_df_dia_mv_ext_plain) vorg = h and vlen =
//          n + 2h, n the shard's rows;
//   dense: y[i] = sum_j (hi + lo + lo2)[i, j] * v[j], the n terms of a row
//          summed by the double-word halving tree over the columns padded
//          with zero pairs to a power of two (ops/df_spmv.py:
//          _df_dense_mv_plain).
//
// Replaces the TPU kernels new_cg_variants_tpu/ops/df_spmv.py:_df_dia_kernel
// (entry points df_dia_spmv, df_dia_spmv2, df_dia_spmv_ext, df_dia_spmv2_ext)
// and :_df_dense_kernel
// (df_dense_spmv, df_dense_spmv2).
//
// What bounds it on an H100: device-memory bytes and float32 operations about
// equally for the DIA product.  At n = 655,360 with 63 diagonals and 2
// right-hand sides it must read 3 words per stored value and 2 per vector
// entry and write 2 per result, 516 MB, 0.154 ms at 3.35 TB/s; the
// error-free product and the double-word addition are ~48 float32 operations
// per stored value and right-hand side, 3.96 G, 0.118 ms at 33.5 T
// operations/s (132 SMs x 128 lanes x 1.98 GHz; none of them may be a fused
// multiply-add).  The dense product at n = 4096 reads 3 n^2 words, 201 MB,
// 0.060 ms, against ~45 operations per value and right-hand side (2 RHS:
// 1.5 G, 0.045 ms): it is bound by bytes only if the loads overlap the
// error-free arithmetic, and by the arithmetic close behind.  Its first
// design (one 256-thread block per row, the last eight tree levels in shared
// memory behind eight block barriers with most threads idle) ran at 26% of
// that bound with 2 RHS; a warp per row with the vector read through L1 at
// 40-50%, the vector's words and the row's stream then sharing L1.
//
// What the design does about it:
// * DIA, as dia_spmv.cu: one thread per row, 256 rows per block, the three
//   band words read straight from device memory, coalesced, and shared by
//   both right-hand sides from registers; the hi and lo windows of each
//   vector staged in shared memory up to a combined halo of 1024 rows (the
//   wrapper's rule, ops/spmv_dia.py:stages_window), read through the
//   read-only cache beyond.  Any n, any offsets; vector entries outside
//   [0, vlen) read 0.
// * Dense: one warp per row, no block barrier in the tree.  The halving
//   tree's order is part of the result, so the kernel keeps it: lane l takes
//   the columns l, l + 32, ... of the padded width; the tree levels above 32
//   stay in the lane, as fixed trees over groups of four leaves (whose 12
//   matrix loads are issued together) and a counter over the groups that
//   branches instead of predicating its additions (df_common.cuh:
//   warp_tree_sum); the last five levels pair lanes by warp shuffles.  Each
//   warp reads its row once, coalesced and evict-first (__ldcs), both
//   right-hand sides sharing each matrix word.  The vector's words are
//   staged once per block in shared memory (2 RHS at n = 4096: 64 KB, at
//   8192: 128 KB; larger n reads them through L1), so L1 holds nothing but
//   the row streams; 32 rows per block and as many blocks as fit on the card
//   (persistent), their warps walking over the rows.  chip_study.py
//   denseopts times the alternatives: the vector through L1, other block
//   sizes, the matrix words through a ring of bulk-copy stages (slower on
//   the H100: 12 copies of 128 B a group, the chunks of a group lying
//   count / 4 chunks apart), groups of 2 or 8, loads a group ahead, a
//   launch bound, __ldg, a predicated counter.
// * Every step as ops/compensated.py takes it, with the never-contracted
//   intrinsics of df_common.cuh, so the results are the plain versions' bits.

#include "df_common.cuh"

namespace ncgv {

// Largest staged window of each word array: kTile rows plus a combined halo
// of 1024 (ops/spmv_dia.py:MAX_STAGED_HALO).
constexpr int kDfMaxWindow = kTile + 1024;

// Device pointers of one launch: per right-hand side r, v[2r] / v[2r + 1]
// are its hi / lo words and y[2r] / y[2r + 1] those of its result.
struct DfVecs {
  const float* v[4];
  float* y[4];
};

template <int NRHS, bool STAGED>
__global__ void __launch_bounds__(kTile) df_dia_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo,
    const float* __restrict__ lo2, const __grid_constant__ Offsets o,
    int ndiag, int h_lo, int h_hi, long long n, long long vorg,
    long long vlen, const __grid_constant__ DfVecs a) {
  extern __shared__ __align__(16) float swin[];  // [2 NRHS][vw]
  __shared__ int soff[kMaxDiags];
  const int vw = kTile + h_lo + h_hi;
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kTile;

  load_offsets(o, ndiag, soff);
  if (STAGED) {
    for (int j = t; j < vw; j += kTile) {
      const long long g = i0 - h_lo + j + vorg;
      const bool in = g >= 0 && g < vlen;
#pragma unroll
      for (int q = 0; q < 2 * NRHS; ++q) swin[q * vw + j] = in ? a.v[q][g] : 0.0f;
    }
  }
  __syncthreads();

  const long long i = i0 + t;
  if (i >= n) return;
  Pair acc[NRHS];
#pragma unroll
  for (int r = 0; r < NRHS; ++r) acc[r] = {0.0f, 0.0f};
  for (int d = 0; d < ndiag; ++d) {
    const long long at = (long long)d * n + i;
    const float ah = __ldg(hi + at), al = __ldg(lo + at), al2 = __ldg(lo2 + at);
    const int off = soff[d];
#pragma unroll
    for (int r = 0; r < NRHS; ++r) {
      float vh, vl;
      if (STAGED) {
        vh = swin[(2 * r) * vw + t + h_lo + off];
        vl = swin[(2 * r + 1) * vw + t + h_lo + off];
      } else {
        const long long g = i + off + vorg;
        const bool in = g >= 0 && g < vlen;
        vh = in ? __ldg(a.v[2 * r] + g) : 0.0f;
        vl = in ? __ldg(a.v[2 * r + 1] + g) : 0.0f;
      }
      const Pair e = df_term(ah, al, al2, vh, vl);
      acc[r] = df_add(acc[r], fast_two_sum(e.hi, e.lo));
    }
  }
#pragma unroll
  for (int r = 0; r < NRHS; ++r) {
    a.y[2 * r][i] = acc[r].hi;
    a.y[2 * r + 1][i] = acc[r].lo;
  }
}

// The dense product: one warp per row, kDenseWarps rows per block, each
// lane's in-lane tree in groups of 2^kDenseLG leaves.
constexpr int kDenseWarps = 32;
constexpr int kDenseLG = 2;
// shared memory a block may take (227 KB on an H100)
constexpr size_t kMaxBlockSmem = 227 * 1024;
// the widest padded row the wrapper allows (ops/df_spmv.py:MAX_TREE_WIDTH)
// and the levels of the in-lane counter: a row of that width has
// width / 32 leaves a lane, 2^(depth - kDenseLG) groups, depth - kDenseLG <
// kDenseMaxD
constexpr long long kDenseMaxWidth = (long long)kTile << kMaxTreeDepth;
constexpr int kDenseMaxD = 12;
static_assert((32LL << (kDenseMaxD - 1 + kDenseLG)) >= kDenseMaxWidth,
              "the in-lane counter is too shallow for the widest row");

struct DenseWords {
  float a, al, al2;
};

// Lane l of a warp takes the columns l + 32 k of the padded width
// (warp_tree_sum) and reads their matrix words itself, evict-first (__ldcs:
// through L1 the row's stream would evict what L1 holds).  With STAGE_V the
// block first copies the vector's words into shared memory; without, they
// come through the read-only path (L1).  A warp's rows are first, first +
// stride, ...; all its lanes take part in every row, so every lane reaches
// the shuffles.
template <int NRHS, int LG, int MAXD, int WARPS, bool STAGE_V>
__global__ void __launch_bounds__(WARPS * 32) df_dense_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo,
    const float* __restrict__ lo2, long long n, int width,
    const __grid_constant__ DfVecs a) {
  constexpr int G = 1 << LG;
  extern __shared__ __align__(16) float swin[];  // [2 NRHS][n] (STAGE_V)
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * WARPS;
  const long long rows = first < n ? (n - 1 - first) / stride + 1 : 0;
  if constexpr (STAGE_V) {
#pragma unroll
    for (int q = 0; q < 2 * NRHS; ++q)
      for (long long j = threadIdx.x; j < n; j += WARPS * 32)
        swin[q * n + j] = a.v[q][j];
    __syncthreads();
  }

  for (long long ri = 0; ri < rows; ++ri) {
    const long long row = first + ri * stride;
    const long long base = row * n;
    auto fetch = [&](const int (&cols)[G], DenseWords (&cur)[G]) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = cols[j];
        cur[j] = c < n ? DenseWords{__ldcs(hi + base + c),
                                    __ldcs(lo + base + c),
                                    __ldcs(lo2 + base + c)}
                       : DenseWords{0.0f, 0.0f, 0.0f};
      }
    };
    auto vword = [&](int q, int c) {
      if constexpr (STAGE_V) {
        return swin[q * n + c];
      } else {
        return __ldg(a.v[q] + c);
      }
    };
    // padding columns are zero pairs, as the plain versions pad
    auto term = [&](const DenseWords& m, int c, Pair (&vals)[NRHS]) {
#pragma unroll
      for (int r = 0; r < NRHS; ++r)
        vals[r] = c >= n ? Pair{0.0f, 0.0f}
                         : df_term(m.a, m.al, m.al2, vword(2 * r, c),
                                   vword(2 * r + 1, c));
    };
    Pair sums[NRHS];
    warp_tree_sum<NRHS, LG, MAXD, DenseWords>(width, fetch, term, sums);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < NRHS; ++r) {
        a.y[2 * r][row] = sums[r].hi;
        a.y[2 * r + 1][row] = sums[r].lo;
      }
    }
  }
}

template <int NRHS, int LG, int MAXD, int WARPS, bool STAGE_V>
cudaError_t launch_dense_kernel(const float* h, const float* l,
                                const float* l2, long long n, int width,
                                const DfVecs& a, int device, cudaStream_t st) {
  auto kernel = df_dense_kernel<NRHS, LG, MAXD, WARPS, STAGE_V>;
  const size_t smem = STAGE_V ? size_t(2 * NRHS) * size_t(n) * sizeof(float)
                              : 0;
  long long grid = (n + WARPS - 1) / WARPS;
  if (smem) {
    // persistent: as many blocks as the card holds at once, each staging
    // the vector once
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        WARPS * 32, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidValue;
    if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  }
  kernel<<<unsigned(grid), WARPS * 32, smem, st>>>(h, l, l2, n, width, a);
  return cudaGetLastError();
}

// Rows of <= 128 padded columns take single leaves; the vector is staged
// where a block's shared memory holds it (2 RHS: n <= 14,528).
template <int NRHS>
cudaError_t launch_dense_rhs(const float* h, const float* l, const float* l2,
                             long long n, int width, const DfVecs& a,
                             int device, cudaStream_t st) {
  constexpr int W = kDenseWarps, LG = kDenseLG, D = kDenseMaxD;
  if (width <= 128)
    return launch_dense_kernel<NRHS, 0, 3, W, false>(h, l, l2, n, width, a,
                                                    device, st);
  const bool stage =
      size_t(2 * NRHS) * size_t(n) * sizeof(float) <= kMaxBlockSmem;
  if (stage)
    return launch_dense_kernel<NRHS, LG, D, W, true>(h, l, l2, n, width, a,
                                                    device, st);
  return launch_dense_kernel<NRHS, LG, D, W, false>(h, l, l2, n, width, a,
                                                   device, st);
}

DfVecs vectors_of(const void* const* v, void* const* y, int nrhs) {
  DfVecs a = {};
  for (int q = 0; q < 2 * nrhs; ++q) {
    a.v[q] = static_cast<const float*>(v[q]);
    a.y[q] = static_cast<float*>(y[q]);
  }
  return a;
}

int launch_df_dia(const void* hi, const void* lo, const void* lo2,
                  const int* offsets, int ndiag, long long n, long long vorg,
                  long long vlen, const void* const* v, void* const* y,
                  int nrhs, int staged, int device, void* stream) {
  Offsets o;
  if (!fill_offsets(offsets, ndiag, &o) || n <= 0 || vlen <= 0 ||
      (nrhs != 1 && nrhs != 2))
    return int(cudaErrorInvalidValue);
  int h_lo, h_hi;
  halo_of(offsets, ndiag, &h_lo, &h_hi);
  if (staged && kTile + h_lo + h_hi > kDfMaxWindow)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const DfVecs a = vectors_of(v, y, nrhs);
  const float* h = static_cast<const float*>(hi);
  const float* l = static_cast<const float*>(lo);
  const float* l2 = static_cast<const float*>(lo2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = unsigned((n + kTile - 1) / kTile);
  const size_t smem =
      staged ? size_t(2 * nrhs) * (kTile + h_lo + h_hi) * sizeof(float) : 0;
#define NCGV_DF_DIA(NRHS, STAGED)                                            \
  df_dia_kernel<NRHS, STAGED><<<grid, kTile, smem, st>>>(                    \
      h, l, l2, o, ndiag, h_lo, h_hi, n, vorg, vlen, a)
  if (nrhs == 1) {
    if (staged) NCGV_DF_DIA(1, true);
    else NCGV_DF_DIA(1, false);
  } else {
    if (staged) NCGV_DF_DIA(2, true);
    else NCGV_DF_DIA(2, false);
  }
#undef NCGV_DF_DIA
  return int(cudaGetLastError());
}

int launch_df_dense(const void* hi, const void* lo, const void* lo2,
                    long long n, const void* const* v, void* const* y,
                    int nrhs, int device, void* stream) {
  const long long width = pow2_ceil(n);
  if (n <= 0 || (nrhs != 1 && nrhs != 2) || width > kDenseMaxWidth)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const DfVecs a = vectors_of(v, y, nrhs);
  const float* h = static_cast<const float*>(hi);
  const float* l = static_cast<const float*>(lo);
  const float* l2 = static_cast<const float*>(lo2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(nrhs == 1
                 ? launch_dense_rhs<1>(h, l, l2, n, int(width), a, device, st)
                 : launch_dense_rhs<2>(h, l, l2, n, int(width), a, device, st));
}

}  // namespace ncgv

extern "C" {

// hi / lo / lo2: the (ndiag, n) band words; v / y: 2 nrhs device pointers
// (hi and lo words of each right-hand side and of each result); each word
// array of v has length vlen and its element vorg is row 0 (the whole
// vector: vorg = 0, vlen = n; a row shard's halo-extended words
// [left h | v | right h]: vorg = h, vlen = n + 2h); staged != 0 asks for
// the shared-memory windows.
int df_dia_spmv_f32(const void* hi, const void* lo, const void* lo2,
                    const int* offsets, int ndiag, long long n,
                    long long vorg, long long vlen, const void* const* v,
                    void* const* y, int nrhs, int staged, int device,
                    void* stream) {
  return ncgv::launch_df_dia(hi, lo, lo2, offsets, ndiag, n, vorg, vlen, v,
                             y, nrhs, staged, device, stream);
}

// hi / lo / lo2: the (n, n) matrix words, row-major; v / y as above.
int df_dense_spmv_f32(const void* hi, const void* lo, const void* lo2,
                      long long n, const void* const* v, void* const* y,
                      int nrhs, int device, void* stream) {
  return ncgv::launch_df_dense(hi, lo, lo2, n, v, y, nrhs, device, stream);
}

}  // extern "C"
