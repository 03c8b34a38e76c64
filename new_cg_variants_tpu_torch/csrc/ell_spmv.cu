// Padded-ELL SpMV, y = A v (1 right-hand side) or (A v, A w) (2), for a
// general sparse matrix stored as L slots per row:
//   y[i] = sum_l val[i, l] * v[idx[i, l]],
// padding slots holding value 0 and index i.  The arrays arrive slot-major:
// val_t[l * n + i] = val[i, l], idx_t[l * n + i] = idx[i, l] (int32).
//
// The storage may hold the rows in a locality order instead: the matrix
// B = P A P^T, row i of B being row perm[i] of A with its slots in the same
// order and its column indices mapped through the inverse permutation.  A
// solve iterates on B itself, in that order's basis (ops/block_banded.py:
// solver_basis): its products take the given-order path (PERM = false) on
// B's storage, and ell_gather_kernel moves the solve's vectors into the
// basis once a solve (and applies a preconditioner given in the original
// order).  A single product of A from that storage (PERM = true) is
// y[perm] = B v[perm]: ell_gather_kernel gathers v (and w) into that order,
// and the product kernel gathers locally and writes y[perm[i]] directly.
// Every row's terms are the same products added in the same slot order, so
// both orders give the same bits.
//
// Replaces the TPU kernel new_cg_variants_tpu/ops/ell_pallas.py:_ell_kernel
// (entry points ell_spmv, ell_spmv2).  That kernel tiles 512 rows and keeps
// the whole vector in VMEM (n <= 4M); both are TPU limits and are not
// carried over: any n < 2^31, any L >= 1.
//
// What bounds it on an H100: device-memory bytes.  Per call it must read
// val and idx once (n L (s + 4) bytes, s the value size), each right-hand
// side once and write each result once: at n = 1,124,864 and L = 27 in f32
// (HPCG's 27-point operator) 252 MB, 75 us at 3.35 TB/s (2 RHS: 78 us),
// against ~1 us of arithmetic (2 operations per slot per RHS) at 67 TFLOP/s.
// With the values stored in bf16 (ell_spmv_bf16: 2-byte values, int32
// indices, float32 vectors; storage.cuh) 191 MB, 57 us.
// The gathers of v are the other cost: each moves a 32-byte L2 sector for
// one value.  v (4.5 MB in f32) fits the 50 MB L2, so a gather is an L2 hit;
// in a scattered (randomly permuted) numbering every one of the 30M gathers
// moves its own sector, ~1 GB of L2 traffic per product, and the kernel ran
// at 31% of its byte bound (17% with 2 RHS, whose gathers of v and w at one
// index were two sectors).  In a locality order neighbouring rows gather
// neighbouring columns and share sectors, as in a grid's natural order (84%).
//
// What the design does about it:
// * The operator keeps its rows in the reverse Cuthill-McKee order its
//   format policy computes anyway (ops/operators.py).  The two permute
//   passes of that order cost n scattered 4-byte reads and n scattered
//   writes, a 32-byte sector each, so a solve pays them once, outside its
//   loop (solver_basis), not on every product.
// * A row shard of that operator whose cache is the whole vector (the
//   all-gather route of parallel/contexts.py:EllRowShardContext) keeps its
//   rows in the same order, and its columns compacted in that order
//   (parallel/dist.py): the gather in reads only the columns the shard
//   touches, so the gathered vector is c <= n long, not n, and the second
//   right-hand side's buffer is passed in (v1) rather than found at v0 + n.
// * With 2 right-hand sides in that order, v and w are gathered in as two
//   arrays.  Interleaving them as (n, 2), so that a slot gathers both in
//   one 8-byte load from one sector, measured within 2% either way at
//   HPCG's shape in RCM order and on the shards, and 5% slower at 32^3 in
//   float64 (chip_study.py ellopts): in a locality order the two gathers
//   already share their sectors with the neighbouring rows'.
// * val, idx and perm are read once and streamed with evict-first loads
//   (__ldcs), so the 252 MB stream does not push the gathered vector out of
//   L2; the vector goes through the read-only path (__ldg).
// * One thread per row, kEllThreads rows per block.  Slot-major storage
//   makes slot l of 32 neighbouring rows one coalesced 128-byte read.
// * A row's slots go in chunks of kEllChunk: the chunk's val / idx loads,
//   then its gathers, then its terms (ell_chunk), each group issued
//   together, so a chunk stands through two memory trips, not two a slot.
//   At n = 32,768 (HPCG 32^3 in float64) the card holds ~8 warps an SM
//   whatever the block size, too few to hide per-slot trips: one slot a
//   step took 0.0102 ms with its gather in, chunks 0.0074 (0.0033 ms
//   byte bound).  The compiler hoists no load past the term that waits
//   for the one before it, so the chunk's groups are joined by data
//   (ell_chunk says how).  128 rows a block: 64 and 256 were 5% slower
//   at n = 32,768, within 2% at HPCG 104^3.
// * Terms are added in slot order with explicit fused multiply-adds, chunk
//   or no chunk (the same instructions in both orders, and as one slot a
//   step); no atomics, no shared memory.

#include "storage.cuh"

namespace ncgv {

constexpr int kEllThreads = 128;
// slots of a row whose loads are issued together (HPCG's L = 27: 14 + 13)
constexpr int kEllChunk = 14;

// Storage read once per product (val, idx, perm): evict-first.
template <typename T>
__device__ __forceinline__ T stream(const T* p) {
  return __ldcs(p);
}

// The bits of a loaded value as an int (a double's low word).
__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }
__device__ __forceinline__ int bits(double x) { return __double2loint(x); }
__device__ __forceinline__ int bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// acc with w or'ed into its bits: the same value when w is 0, but not
// before w is known.
__device__ __forceinline__ float after(float acc, int w) {
  return __int_as_float(__float_as_int(acc) | w);
}
__device__ __forceinline__ double after(double acc, int w) {
  return __hiloint2double(__double2hiint(acc), __double2loint(acc) | w);
}

// Slots [l0, l0 + K) of the row whose first value is at a (index at c):
// every value and index load first, then every gather, then the terms in
// slot order.  Left to itself the compiler issues each gather right after
// its own index load, and each term right after its own gather, and a warp
// waits at each: one round trip a slot whatever the source order.  So the
// chunk joins twice on z, the minimum of 0 and its indices: 0 (indices are
// >= 0), but only once every index has arrived.  Every gather address
// takes z plus each value's bits and z (0, once every value has arrived
// too): the chunk's loads are all in flight before its first gather.  The
// first term takes z plus each gather's bits and z or'ed into the sum: the
// gathers all go out before it.
template <int K, typename T, typename D, int NRHS>
__device__ __forceinline__ void ell_chunk(const D* a, const int* c,
                                          long long n, int l0, const T* v0,
                                          const T* v1, T& acc0, T& acc1) {
  D x[K];
  int j[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long o = (long long)(l0 + k) * n;
    x[k] = stream(a + o);
    j[k] = stream(c + o);
  }
  int z = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) z = min(z, j[k]);
  int zv = z;
#pragma unroll
  for (int k = 0; k < K; ++k) zv += bits(x[k]) & z;
  T g0[K], g1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    g0[k] = __ldg(v0 + (j[k] + zv));
    if constexpr (NRHS == 2) g1[k] = __ldg(v1 + (j[k] + zv));
  }
  int zg = z;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    zg += bits(g0[k]) & z;
    if constexpr (NRHS == 2) zg += bits(g1[k]) & z;
  }
  acc0 = after(acc0, zg);
  if constexpr (NRHS == 2) acc1 = after(acc1, zg);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T xk = widen(x[k]);
    acc0 = fma(xk, g0[k], acc0);
    if constexpr (NRHS == 2) acc1 = fma(xk, g1[k], acc1);
  }
}

// The last r < K slots from l0: one chunk of r.
template <int K, typename T, typename D, int NRHS>
__device__ __forceinline__ void ell_rest(int r, const D* a, const int* c,
                                         long long n, int l0, const T* v0,
                                         const T* v1, T& acc0, T& acc1) {
  if constexpr (K > 1) {
    if (r == K - 1)
      ell_chunk<K - 1, T, D, NRHS>(a, c, n, l0, v0, v1, acc0, acc1);
    else
      ell_rest<K - 1, T, D, NRHS>(r, a, c, n, l0, v0, v1, acc0, acc1);
  }
}

// PERM = false: the given order, v0 / v1 the right-hand sides.  PERM = true:
// the storage holds B (or a shard's rows in a locality order), v0 / v1 the
// vectors ell_gather_kernel gathered into its column order, and row i's
// result goes to y[perm[i]].  Values stored as D, widened to T.
template <typename T, typename D, int NRHS, bool PERM>
__global__ void __launch_bounds__(kEllThreads) ell_spmv_kernel(
    const D* __restrict__ val_t, const int* __restrict__ idx_t, int L,
    long long n, const int* __restrict__ perm, const T* __restrict__ v0,
    const T* __restrict__ v1, T* __restrict__ y0, T* __restrict__ y1) {
  const long long i = (long long)blockIdx.x * kEllThreads + threadIdx.x;
  if (i >= n) return;
  // issued first: the row's destination is not needed until the end
  const long long out = PERM ? (long long)stream(perm + i) : i;
  const D* a = val_t + i;
  const int* c = idx_t + i;
  T acc0 = T(0), acc1 = T(0);
  int l = 0;
  for (; l + kEllChunk <= L; l += kEllChunk)
    ell_chunk<kEllChunk, T, D, NRHS>(a, c, n, l, v0, v1, acc0, acc1);
  if (l < L)
    ell_rest<kEllChunk, T, D, NRHS>(L - l, a, c, n, l, v0, v1, acc0, acc1);
  y0[out] = acc0;
  if constexpr (NRHS == 2) y1[out] = acc1;
}

// xs[i] = v0[perm[i]] (and xs[n + i] = v1[perm[i]]) for i < n: n the
// entries gathered, not the vectors' length.
template <typename T, int NRHS>
__global__ void __launch_bounds__(kEllThreads) ell_gather_kernel(
    const int* __restrict__ perm, long long n, const T* __restrict__ v0,
    const T* __restrict__ v1, T* __restrict__ xs) {
  const long long i = (long long)blockIdx.x * kEllThreads + threadIdx.x;
  if (i >= n) return;
  const int p = stream(perm + i);
  xs[i] = __ldg(v0 + p);
  if constexpr (NRHS == 2) xs[n + i] = __ldg(v1 + p);
}

inline unsigned ell_grid(long long n) {
  return unsigned((n + kEllThreads - 1) / kEllThreads);
}

// T: the vectors' type; D: the values' (T, or __nv_bfloat16 with T = float)
template <typename T, typename D = T>
int launch_ell_spmv(const void* val_t, const void* idx_t, int L, long long n,
                    const void* perm, const void* v0, const void* v1,
                    void* y0, void* y1, int nrhs, int device, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || L < 1 || (nrhs != 1 && nrhs != 2))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const D* a = static_cast<const D*>(val_t);
  const int* c = static_cast<const int*>(idx_t);
  const int* p = static_cast<const int*>(perm);
  const T* x0 = static_cast<const T*>(v0);
  const T* x1 = static_cast<const T*>(v1);
  T* r0 = static_cast<T*>(y0);
  T* r1 = static_cast<T*>(y1);
#define NCGV_ELL(NRHS, PERM)                                      \
  ell_spmv_kernel<T, D, NRHS, PERM><<<ell_grid(n), kEllThreads, 0, st>>>( \
      a, c, L, n, p, x0, x1, r0, r1)
  if (p) {
    if (nrhs == 1) NCGV_ELL(1, true);
    else NCGV_ELL(2, true);
  } else {
    if (nrhs == 1) NCGV_ELL(1, false);
    else NCGV_ELL(2, false);
  }
#undef NCGV_ELL
  return int(cudaGetLastError());
}

template <typename T>
int launch_ell_gather(const void* perm, long long n, const void* v0,
                      const void* v1, void* xs, int nrhs, int device,
                      void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || (nrhs != 1 && nrhs != 2))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
  const T* x0 = static_cast<const T*>(v0);
  const T* x1 = static_cast<const T*>(v1);
  T* out = static_cast<T*>(xs);
  if (nrhs == 1)
    ell_gather_kernel<T, 1><<<ell_grid(n), kEllThreads, 0, st>>>(p, n, x0, x1,
                                                                 out);
  else
    ell_gather_kernel<T, 2><<<ell_grid(n), kEllThreads, 0, st>>>(p, n, x0, x1,
                                                                 out);
  return int(cudaGetLastError());
}

}  // namespace ncgv

extern "C" {

// val_t / idx_t: (L, n) slot-major, contiguous.  perm: null for the given
// order (v0 / v1 the right-hand sides), else the locality order of the
// storage's rows (int32, n) and v0 / v1 the vectors ell_gather filled in
// its column order (the two halves of its buffer).  v1 / y1 unused when
// nrhs = 1.
int ell_spmv_f32(const void* val_t, const void* idx_t, int L, long long n,
                 const void* perm, const void* v0, const void* v1, void* y0,
                 void* y1, int nrhs, int device, void* stream) {
  return ncgv::launch_ell_spmv<float>(val_t, idx_t, L, n, perm, v0, v1, y0,
                                      y1, nrhs, device, stream);
}

int ell_spmv_f64(const void* val_t, const void* idx_t, int L, long long n,
                 const void* perm, const void* v0, const void* v1, void* y0,
                 void* y1, int nrhs, int device, void* stream) {
  return ncgv::launch_ell_spmv<double>(val_t, idx_t, L, n, perm, v0, v1, y0,
                                       y1, nrhs, device, stream);
}

// val_t in bf16; v0 / v1 / y0 / y1 in float32 (the gather in is
// ell_gather_f32's)
int ell_spmv_bf16(const void* val_t, const void* idx_t, int L, long long n,
                  const void* perm, const void* v0, const void* v1, void* y0,
                  void* y1, int nrhs, int device, void* stream) {
  return ncgv::launch_ell_spmv<float, __nv_bfloat16>(
      val_t, idx_t, L, n, perm, v0, v1, y0, y1, nrhs, device, stream);
}

// perm: the n entries to gather (int32, any indices into v0 / v1); xs:
// nrhs * n values; v1 unused when nrhs = 1.
int ell_gather_f32(const void* perm, long long n, const void* v0,
                   const void* v1, void* xs, int nrhs, int device,
                   void* stream) {
  return ncgv::launch_ell_gather<float>(perm, n, v0, v1, xs, nrhs, device,
                                        stream);
}

int ell_gather_f64(const void* perm, long long n, const void* v0,
                   const void* v1, void* xs, int nrhs, int device,
                   void* stream) {
  return ncgv::launch_ell_gather<double>(perm, n, v0, v1, xs, nrhs, device,
                                         stream);
}

}  // extern "C"
