// Storage and compute types of the matrix kernels (sym_dia.cu, sym_family.cu,
// dia_spmv.cu, dia_family.cu, ell_spmv.cu).
//
// Each is a template over the type T of its vectors, scalars, dot partials
// and arithmetic and the type D in which the matrix values are stored: D = T
// (float32, float64), or the bf16 storage tier, D = __nv_bfloat16 with
// T = float (the JAX package's tier: the matrix in bf16, everything else in
// float32, solvers/api.py:_vector_dtype).  A stored value is loaded as D and
// widened to T (widen, exact), and from there the arithmetic is the D = T
// kernel's, in the same order: a bf16 entry on data gives the bits of the
// float32 entry on data.float().  The _bf16 entry points are these
// instantiations.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ncgv {

// A stored value in the compute type.
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

}  // namespace ncgv
