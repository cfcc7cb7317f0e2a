// Shared pieces of kernels K6 (csrc/ldl_factor.cu), K7 (csrc/ldl_inverse.cu)
// and K8 (csrc/ldl_solve.cu): the static-pivot blocked LDL^T of a batch of
// quasidefinite KKT matrices and its two uses.
//
// Layouts, as in the JAX package's Pallas kernels (ops/ldl_kernel.py):
// K (B, N, N) row-major; the factor pads it to Np = nbp * p with an identity
// tail; L (B, Np, Np) unit-lower (zeros above the diagonal); d (B, Np);
// Linv (B, nbp * p, p), the unit-lower inverses of the diagonal panels
// stacked flat; Kinv (B, N, N); b and x (B, N).  The panel p is at most 16.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace cvxldl {

constexpr int kThreads = 256;
constexpr int kMaxPanel = 16;
// per-block dynamic shared memory limit on Hopper
constexpr size_t kSmemLimit = 232448;

// The dimensions every entry point checks: B >= 1, 1 <= p <= 16, N <= Np,
// Np a multiple of p with fewer than p padding rows.
inline bool dims_ok(int B, int N, int Np, int p) {
  return B > 0 && N > 0 && p > 0 && p <= kMaxPanel && Np % p == 0 &&
         N <= Np && Np - N < p;
}

// Sum of `v` over the 16 lanes of a half-warp; lane 0 of each half holds it.
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off, 16);
  return v;
}

}  // namespace cvxldl
