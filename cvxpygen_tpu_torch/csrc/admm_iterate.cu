// Kernel K3: n_iters fused ADMM iterations for a batch of QPs, each with its
// own M^-1 and A held fixed.
//
// Replaces cvxpygen_tpu/ops/admm_kernel.py::_admm_block_kernel (the Pallas
// TPU kernel) and computes the same function: per iteration
//   rhs = sigma x - q + A'(rho z - y),  x~ = M^-1 rhs,  z~ = A x~,
//   x = alpha x~ + (1 - alpha) x,  w = alpha z~ + (1 - alpha) z + y / rho,
//   z = clip(w, l, u),  y = rho (w - z).
// No refinement sweep and no checks, as in the TPU kernel.  Its plain torch
// version is admm_iterate_plain in cvxpygen_tpu_torch/ops/admm_kernel.py,
// which also builds and binds this file (nvcc for sm_90a, ctypes).
//
// What bounds it.  Per instance and iteration it does 2 m n + n^2
// multiply-adds on M^-1 (n x n) and A (m x n), 420 KB of float32 at the MPC
// shape n=222, m=252: bytes-bound, since each matrix element feeds one
// multiply-add.  The least traffic reads each matrix once per call.
//
// Design (a first version that is right before it is fast):
//  - one block of 256 threads per `block` instances, taken one after the
//    other (block 1 on the main path: one instance per block);
//  - the instance's x, z, y, q, l, u, rho and the temporaries live in
//    shared memory (4 n + 7 m floats, 10.6 KB at the MPC shape);
//  - M^-1 and A are read from global memory every iteration: 420 KB per
//    instance is more than the 227 KB of shared memory a block can hold,
//    so this version rereads them n_iters times (the TPU kernel keeps them
//    resident in VMEM).  A' v runs one thread per column (coalesced, eight
//    loads in flight per thread); M^-1 rhs and A x~ run one warp per row.
#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm.cuh"

namespace {

using namespace cvxk;

constexpr size_t kSmemLimit = 232448;

struct Params {
  const float* Minv;  // (B, n, n)
  const float* A;     // (B, m, n)
  const float* q;     // (B, n)
  const float* l;     // (B, m)
  const float* u;     // (B, m)
  const float* rho;   // (B, m)
  const float* x;     // (B, n)
  const float* z;     // (B, m)
  const float* y;     // (B, m)
  float* ox;          // (B, n)
  float* oz;          // (B, m)
  float* oy;          // (B, m)
  int n, m, blk, n_iters;
  float sigma, alpha;
};

size_t smem_words(int n, int m) { return (size_t)4 * n + 7 * m; }

__global__ void __launch_bounds__(kThreads) iterate_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m;
  const int tid = threadIdx.x;
  float* X = smem;       // n
  float* Q = X + n;      // n
  float* Rhs = Q + n;    // n
  float* Xt = Rhs + n;   // n
  float* Z = Xt + n;     // m
  float* Y = Z + m;      // m
  float* L = Y + m;      // m
  float* U = L + m;      // m
  float* Rho = U + m;    // m
  float* Rinv = Rho + m;  // m
  float* V = Rinv + m;   // m
  const float sigma = p.sigma, alpha = p.alpha;

  for (int r = 0; r < p.blk; ++r) {
    const size_t b = (size_t)blockIdx.x * p.blk + r;
    const float* Minv = p.Minv + b * n * n;
    const float* A = p.A + b * m * n;
    for (int j = tid; j < n; j += kThreads) {
      X[j] = p.x[b * n + j];
      Q[j] = p.q[b * n + j];
    }
    for (int i = tid; i < m; i += kThreads) {
      Z[i] = p.z[b * m + i];
      Y[i] = p.y[b * m + i];
      L[i] = p.l[b * m + i];
      U[i] = p.u[b * m + i];
      Rho[i] = p.rho[b * m + i];
      Rinv[i] = 1.0f / Rho[i];
    }
    __syncthreads();
    for (int t = 0; t < p.n_iters; ++t) {
      for (int i = tid; i < m; i += kThreads) V[i] = Rho[i] * Z[i] - Y[i];
      __syncthreads();
      // rhs = sigma x - q + v A
      rowgemm<1, true>(V, m, A, n, [&](int, int j, float acc) {
        Rhs[j] = (sigma * X[j] - Q[j]) + acc;
      });
      __syncthreads();
      // x~ = M^-1 rhs
      rowdot(Minv, Rhs, n, n, [&](int i, float acc) { Xt[i] = acc; });
      __syncthreads();
      // z~ = A x~, then the relaxed z and y updates of row i
      rowdot(A, Xt, m, n, [&](int i, float zt) {
        const float w = alpha * zt + (1.0f - alpha) * Z[i] + Rinv[i] * Y[i];
        const float z1 = fminf(fmaxf(w, L[i]), U[i]);
        Z[i] = z1;
        Y[i] = Rho[i] * (w - z1);
      });
      for (int j = tid; j < n; j += kThreads)
        X[j] = alpha * Xt[j] + (1.0f - alpha) * X[j];
      __syncthreads();
    }
    for (int j = tid; j < n; j += kThreads) p.ox[b * n + j] = X[j];
    for (int i = tid; i < m; i += kThreads) {
      p.oz[b * m + i] = Z[i];
      p.oy[b * m + i] = Y[i];
    }
    __syncthreads();
  }
}

}  // namespace

// Launches kernel K3 on `stream`; returns the CUDA error code (0 = success).
extern "C" int admm_iterate_f32(const float* Minv, const float* A,
                                const float* q, const float* l, const float* u,
                                const float* rho, const float* x,
                                const float* z, const float* y, float* ox,
                                float* oz, float* oy, int B, int n, int m,
                                int blk, float sigma, float alpha, int n_iters,
                                void* stream) {
  if (blk <= 0 || B % blk != 0 || n <= 0 || m <= 0 || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * smem_words(n, m);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p{Minv, A, q, l, u, rho, x, z, y, ox, oz, oy, n, m, blk, n_iters,
           sigma, alpha};
  iterate_kernel<<<B / blk, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
