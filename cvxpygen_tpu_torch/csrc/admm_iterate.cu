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
// Per instance and iteration: 2 m n + n^2 multiply-adds on M^-1 (n x n) and
// A (m x n), 420 KB of float32 at the MPC shape n=222, m=252, each matrix
// element feeding one multiply-add.  Instances do not interact, so the
// layout does not change the answer.
//
// Design: the matrices resident in shared memory across a cluster.
//  - One cluster of c thread blocks of 256 threads per instance, c the
//    smallest of 1, 2, 4, 8 for which each block's rows of M^-1 and A fit
//    its shared memory beside the vectors (resident_words): c = 2 at the
//    MPC shape (210.4 KB of matrix rows and 10.6 KB of vectors per block),
//    c = 1 at the portfolio shape n=130, m=172.  Each block copies its row
//    slices from global memory once per launch (16-byte cp.async), so each
//    matrix is read from device memory once per launch instead of n_iters
//    times: 0.86 GB at B=2048 on the MPC shape, 0.26 ms at 3.35 TB/s.
//  - Per iteration, two cluster barriers.  Each block forms the partial
//    A'(rho z - y) over its rows of A (one thread per column); after the
//    first barrier every block adds the team's partials in cluster-rank
//    order through distributed shared memory, so the rhs is the same,
//    bitwise, in each block and from run to run.  Each block computes its
//    rows of x~ = M^-1 rhs (one warp per row) and writes them into every
//    block of the team; after the second barrier each block does A x~ and
//    the z/y update on its rows of A, and the x update (all of x, the same
//    arithmetic in each block).
//  - What bounds it now: shared-memory bandwidth.  Each block reads its
//    matrix rows once per iteration, about 320 KB per SM at the MPC shape
//    (1.4 us at 128 B per clock), with 31 waves of 132 SMs at B=2048:
//    about 0.7 ms for 15 iterations, plus the barriers' latency.
//  - Large shapes, where c = 8 does not fit: the same kernel file keeps the
//    streaming layout (iterate_stream_kernel), one block per instance that
//    rereads M^-1 and A from global memory every iteration, with only the
//    vectors in shared memory (4 n + 7 m floats).  The wrapper picks the
//    layout by shape (pick_iterate_ctas: 0 means streaming).
//  - Full float32 FMA, no TF32, no fast math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "resident.cuh"

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

// 4-byte words of the streaming layout's shared memory (its vectors)
size_t stream_words(int n, int m) { return (size_t)4 * n + 7 * m; }

// 4-byte words of the resident layout's shared memory for a team of c
// blocks (iterate_smem_bytes in the Python wrapper mirrors this formula):
// the block's rows of M^-1 and of A, x, q, rhs, x~ and the partial A'v
// (n each), and z, y, l, u, rho, 1/rho and v on the block's rows of A
size_t resident_words(int n, int m, int c) {
  const Rows kr = team_rows(n, c, 0), ir = team_rows(m, c, 0);
  return slice_words(kr.hi - kr.lo, n) + slice_words(ir.hi - ir.lo, n) +
         (size_t)5 * n + (size_t)7 * (ir.hi - ir.lo);
}

// the resident layout: one cluster of c blocks per instance (see the note
// at the top)
__global__ void __launch_bounds__(kThreads) iterate_resident_kernel(
    const Params p) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = p.n, m = p.m;
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x / c;
  const Rows kr = team_rows(n, c, rank), ir = team_rows(m, c, rank);
  const int nk = kr.hi - kr.lo, ni = ir.hi - ir.lo;
  const Rows kr0 = team_rows(n, c, 0), ir0 = team_rows(m, c, 0);
  float* mbuf = smem;
  float* abuf = mbuf + slice_words(kr0.hi - kr0.lo, n);
  float* X = abuf + slice_words(ir0.hi - ir0.lo, n);  // n
  float* Q = X + n;                                   // n
  float* Rhs = Q + n;                                 // n
  float* Xt = Rhs + n;                                // n
  float* Part = Xt + n;                               // n: partial A'v
  const int rm = ir0.hi - ir0.lo;
  float* Z = Part + n;    // rm: this block's rows of A
  float* Y = Z + rm;
  float* L = Y + rm;
  float* U = L + rm;
  float* Rho = U + rm;
  float* Rinv = Rho + rm;
  float* V = Rinv + rm;
  const float sigma = p.sigma, alpha = p.alpha;

  const float* Ms =
      load_slice(mbuf, p.Minv + (b * n + kr.lo) * n, nk * n);
  const float* As = load_slice(abuf, p.A + (b * m + ir.lo) * n, ni * n);
  for (int j = tid; j < n; j += kThreads) {
    X[j] = p.x[b * n + j];
    Q[j] = p.q[b * n + j];
  }
  for (int i = tid; i < ni; i += kThreads) {
    const size_t g = b * m + ir.lo + i;
    Z[i] = p.z[g];
    Y[i] = p.y[g];
    L[i] = p.l[g];
    U[i] = p.u[g];
    Rho[i] = p.rho[g];
    Rinv[i] = 1.0f / Rho[i];
  }
  cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < p.n_iters; ++t) {
    for (int i = tid; i < ni; i += kThreads) V[i] = Rho[i] * Z[i] - Y[i];
    __syncthreads();
    scolsum<1>(As, n, V, 0, ni, n, Part, 0);
    cl.sync();
    // rhs = sigma x - q + v A, the team's partials in rank order
    for (int j = tid; j < n; j += kThreads)
      Rhs[j] = (sigma * X[j] - Q[j]) + team_sum(Part, j, 0, c);
    __syncthreads();
    // this block's rows of x~ = M^-1 rhs, into every block of the team
    srowdot(Ms, n, Rhs, nk, n,
                [&](int k, float acc) { team_put(Xt, kr.lo + k, acc, 0, c); });
    cl.sync();
    // z~ = A x~ on this block's rows, then the relaxed z and y updates
    srowdot(As, n, Xt, ni, n, [&](int i, float zt) {
      const float w = alpha * zt + (1.0f - alpha) * Z[i] + Rinv[i] * Y[i];
      const float z1 = fminf(fmaxf(w, L[i]), U[i]);
      Z[i] = z1;
      Y[i] = Rho[i] * (w - z1);
    });
    for (int j = tid; j < n; j += kThreads)
      X[j] = alpha * Xt[j] + (1.0f - alpha) * X[j];
    __syncthreads();
  }
  if (rank == 0)
    for (int j = tid; j < n; j += kThreads) p.ox[b * n + j] = X[j];
  for (int i = tid; i < ni; i += kThreads) {
    p.oz[b * m + ir.lo + i] = Z[i];
    p.oy[b * m + ir.lo + i] = Y[i];
  }
  // no block leaves while a peer may still read its shared memory
  cl.sync();
}

// the streaming layout (shapes where no team of 8 holds the matrices): one
// block per `blk` instances, M^-1 and A reread from global memory every
// iteration; A' v one thread per column, M^-1 rhs and A x~ one warp per row
__global__ void __launch_bounds__(kThreads) iterate_stream_kernel(
    const Params p) {
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
// ctas 1, 2, 4 or 8 takes the resident layout (one cluster of ctas blocks
// per instance; blk must be 1), ctas 0 the streaming one (blk instances
// per block).
extern "C" int admm_iterate_f32(const float* Minv, const float* A,
                                const float* q, const float* l, const float* u,
                                const float* rho, const float* x,
                                const float* z, const float* y, float* ox,
                                float* oz, float* oy, int B, int n, int m,
                                int blk, int ctas, float sigma, float alpha,
                                int n_iters, void* stream) {
  if (blk <= 0 || B % blk != 0 || n <= 0 || m <= 0 || n_iters < 0 ||
      (ctas != 0 && (blk != 1 || ctas > kMaxTeam || (ctas & (ctas - 1)))))
    return (int)cudaErrorInvalidValue;
  Params p{Minv, A, q, l, u, rho, x, z, y, ox, oz, oy, n, m, blk, n_iters,
           sigma, alpha};
  if (ctas == 0) {
    const size_t smem = 4 * stream_words(n, m);
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        iterate_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    iterate_stream_kernel<<<B / blk, kThreads, smem, (cudaStream_t)stream>>>(
        p);
    return (int)cudaGetLastError();
  }
  const size_t smem = 4 * resident_words(n, m, ctas);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      iterate_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, iterate_resident_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
