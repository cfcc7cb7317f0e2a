// Kernel K8: x = K^-1 b for a factored batch (kernel K6's L, d and panel
// inverses): the forward sweep, the diagonal and the backward sweep.
//
// Replaces cvxpygen_tpu/ops/ldl_kernel.py::_solve_kernel (wrapper
// ldl_solve_pallas), the Pallas TPU kernel that the conic IPM's 'ldl' KKT
// mode runs for every KKT solve when IPMSettings.ldl_inverse is False, and
// computes the same function: b (B, N) -> x (B, N) in the layouts of
// csrc/ldl.cuh.  Its plain torch version is ldl_solve_plain in
// cvxpygen_tpu_torch/ops/ldl_kernel.py, which also builds and binds this
// file (nvcc for sm_90a, ctypes).
//
// What bounds it.  Bytes: the function reads the strictly lower triangle
// of L, d and the panel inverses once (59 MB at the entropy family's
// N = 161, B = 1024: 0.018 ms at 3.35 TB/s) for 2 N^2 FLOP per instance.
//
// Design (a first version that is right before it is fast): one block of
// 256 threads per instance keeps the right-hand side and the solution in
// shared memory.  The forward sweep's row products go to half-warps (16
// lanes read 16 neighbouring entries of a row of L21, then a shuffle sum);
// the backward sweep's column products to one thread per column, whose
// reads of a row of L are neighbouring across threads.  L is read twice,
// the second time mostly from L2.
#include "ldl.cuh"

namespace {

using namespace cvxldl;

__global__ void __launch_bounds__(kThreads)
    ldl_solve_kernel(const float* __restrict__ L, const float* __restrict__ d,
                     const float* __restrict__ Linv,
                     const float* __restrict__ rhs, int N, int Np, int p,
                     float* __restrict__ x) {
  extern __shared__ __align__(16) float smem[];
  float* r = smem;        // right-hand side being reduced (Np)
  float* s = smem + Np;   // solution so far (Np)
  __shared__ float s_z[kMaxPanel];
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 15, group = tid >> 4;
  const float* Lb = L + b * (size_t)Np * Np;
  const float* db = d + b * (size_t)Np;
  const float* Vb = Linv + b * (size_t)Np * p;

  for (int i = tid; i < Np; i += kThreads)
    r[i] = (i < N) ? rhs[b * (size_t)N + i] : 0.0f;
  const int nbp = Np / p;
  // forward: L z = b
  for (int k = 0; k < nbp; ++k) {
    const int o = k * p;
    __syncthreads();
    if (tid < p) {
      const float* v = Vb + (size_t)(o + tid) * p;
      float acc = 0.0f;
      for (int j = 0; j < p; ++j) acc += v[j] * r[o + j];
      s_z[tid] = acc;
      s[o + tid] = acc;
    }
    __syncthreads();
    // every warp runs the same trips, so the shuffles see all 32 lanes
    for (int r0 = 0; r0 < Np - o - p; r0 += kThreads / 16) {
      const int rr = r0 + group;
      const bool row = rr < Np - o - p;
      float v = (row && lane < p)
                    ? Lb[(size_t)(o + p + rr) * Np + o + lane] * s_z[lane]
                    : 0.0f;
      v = half_warp_sum(v);
      if (row && lane == 0) r[o + p + rr] -= v;
    }
  }
  __syncthreads();
  for (int i = tid; i < Np; i += kThreads) r[i] = s[i] / db[i];
  // backward: L' x = w
  for (int k = nbp - 1; k >= 0; --k) {
    const int o = k * p;
    __syncthreads();
    if (tid < p) {
      float acc = 0.0f;
      for (int j = 0; j < p; ++j)
        acc += Vb[(size_t)(o + j) * p + tid] * r[o + j];
      s_z[tid] = acc;
      s[o + tid] = acc;
    }
    __syncthreads();
    for (int c = tid; c < o; c += kThreads) {
      float acc = 0.0f;
      for (int i = 0; i < p; ++i) acc += Lb[(size_t)(o + i) * Np + c] * s_z[i];
      r[c] -= acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += kThreads) x[b * (size_t)N + i] = s[i];
}

}  // namespace

// Launches kernel K8 on `stream`: L (B, Np, Np), d (B, Np), Linv (B, Np, p),
// b (B, N) -> x (B, N).  Returns the CUDA error code (0 = success).
extern "C" int ldl_solve_f32(const float* L, const float* d, const float* Linv,
                             const float* b, int B, int N, int Np, int p,
                             float* x, void* stream) {
  if (!dims_ok(B, N, Np, p)) return (int)cudaErrorInvalidValue;
  const size_t smem = 8 * (size_t)Np;
  if (smem + 4 * kMaxPanel > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ldl_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ldl_solve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      L, d, Linv, b, N, Np, p, x);
  return (int)cudaGetLastError();
}
