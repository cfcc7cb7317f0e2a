// Kernel K7: the explicit inverse Kinv = L'^-1 D^-1 L^-1 of a factored batch
// (kernel K6's L, d and panel inverses), by two panel sweeps on the identity.
//
// Replaces cvxpygen_tpu/ops/ldl_kernel.py::_inverse_kernel (wrapper
// ldl_inverse_pallas), the Pallas TPU kernel that the conic IPM's 'ldl' KKT
// mode runs after every factorization so that each KKT solve is one batched
// product, and computes the same function: Kinv (B, N, N) from the layouts
// of csrc/ldl.cuh.  Its plain torch version is ldl_inverse_plain in
// cvxpygen_tpu_torch/ops/ldl_kernel.py, which also builds and binds this
// file (nvcc for sm_90a, ctypes).
//
// What bounds it.  At the entropy family's shape (N = 161, Np = 176,
// B = 1024, float32) the function must read L's lower triangle, d and the
// panel inverses (59 MB) and write Kinv (106 MB): 0.049 ms at 3.35 TB/s.
// An inverse from an LDL^T needs 2 N^3 / 3 = 2.8 MFLOP per instance
// (2.8 GFLOP, 0.043 ms at the FP32 peak), so it is bytes-bound.  This
// design does about 2 (Np^3 + p Np^2) = 11.9 MFLOP per instance (both
// sweeps over every column, zeros and both triangles of Kinv included), so
// its operations bound it first.
//
// Design (a first version that is right before it is fast): the columns of
// Kinv are independent, so one block of 256 threads takes one instance and
// one tile of 16 columns, and keeps the tile's (Np, 16) right-hand block in
// shared memory (11 KB at Np = 176) through the forward sweep, the diagonal
// scaling and the backward sweep.  The instance's L and Linv come from L2,
// where its tiles (blocks with neighbouring indices) share them.  It does
// not skip the zeros of L^-1 above the tile's first column, nor use the
// symmetry of Kinv: work for a later version.
#include "ldl.cuh"

namespace {

using namespace cvxldl;

constexpr int kTile = 16;

__global__ void __launch_bounds__(kThreads)
    ldl_inverse_kernel(const float* __restrict__ L,
                       const float* __restrict__ d,
                       const float* __restrict__ Linv, int N, int Np, int p,
                       float* __restrict__ Kinv) {
  extern __shared__ __align__(16) float R[];  // (Np, kTile)
  __shared__ float s_z[kMaxPanel * kTile];
  // grid (tiles, instances): the tiles of an instance are adjacent, so
  // they run together and share its L in L2
  const int j0 = blockIdx.x * kTile;
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* Lb = L + b * (size_t)Np * Np;
  const float* db = d + b * (size_t)Np;
  const float* Vb = Linv + b * (size_t)Np * p;

  for (int e = tid; e < Np * kTile; e += kThreads) {
    const int r = e / kTile, c = e - r * kTile;
    R[e] = (r == j0 + c) ? 1.0f : 0.0f;
  }
  const int nbp = Np / p;
  // forward: L Z = I.  Z_k = Linv_k R_k; R[below] -= L21 Z_k
  for (int k = 0; k < nbp; ++k) {
    const int o = k * p;
    __syncthreads();
    for (int e = tid; e < p * kTile; e += kThreads) {
      const int i = e / kTile, c = e - i * kTile;
      const float* v = Vb + (size_t)(o + i) * p;
      float acc = 0.0f;
      for (int j = 0; j < p; ++j) acc += v[j] * R[(o + j) * kTile + c];
      s_z[e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < p * kTile; e += kThreads)
      R[o * kTile + e] = s_z[e];
    for (int e = tid; e < (Np - o - p) * kTile; e += kThreads) {
      const int r = e / kTile, c = e - r * kTile;
      const float* l21 = Lb + (size_t)(o + p + r) * Np + o;
      float acc = 0.0f;
      for (int j = 0; j < p; ++j) acc += l21[j] * s_z[j * kTile + c];
      R[(o + p) * kTile + e] -= acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < Np * kTile; e += kThreads) R[e] /= db[e / kTile];
  // backward: L' X = W.  X_k = Linv_k' R_k; R[above] -= L[k rows, above]' X_k
  for (int k = nbp - 1; k >= 0; --k) {
    const int o = k * p;
    __syncthreads();
    for (int e = tid; e < p * kTile; e += kThreads) {
      const int i = e / kTile, c = e - i * kTile;
      float acc = 0.0f;
      for (int j = 0; j < p; ++j)
        acc += Vb[(size_t)(o + j) * p + i] * R[(o + j) * kTile + c];
      s_z[e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < p * kTile; e += kThreads)
      R[o * kTile + e] = s_z[e];
    for (int e = tid; e < o * kTile; e += kThreads) {
      const int r = e / kTile, c = e - r * kTile;
      float acc = 0.0f;
      for (int i = 0; i < p; ++i)
        acc += Lb[(size_t)(o + i) * Np + r] * s_z[i * kTile + c];
      R[e] -= acc;
    }
  }
  __syncthreads();
  float* Kb = Kinv + b * (size_t)N * N;
  for (int e = tid; e < N * kTile; e += kThreads) {
    const int r = e / kTile, c = e - r * kTile;
    if (j0 + c < N) Kb[(size_t)r * N + j0 + c] = R[e];
  }
}

}  // namespace

// Launches kernel K7 once on `stream`: L (B, Np, Np), d (B, Np), Linv
// (B, Np, p) -> Kinv (B, N, N), B <= 65535 (the grid.y limit; the wrapper
// slices larger batches).  Returns the CUDA error code (0 = success).
extern "C" int ldl_inverse_f32(const float* L, const float* d,
                               const float* Linv, int B, int N, int Np, int p,
                               float* Kinv, void* stream) {
  if (!dims_ok(B, N, Np, p) || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)Np * kTile;
  if (smem + 4 * kMaxPanel * kTile > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ldl_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, B);
  ldl_inverse_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      L, d, Linv, N, Np, p, Kinv);
  return (int)cudaGetLastError();
}
