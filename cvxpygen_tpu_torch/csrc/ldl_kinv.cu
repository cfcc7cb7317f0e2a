// Kernel K10: the explicit inverse of the pivot-regularized quasidefinite
// KKT matrix, factor and inverse in one launch, batch-major.
//
// Replaces cvxpygen_tpu/ops/ldl_kernel.py::_factor_inverse_bm_kernel
// (wrapper ldl_kinv_pallas), the Pallas TPU kernel that the conic IPM's
// 'ldl' KKT mode runs once per iteration under CPG_LDL_BM_FUSED=1, and
// computes the same function: K (B, N, N) -> Kinv (B, N, N) of the
// pivot-regularized K, padded internally to Np = nbp * p with an identity
// tail.  Its plain torch version is ldl_kinv_plain in
// cvxpygen_tpu_torch/ops/ldl_kernel.py, which also builds and binds this
// file (nvcc for sm_90a, ctypes).
//
// What bounds it.  At the entropy family's shape (N = 161, Np = 176,
// B = 1024, float32) the function must read K's lower triangle (53 MB) and
// write Kinv (106 MB): 0.048 ms at 3.35 TB/s.  It needs N^3 FLOP per
// instance (N^3 / 3 for the factor, 2 N^3 / 3 for the inverse; 4.3 GFLOP
// in all, 0.064 ms at the FP32 peak).  So operations bound it, narrowly.
//
// Design (a first version that is right before it is fast): one block of
// 256 threads per instance.  The factor is kernel K6's, shared through
// csrc/ldl.cuh::ldl_factor_block: the working matrix stays resident in
// shared memory (124 KB at Np = 176), or in a device scratch the wrapper
// allocates when it does not fit beside the inverse's buffers.  The panel
// inverses and pivots stay in shared memory, and L21 stays transposed in
// the working matrix's upper triangle, so nothing of the factor goes
// through device memory: that is what fusing saves over K6 + K7 (about
// 0.1 ms of bytes at B = 1024).  The inverse is then built in strips of W
// columns with kernel K7's forward, diagonal and backward panel sweeps on
// the identity, each strip in shared memory beside the factor and written
// to Kinv when done.  The whole Np x Np inverse does not fit beside L, so
// W is what fits (at most 128 columns; 120 at Np = 176), evened out over
// the strips: two of 81 columns at N = 161.  The forward sweep of a strip
// starts at the panel of its first column (the rows above it are zero).
// K6's barriers per panel step stay.
#include "ldl.cuh"

namespace {

using namespace cvxldl;

constexpr int kMaxStrip = 128;

// K10 keeps each panel's inverse and pivots in shared memory; L21 needs no
// copy, ldl_factor_block leaves it transposed in the working matrix.
struct SharedOut {
  float* V;   // (Np, p) panel inverses
  float* dd;  // (Np) pivots
  int p;
  __device__ void panel(int o, const PanelBufs& pb) {
    for (int e = threadIdx.x; e < p * p; e += kThreads)
      V[(size_t)o * p + e] = pb.linv[e];
    if (threadIdx.x < p) dd[o + threadIdx.x] = pb.d[threadIdx.x];
  }
  __device__ void l21(int, int, float) {}
};

__global__ void __launch_bounds__(kThreads)
    ldl_kinv_kernel(const float* __restrict__ K, int N, int Np, int p,
                    const float* __restrict__ signs, float delta, int W,
                    float* __restrict__ Kinv, float* scratch) {
  extern __shared__ __align__(16) float smem[];
  __shared__ PanelBufs pb;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  float* A = scratch ? scratch + b * (size_t)Np * Np : smem;
  float* V = scratch ? smem : smem + (size_t)Np * Np;
  float* dd = V + Np * p;
  float* R = dd + Np;      // (Np, W): the strip
  float* Z = R + Np * W;   // (p, W): one panel's rows of it
  load_lower_padded(A, K + b * (size_t)N * N, N, Np);
  SharedOut out{V, dd, p};
  ldl_factor_block(A, Np, p, signs, delta, pb, out);

  const int nbp = Np / p;
  float* Kb = Kinv + b * (size_t)N * N;
  for (int j0 = 0; j0 < N; j0 += W) {
    const int w = min(W, N - j0);
    for (int e = tid; e < Np * W; e += kThreads) {
      const int r = e / W, c = e - r * W;
      R[e] = (c < w && r == j0 + c) ? 1.0f : 0.0f;
    }
    // forward: L Z = I.  Z_k = Linv_k R_k; R[below] -= L21 Z_k, with
    // L[o + p + r][o + j] = A[(o + j) * Np + o + p + r]
    for (int k = j0 / p; k < nbp; ++k) {
      const int o = k * p;
      __syncthreads();
      for (int e = tid; e < p * W; e += kThreads) {
        const int i = e / W, c = e - i * W;
        const float* v = V + (size_t)(o + i) * p;
        float acc = 0.0f;
        for (int j = 0; j < p; ++j) acc += v[j] * R[(o + j) * W + c];
        Z[e] = acc;
      }
      __syncthreads();
      for (int e = tid; e < p * W; e += kThreads) R[o * W + e] = Z[e];
      const float* lt = A + (size_t)o * Np + o + p;
      for (int e = tid; e < (Np - o - p) * W; e += kThreads) {
        const int r = e / W, c = e - r * W;
        float acc = 0.0f;
        for (int j = 0; j < p; ++j)
          acc += lt[(size_t)j * Np + r] * Z[j * W + c];
        R[(o + p) * W + e] -= acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < Np * W; e += kThreads) R[e] /= dd[e / W];
    // backward: L' X = W.  X_k = Linv_k' R_k; R[above] -= L[k rows, above]'
    // X_k, with L[o + i][r] = A[r * Np + o + i] for r < o
    for (int k = nbp - 1; k >= 0; --k) {
      const int o = k * p;
      __syncthreads();
      for (int e = tid; e < p * W; e += kThreads) {
        const int i = e / W, c = e - i * W;
        float acc = 0.0f;
        for (int j = 0; j < p; ++j)
          acc += V[(size_t)(o + j) * p + i] * R[(o + j) * W + c];
        Z[e] = acc;
      }
      __syncthreads();
      for (int e = tid; e < p * W; e += kThreads) R[o * W + e] = Z[e];
      for (int e = tid; e < o * W; e += kThreads) {
        const int r = e / W, c = e - r * W;
        const float* lr = A + (size_t)r * Np + o;
        float acc = 0.0f;
        for (int i = 0; i < p; ++i) acc += lr[i] * Z[i * W + c];
        R[e] -= acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < N * W; e += kThreads) {
      const int r = e / W, c = e - r * W;
      if (c < w) Kb[(size_t)r * N + j0 + c] = R[e];
    }
    __syncthreads();
  }
}

// The strip width for a working matrix kept in shared memory (`resident`)
// or in a device scratch: at most kMaxStrip and what fits beside the panel
// inverses and pivots, then evened out over the strips that N needs; 0 when
// fewer than 8 columns fit.
int strip_width(int N, int Np, int p, bool resident) {
  const long long words = (long long)(kSmemLimit - sizeof(PanelBufs)) / 4 -
                          (resident ? (long long)Np * Np : 0) -
                          (long long)Np * p - Np;
  long long W = words / (Np + p);
  if (W > kMaxStrip) W = kMaxStrip;
  if (W < 8) return 0;
  const long long strips = (N + W - 1) / W;
  return (int)((N + strips - 1) / strips);
}

size_t smem_bytes(int Np, int p, int W, bool resident) {
  return 4 * ((resident ? (size_t)Np * Np : 0) + (size_t)Np * p + Np +
              (size_t)(Np + p) * W);
}

}  // namespace

// 1 when the working matrix of an Np x Np factor fits in shared memory
// beside the inverse's buffers; 0 when the caller must pass a device
// scratch of B * Np * Np floats.
extern "C" int ldl_kinv_resident(int N, int Np, int p) {
  return strip_width(N, Np, p, true) > 0 ? 1 : 0;
}

// Launches kernel K10 on `stream`.  K (B, N, N); signs (Np,) +-1; Kinv
// (B, N, N) out; `scratch` is null (the working matrix in shared memory) or
// B * Np * Np floats.  Returns the CUDA error code (0 = success).
extern "C" int ldl_kinv_f32(const float* K, int B, int N, int Np, int p,
                            const float* signs, float delta, float* Kinv,
                            float* scratch, void* stream) {
  if (!dims_ok(B, N, Np, p)) return (int)cudaErrorInvalidValue;
  const bool resident = scratch == nullptr;
  const int W = strip_width(N, Np, p, resident);
  if (W == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Np, p, W, resident);
  cudaError_t err = cudaFuncSetAttribute(
      ldl_kinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ldl_kinv_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      K, N, Np, p, signs, delta, W, Kinv, scratch);
  return (int)cudaGetLastError();
}
