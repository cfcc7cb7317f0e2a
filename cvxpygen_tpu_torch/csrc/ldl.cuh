// Shared pieces of kernels K6 (csrc/ldl_factor.cu), K7 (csrc/ldl_inverse.cu),
// K8 (csrc/ldl_solve.cu) and K10 (csrc/ldl_kinv.cu): the static-pivot
// blocked LDL^T of a batch of quasidefinite KKT matrices and its uses.
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

// One panel's results, in static shared memory: its pivots d, L11 (unit
// lower), its inverse Linv and Minv = (D1 L11')^-1.
struct PanelBufs {
  float d[kMaxPanel];
  float l11[kMaxPanel * kMaxPanel];
  float linv[kMaxPanel * kMaxPanel];
  float minv[kMaxPanel * kMaxPanel];
};

// The lower triangle of one instance's K (N x N, row-major) padded with an
// identity tail into the Np x Np working matrix A.  The caller synchronizes.
__device__ __forceinline__ void load_lower_padded(float* A,
                                                  const float* __restrict__ Kb,
                                                  int N, int Np) {
  for (int e = threadIdx.x; e < Np * Np; e += kThreads) {
    const int r = e / Np, c = e - r * Np;
    if (c > r) continue;
    A[e] = (r < N) ? Kb[(size_t)r * N + c] : (r == c ? 1.0f : 0.0f);
  }
}

// The blocked LDL^T of kernel K6 (cvxpygen_tpu/ops/ldl_kernel.py::
// _factor_kernel with its _panel_ldl), by all threads of a block, on the
// working matrix A (Np x Np, row stride Np) of one instance.  Only A's lower
// triangle is read -- the panel steps, the panel's column block and the
// trailing update all stay on or below the diagonal -- so the trailing update
// touches the lower triangle only, and each panel's L21 is kept transposed
// in the dead upper block beside the panel (A[col * Np + row] = L[row][col]),
// where the trailing update reads it without bank conflicts and where it
// stays for the caller after the factorization.  Pivots are clamped to
// s_j * max(s_j * a_jj, delta).
//
// `out` takes the results as they come:
//   out.panel(o, pb)     after panel o's d, l11, linv and minv are in `pb`
//                        (called by every thread; it loops over the entries
//                        itself and must not synchronize);
//   out.l21(row, col, v) one entry L[row][col] = v of the panel's L21.
template <class Out>
__device__ void ldl_factor_block(float* A, int Np, int p,
                                 const float* __restrict__ signs, float delta,
                                 PanelBufs& pb, Out& out) {
  const int tid = threadIdx.x;
  const int nbp = Np / p;
  for (int k = 0; k < nbp; ++k) {
    const int o = k * p;
    const int rest = Np - o - p;
    // 1. unblocked LDL of the diagonal block, in place: step j reads
    // column j and writes only columns > j
    for (int j = 0; j < p; ++j) {
      __syncthreads();
      const float sj = signs[o + j];
      const float v = sj * A[(size_t)(o + j) * Np + o + j];
      const float dj = sj * ((v < delta) ? delta : v);  // NaN stays NaN
      if (tid == 0) pb.d[j] = dj;
      for (int e = tid; e < p * p; e += kThreads) {
        const int r = e / p, c = e - r * p;
        if (c > j && c <= r) {
          const float cr = A[(size_t)(o + r) * Np + o + j] / dj;
          const float cc = A[(size_t)(o + c) * Np + o + j] / dj;
          A[(size_t)(o + r) * Np + o + c] -= dj * cr * cc;
        }
      }
    }
    __syncthreads();
    // 2. L11 (column j of the block divided by its pivot) ...
    for (int e = tid; e < p * p; e += kThreads) {
      const int r = e / p, c = e - r * p;
      pb.l11[e] = (r == c) ? 1.0f
                  : (r > c) ? A[(size_t)(o + r) * Np + o + c] / pb.d[c]
                            : 0.0f;
    }
    __syncthreads();
    // ... and its inverse by forward substitution, one column per thread:
    // X[i][c] = e_i[c] - sum_{j<i} L11[i][j] X[j][c]
    if (tid < p) {
      const int c = tid;
      for (int i = 0; i < p; ++i) {
        float acc = (i == c) ? 1.0f : 0.0f;
        for (int j = 0; j < i; ++j)
          acc -= pb.l11[i * p + j] * pb.linv[j * p + c];
        pb.linv[i * p + c] = acc;
      }
    }
    __syncthreads();
    // 3. Minv = (D1 L11')^{-1}, Minv[j][c] = Linv[c][j] / d[c]; the
    // panel's outputs
    for (int e = tid; e < p * p; e += kThreads) {
      const int r = e / p, c = e - r * p;
      pb.minv[e] = pb.linv[c * p + r] / pb.d[c];
    }
    out.panel(o, pb);
    __syncthreads();
    if (rest == 0) break;
    // 4. L21 = A21 Minv, to `out` and, transposed, to the dead upper block
    // A[o + c][o + p + r]
    for (int e = tid; e < rest * p; e += kThreads) {
      const int r = e / p, c = e - r * p;
      const float* a21 = A + (size_t)(o + p + r) * Np + o;
      float acc = 0.0f;
      for (int j = 0; j < p; ++j) acc += a21[j] * pb.minv[j * p + c];
      out.l21(o + p + r, o + c, acc);
      A[(size_t)(o + c) * Np + o + p + r] = acc;
    }
    __syncthreads();
    // 5. trailing update of the lower triangle: A22 -= (L21 D1) L21'
    for (int e = tid; e < rest * rest; e += kThreads) {
      const int r = e / rest, c = e - r * rest;
      if (c > r) continue;
      const float* lt = A + (size_t)o * Np + o + p;  // lt[j * Np + i] = L21[i][j]
      float acc = 0.0f;
      for (int j = 0; j < p; ++j)
        acc += (lt[(size_t)j * Np + r] * pb.d[j]) * lt[(size_t)j * Np + c];
      A[(size_t)(o + p + r) * Np + o + p + c] -= acc;
    }
  }
  __syncthreads();
}

}  // namespace cvxldl
