// Kernel K11: check_interval fused banded ADMM iterations per instance on a
// shared block-banded KKT, on the rho-scaled state, with no checks.
//
// Replaces cvxpygen_tpu/ops/banded_shared_kernel.py::_banded_iterate_kernel
// (the Pallas TPU kernel; wrapper banded_iterate), the reference's large-nb
// iterate kernel, and computes the same function in the same layouts: x/q
// (nb, s, B), z/y/l/u (nb, r_max, B), the grouped A windows B0/B1
// (nb, r_max, s) and, scaled by rho, B0r/B1r, the packed CR factor, and the
// banded M (D_M, L_M) for refinement.  z, l and u are rho-scaled (rho z,
// rho l, rho u), so no rho multiply is left in the iteration:
//   rhs = sigma x - q + A'(z - y)        (grouped A': B1 shifted one block)
//   x~  = M^-1 rhs                       (the CR solve of csrc/cr.cuh; each
//         refinement sweep adds M^-1 (rhs - M x~))
//   w   = alpha (rho A) x~ + (1 - alpha) z + y
//   z = clip(w, l, u),  y = w - z,  x = alpha x~ + (1 - alpha) x.
// Its plain torch version is banded_iterate_plain in
// cvxpygen_tpu_torch/ops/banded_shared_kernel.py, which also builds and
// binds this file (nvcc for sm_90a, ctypes).
//
// What bounds it.  At charging T=1440 (nb=541, s=8, r_max=24, 2711 packed
// blocks; B=256, 50 iterations) an iteration needs per instance the A' and
// A products (nnz(A) multiply-adds each) and the CR solve (every packed
// block applied once, 2711 * 64 multiply-adds): about 0.41 MFLOP, 5.25
// GFLOP in all, 0.078 ms at the FP32 peak, against the state and shared
// inputs read once and written once (76 MB, 0.023 ms; chip_smoke.py::
// k11_bound).  So operations bound it on paper.  As in kernels K4 and K5,
// this design reads the shared factor and the A windows from L2 for every
// instance and iteration, in about 25 short passes separated by barriers,
// so the latency of those reads bounds it in practice.
//
// Design: one block of 256 threads per instance; threads over rows.  K5
// keeps the whole per-instance state in shared memory; at charging that is
// about 260 KB, more than a block's 227 KB.  So x, z, y and the CR buffers
// (right-hand side, solution, the stack of odd blocks) stay in shared
// memory (173 KB at charging; 208 KB with refinement, which also keeps the
// right-hand side and the refined solution), and q, l and u, read once per
// iteration, come from instance-major copies that the wrapper makes, so
// that each block reads contiguous memory; across B=256 those are 31 MB,
// which stay in the 50 MB L2 beside the 2.4 MB of factor and A windows.
// One block per SM: B=256 is two waves on the card's 132 SMs.  x, z, y are
// read once and written once per call, in place (each block touches only
// its own instance's column).  A 2-CTA cluster splitting an instance's
// blocks over distributed shared memory is the alternative; it is not
// built: at half the shared memory a CTA, two CTAs share an SM, so B=256
// still takes two waves, and every CR level would wait on a cluster
// barrier; what it could gain is twice the threads per instance.
#include <cuda_runtime.h>
#include <stddef.h>

#include "cr.cuh"

namespace {

using namespace cvxk;

constexpr size_t kSmemLimit = 232448;

struct Params {
  const float* fac;  // (NB_TOT, s, s) packed CR factor
  const float* B0;   // (nb, r_max, s) grouped A, block g
  const float* B1;   // (nb, r_max, s) grouped A, block g + 1
  const float* B0r;  // B0 scaled by rho row by row
  const float* B1r;  // B1 scaled by rho row by row
  const float* DM;   // (nb, s, s) diagonal blocks of M, or null
  const float* LM;   // (nb - 1, s, s) sub-diagonal blocks of M, or null
  const float* q;    // (B, nb, s) instance-major
  const float* l;    // (B, nb, r_max) instance-major, rho-scaled
  const float* u;    // (B, nb, r_max) instance-major, rho-scaled
  float* x;          // (nb, s, B) in/out
  float* z;          // (nb, r_max, B) in/out, rho-scaled
  float* y;          // (nb, r_max, B) in/out
  int B, nb, s, r, check_interval, kkt_refine;
  float sigma, alpha;
};

size_t iterate_smem_words(const CrMeta& cm, int r, int refine) {
  return (size_t)cm.nb * cm.s * (refine > 0 ? 3 : 1) +
         2 * (size_t)cm.nb * r + cr_smem_words(cm);
}

// (A' (z - y))_(g, i): B0 of group g plus B1 of group g - 1.
__device__ __forceinline__ float atv_zy(const Params& p, const float* Z,
                                        const float* Y, int g, int i) {
  const int s = p.s, R = p.r;
  const float* b0 = p.B0 + (size_t)g * R * s + i;
  const float* zg = Z + g * R;
  const float* yg = Y + g * R;
  float lo = 0.f;
#pragma unroll 8
  for (int r = 0; r < R; ++r) lo = fmaf(__ldg(b0 + r * s), zg[r] - yg[r], lo);
  float hi = 0.f;
  if (g > 0) {
    const float* b1 = p.B1 + (size_t)(g - 1) * R * s + i;
    const float* zh = zg - R;
    const float* yh = yg - R;
#pragma unroll 8
    for (int r = 0; r < R; ++r)
      hi = fmaf(__ldg(b1 + r * s), zh[r] - yh[r], hi);
  }
  return lo + hi;
}

// (rho A x)_(g, r): the row's scaled B0 window on block g and B1 window on
// block g + 1.
__device__ __forceinline__ float av_rho(const Params& p, const float* xv,
                                        int g, int r) {
  const int s = p.s;
  const size_t row = ((size_t)g * p.r + r) * s;
  float acc = dot_row(p.B0r + row, xv + g * s, s);
  if (g + 1 < p.nb) acc += dot_row(p.B1r + row, xv + (g + 1) * s, s);
  return acc;
}

// (M x)_(g, i) for the block-tridiagonal M: (D_g x_g + L_{g-1} x_{g-1})
// + L_g' x_{g+1}.
__device__ __forceinline__ float mmv(const Params& p, const float* xv, int g,
                                     int i) {
  const int s = p.s, ss = s * s;
  float acc = dot_row(p.DM + (size_t)g * ss + i * s, xv + g * s, s);
  if (g >= 1)
    acc += dot_row(p.LM + (size_t)(g - 1) * ss + i * s, xv + (g - 1) * s, s);
  if (g + 1 < p.nb) {
    const float* w = p.LM + (size_t)g * ss + i;
    const float* v = xv + (g + 1) * s;
    float up = 0.f;
#pragma unroll 8
    for (int j = 0; j < s; ++j) up = fmaf(__ldg(w + j * s), v[j], up);
    acc += up;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    iterate_kernel(const Params p, const CrMeta cm) {
  extern __shared__ __align__(16) float smem[];
  __shared__ CrLevel lv[kCrMaxLevels];
  const int nb = p.nb, s = p.s, R = p.r;
  const int nx = nb * s, nr = nb * R;
  const int nbp = (nb + (nb & 1)) * s;
  const bool refine = p.kkt_refine > 0;
  float* X = smem;
  float* Z = X + nx;
  float* Y = Z + nr;
  float* RHS = Y + nr;             // refinement only
  float* XT = RHS + (refine ? nx : 0);
  float* buf0 = XT + (refine ? nx : 0);
  float* buf1 = buf0 + nbp;
  float* stack = buf1 + nbp;
  cr_load_levels(cm, lv);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x, B = p.B;
  const float* qb = p.q + b * nx;
  const float* lb = p.l + b * nr;
  const float* ub = p.u + b * nr;
  for (int e = tid; e < nx; e += kThreads) X[e] = p.x[(size_t)e * B + b];
  for (int e = tid; e < nr; e += kThreads) {
    Z[e] = p.z[(size_t)e * B + b];
    Y[e] = p.y[(size_t)e * B + b];
  }
  const float sigma = p.sigma, alpha = p.alpha;
  __syncthreads();
  for (int it = 0; it < p.check_interval; ++it) {
    for (int o = tid; o < nx; o += kThreads) {
      const int g = o / s, i = o - g * s;
      const float v = (sigma * X[o] - qb[o]) + atv_zy(p, Z, Y, g, i);
      buf0[o] = v;
      if (refine) RHS[o] = v;
    }
    const float* xt = cr_solve_block(p.fac, lv, cm.n_levels, cm.root, s, buf0,
                                     buf1, stack);
    if (refine) {
      for (int o = tid; o < nx; o += kThreads) XT[o] = xt[o];
      for (int k = 0; k < p.kkt_refine; ++k) {
        __syncthreads();
        for (int o = tid; o < nx; o += kThreads) {
          const int g = o / s, i = o - g * s;
          buf0[o] = RHS[o] - mmv(p, XT, g, i);
        }
        const float* dx = cr_solve_block(p.fac, lv, cm.n_levels, cm.root, s,
                                         buf0, buf1, stack);
        for (int o = tid; o < nx; o += kThreads) XT[o] += dx[o];
      }
      __syncthreads();
      xt = XT;
    }
    for (int o = tid; o < nr; o += kThreads) {
      const int g = o / R;
      const float w = alpha * av_rho(p, xt, g, o - g * R) +
                      (1.f - alpha) * Z[o] + Y[o];
      const float z1 = fminf(fmaxf(w, lb[o]), ub[o]);
      Y[o] = w - z1;
      Z[o] = z1;
    }
    for (int o = tid; o < nx; o += kThreads)
      X[o] = alpha * xt[o] + (1.f - alpha) * X[o];
    __syncthreads();
  }
  for (int e = tid; e < nx; e += kThreads) p.x[(size_t)e * B + b] = X[e];
  for (int e = tid; e < nr; e += kThreads) {
    p.z[(size_t)e * B + b] = Z[e];
    p.y[(size_t)e * B + b] = Y[e];
  }
}

}  // namespace

// Launches kernel K11 on `stream`; `meta` is the host int array of
// cr_meta_array.  DM and LM may be null when kkt_refine is 0.  x, z, y are
// updated in place.  Returns the CUDA error code (0 = success).
extern "C" int banded_iterate_f32(
    const float* fac, const float* B0, const float* B1, const float* B0r,
    const float* B1r, const float* DM, const float* LM, const float* q,
    const float* l, const float* u, float* x, float* z, float* y,
    const int* meta, int B, int nb, int s, int r_max, int check_interval,
    int kkt_refine, float sigma, float alpha, void* stream) {
  CrMeta cm;
  if (B <= 0 || r_max <= 0 || check_interval < 0 || kkt_refine < 0 ||
      !cr_meta_from(meta, &cm) || cm.nb != nb || cm.s != s ||
      (kkt_refine > 0 && (!DM || (nb > 1 && !LM))))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * iterate_smem_words(cm, r_max, kkt_refine);
  if (smem > kSmemLimit - sizeof(CrLevel) * kCrMaxLevels)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p{fac, B0, B1, B0r, B1r, DM, LM, q,     l,     u,
           x,   z,  y,  B,   nb,  s,  r_max, check_interval, kkt_refine,
           sigma, alpha};
  iterate_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p, cm);
  return (int)cudaGetLastError();
}
