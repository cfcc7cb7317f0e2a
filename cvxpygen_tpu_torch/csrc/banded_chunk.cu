// Kernel K5: check_interval fused banded ADMM iterations per instance on a
// shared block-banded KKT, then the residuals and the OSQP section 3.4
// infeasibility certificates.
//
// Replaces cvxpygen_tpu/ops/banded_shared_kernel.py::_banded_shared_kernel
// (the Pallas TPU kernel; wrapper banded_shared_chunk) and computes the
// same function in the same layouts: x/q (nb, s, B), z/y/l/u
// (nb, r_max, B), the grouped A windows B0/B1 (nb, r_max, s), the packed CR
// factor, the banded P as (D_P, L_P), the shared scalings and rho.  Per
// iteration:
//   rhs = sigma x - q + A'(rho z - y)    (grouped A': B1 shifted one block)
//   x~  = M^-1 rhs                      (the CR solve of csrc/cr.cuh)
//   z~  = A x~                          (B0 on block g, B1 on block g + 1)
//   x = alpha x~ + (1 - alpha) x,  w = alpha z~ + (1 - alpha) z + y / rho,
//   z = clip(w, l, u),  y = rho (w - z).
// Then, once per call: done instances keep their state and get zero
// deltas; rp, rd, rp_den, rd_den with the block-tridiagonal P; the
// certificates on the deltas with the open-direction test for infinite
// bounds; flags 1 ok, 2 p_inf, 4 d_inf.  No refinement sweep: the solve loop
// passes kkt_refine = 0, and the CR solve is direct.  Its plain torch
// version is banded_shared_chunk_plain in
// cvxpygen_tpu_torch/ops/banded_shared_kernel.py, which also builds and
// binds this file (nvcc for sm_90a, ctypes).
//
// What bounds it.  At MPC H=30 (nb=41, s=16, r_max=24) an iteration is
// about 115k multiply-adds per instance (the grouped A' and A products,
// 2 * 2 * 41 * 24 * 16, and the CR solve, about 5 s^2 nb): at B=2048 and
// 15 iterations, 7 GFLOP, about 0.1 ms at the FP32 peak, against 17 MB of
// state in and out (5 us).  Operations bound it on paper.  This first design
// reads the shared factor (214 KB) and B0/B1 (126 KB) from L2 for every
// instance and iteration, in about 20 short passes per iteration separated
// by barriers (the CR levels' passes have few (block, row) pairs each), so
// the latency of those L2 reads bounds it in practice: row products load
// four floats at a time, and strided column products are unrolled so that
// their loads are in flight together.
//
// Design: one block of 256 threads per instance; threads over rows.  The
// instance's x, q, x0, z, y, l, u, y0, rho, rho z - y and the CR buffers
// live in shared memory (44 KB at MPC H=30: about five blocks per SM; B=2048
// is three waves on 132 SMs).  x, z, y are read once and written once per
// call, in place (the wrapper passes the same tensors in and out, as the
// reference aliases them); each block touches only its own instance's
// column, so in place is safe.  A done instance skips the iterations: its
// state and zero deltas are what the reference's masking gives.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "cr.cuh"

namespace {

using namespace cvxk;

constexpr size_t kSmemLimit = 232448;
constexpr float kInf = 1e30f;
constexpr float kEpsInf = 1e-4f;
// block maxima and sums of the residual and certificate pass
constexpr int kNumMax = 14;
constexpr int kNumSum = 2;

struct Params {
  const float* fac;   // (NB_TOT, s, s) packed CR factor
  const float* B0;    // (nb, r_max, s) grouped A, block g
  const float* B1;    // (nb, r_max, s) grouped A, block g + 1
  const float* DP;    // (nb, s, s) diagonal blocks of P
  const float* LP;    // (nb - 1, s, s) sub-diagonal blocks of P
  const float* D;     // (nb, s) variable scaling
  const float* Einv;  // (nb, r_max) 1 / row scaling, pads 0
  const float* E;     // (nb, r_max) row scaling, pads 0
  const float* rho;   // (nb, r_max) rho, pads 1
  const float* q;     // (nb, s, B)
  const float* l;     // (nb, r_max, B), pads -1e30
  const float* u;     // (nb, r_max, B), pads +1e30
  float* x;           // (nb, s, B) in/out
  float* z;           // (nb, r_max, B) in/out
  float* y;           // (nb, r_max, B) in/out
  const int* done;    // (B)
  float* rp;          // (B)
  float* rd;
  float* rpd;
  float* rdd;
  int* flags;         // (B)
  int B, nb, s, r, check_interval;
  float cinv, sigma, alpha, eps_abs, eps_rel;
};

size_t chunk_smem_words(const CrMeta& cm, int r) {
  return 3 * (size_t)cm.nb * cm.s + 7 * (size_t)cm.nb * r + cr_smem_words(cm);
}

// (A' v)_(g, i) in the grouped layout: B0 of group g plus B1 of group g-1.
__device__ __forceinline__ float atv(const Params& p, const float* v, int g,
                                     int i) {
  const int s = p.s, R = p.r;
  const float* b0 = p.B0 + (size_t)g * R * s + i;
  const float* vg = v + g * R;
  float lo = 0.f;
#pragma unroll 8
  for (int r = 0; r < R; ++r) lo = fmaf(__ldg(b0 + r * s), vg[r], lo);
  float hi = 0.f;
  if (g > 0) {
    const float* b1 = p.B1 + (size_t)(g - 1) * R * s + i;
    const float* vh = v - R + g * R;
#pragma unroll 8
    for (int r = 0; r < R; ++r) hi = fmaf(__ldg(b1 + r * s), vh[r], hi);
  }
  return lo + hi;
}

// (A x)_(g, r): the row's B0 window on block g and B1 window on block g+1.
__device__ __forceinline__ float av(const Params& p, const float* xv, int g,
                                    int r) {
  const int s = p.s;
  const size_t row = ((size_t)g * p.r + r) * s;
  float acc = dot_row(p.B0 + row, xv + g * s, s);
  if (g + 1 < p.nb) acc += dot_row(p.B1 + row, xv + (g + 1) * s, s);
  return acc;
}

// (P x)_(g, i) for the block-tridiagonal P: (D_g x_g + L_{g-1} x_{g-1})
// + L_g' x_{g+1}.
__device__ __forceinline__ float btmv(const Params& p, const float* xv,
                                      int g, int i) {
  const int s = p.s, ss = s * s;
  float acc = dot_row(p.DP + (size_t)g * ss + i * s, xv + g * s, s);
  if (g >= 1)
    acc += dot_row(p.LP + (size_t)(g - 1) * ss + i * s, xv + (g - 1) * s, s);
  if (g + 1 < p.nb) {
    const float* w = p.LP + (size_t)g * ss + i;
    const float* v = xv + (g + 1) * s;
    float up = 0.f;
#pragma unroll 8
    for (int j = 0; j < s; ++j) up = fmaf(__ldg(w + j * s), v[j], up);
    acc += up;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    chunk_kernel(const Params p, const CrMeta cm) {
  extern __shared__ __align__(16) float smem[];
  __shared__ CrLevel lv[kCrMaxLevels];
  __shared__ float red_max[kWarps][kNumMax];
  __shared__ float red_sum[kWarps][kNumSum];
  const int nb = p.nb, s = p.s, R = p.r;
  const int nx = nb * s, nr = nb * R;
  const int nbp = (nb + (nb & 1)) * s;
  float* X = smem;
  float* Q = X + nx;
  float* DX = Q + nx;   // x at entry, then the delta x
  float* Z = DX + nx;
  float* Y = Z + nr;
  float* Lo = Y + nr;
  float* Up = Lo + nr;
  float* DY = Up + nr;  // y at entry, then the delta y
  float* Rho = DY + nr;
  float* V = Rho + nr;
  float* buf0 = V + nr;
  float* buf1 = buf0 + nbp;
  float* stack = buf1 + nbp;
  cr_load_levels(cm, lv);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x, B = p.B;
  for (int e = tid; e < nx; e += kThreads) {
    X[e] = DX[e] = p.x[(size_t)e * B + b];
    Q[e] = p.q[(size_t)e * B + b];
  }
  for (int e = tid; e < nr; e += kThreads) {
    Z[e] = p.z[(size_t)e * B + b];
    Y[e] = DY[e] = p.y[(size_t)e * B + b];
    Lo[e] = p.l[(size_t)e * B + b];
    Up[e] = p.u[(size_t)e * B + b];
    Rho[e] = p.rho[e];
  }
  const bool done = p.done[b] > 0;
  const float sigma = p.sigma, alpha = p.alpha;
  __syncthreads();
  if (!done) {
    for (int it = 0; it < p.check_interval; ++it) {
      for (int e = tid; e < nr; e += kThreads) V[e] = Rho[e] * Z[e] - Y[e];
      __syncthreads();
      for (int o = tid; o < nx; o += kThreads) {
        const int g = o / s, i = o - g * s;
        buf0[o] = (sigma * X[o] - Q[o]) + atv(p, V, g, i);
      }
      const float* XT = cr_solve_block(p.fac, lv, cm.n_levels, cm.root, s,
                                       buf0, buf1, stack);
      for (int o = tid; o < nr; o += kThreads) {
        const int g = o / R;
        const float zt = av(p, XT, g, o - g * R);
        const float w = alpha * zt + (1.f - alpha) * Z[o] + Y[o] / Rho[o];
        const float z1 = fminf(fmaxf(w, Lo[o]), Up[o]);
        Y[o] = Rho[o] * (w - z1);
        Z[o] = z1;
      }
      for (int o = tid; o < nx; o += kThreads)
        X[o] = alpha * XT[o] + (1.f - alpha) * X[o];
      __syncthreads();
    }
  }
  for (int o = tid; o < nx; o += kThreads) DX[o] = done ? 0.f : X[o] - DX[o];
  for (int o = tid; o < nr; o += kThreads) DY[o] = done ? 0.f : Y[o] - DY[o];
  __syncthreads();

  // maxima: 0 rp, 1-2 rp_den terms, 3 |E dy|, 4 E_inv A dx on finite-u
  // rows, 5 -E_inv A dx on finite-l rows, 6 open direction, 7 rd, 8-10
  // rd_den terms, 11 |D_inv A' dy|, 12 |D dx|, 13 |D_inv P dx|;
  // sums: 0 the support-function term, 1 q'dx
  float mx[kNumMax], sm[kNumSum];
#pragma unroll
  for (int k = 0; k < kNumMax; ++k) mx[k] = 0.f;
  mx[4] = mx[5] = -INFINITY;
  sm[0] = sm[1] = 0.f;
  for (int o = tid; o < nr; o += kThreads) {
    const int g = o / R, r = o - g * R;
    const float ax = av(p, X, g, r), adx = av(p, DX, g, r);
    const float einv = p.Einv[o], e = p.E[o];
    mx[0] = fmaxf(mx[0], fabsf(einv * (ax - Z[o])));
    mx[1] = fmaxf(mx[1], fabsf(einv * ax));
    mx[2] = fmaxf(mx[2], fabsf(einv * Z[o]));
    const float dy = DY[o], edy = e * dy;
    mx[3] = fmaxf(mx[3], fabsf(edy));
    const bool u_open = Up[o] >= kInf * 0.5f, l_open = Lo[o] <= -kInf * 0.5f;
    const float u_fin = u_open ? 0.f : Up[o] * einv;
    const float l_fin = l_open ? 0.f : Lo[o] * einv;
    sm[0] += u_fin * fmaxf(edy, 0.f) + l_fin * fminf(edy, 0.f);
    if ((dy > 1e-12f && u_open) || (dy < -1e-12f && l_open)) mx[6] = 1.f;
    const float eadx = einv * adx;
    if (!u_open) mx[4] = fmaxf(mx[4], eadx);
    if (!l_open) mx[5] = fmaxf(mx[5], -eadx);
  }
  for (int o = tid; o < nx; o += kThreads) {
    const int g = o / s, i = o - g * s;
    const float px = btmv(p, X, g, i), pdx = btmv(p, DX, g, i);
    const float aty = atv(p, Y, g, i), atdy = atv(p, DY, g, i);
    const float d = p.D[o], dinv = 1.f / d;
    mx[7] = fmaxf(mx[7], fabsf(dinv * ((px + Q[o]) + aty)));
    mx[8] = fmaxf(mx[8], fabsf(dinv * px));
    mx[9] = fmaxf(mx[9], fabsf(dinv * aty));
    mx[10] = fmaxf(mx[10], fabsf(dinv * Q[o]));
    mx[11] = fmaxf(mx[11], fabsf(dinv * atdy));
    mx[12] = fmaxf(mx[12], fabsf(d * DX[o]));
    mx[13] = fmaxf(mx[13], fabsf(dinv * pdx));
    sm[1] += Q[o] * DX[o];
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int k = 0; k < kNumMax; ++k) mx[k] = warp_max(mx[k]);
#pragma unroll
  for (int k = 0; k < kNumSum; ++k) sm[k] = warp_sum(sm[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kNumMax; ++k) red_max[warp][k] = mx[k];
#pragma unroll
    for (int k = 0; k < kNumSum; ++k) red_sum[warp][k] = sm[k];
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      for (int k = 0; k < kNumMax; ++k)
        red_max[0][k] = fmaxf(red_max[0][k], red_max[w][k]);
      for (int k = 0; k < kNumSum; ++k) red_sum[0][k] += red_sum[w][k];
    }
    const float* M = red_max[0];
    const float cinv = p.cinv;
    const float rp = M[0], rp_den = fmaxf(M[1], M[2]);
    const float rd = cinv * M[7];
    const float rd_den = cinv * fmaxf(fmaxf(M[8], M[9]), M[10]);
    const bool ok = rp <= p.eps_abs + p.eps_rel * rp_den &&
                    rd <= p.eps_abs + p.eps_rel * rd_den;
    const float dy_n = M[3] * cinv;
    const bool cert_p1 = M[11] * cinv <= kEpsInf * dy_n;
    const float sup = red_sum[0][0] * cinv;
    const bool p_inf = dy_n > 1e-10f && cert_p1 && sup <= -kEpsInf * dy_n &&
                       !(M[6] > 0.f);
    const float dx_n = M[12];
    const bool cert_d1 = M[13] * cinv <= kEpsInf * dx_n;
    const bool cert_d2 = red_sum[0][1] * cinv <= -kEpsInf * dx_n;
    const bool rows_ok = M[4] <= kEpsInf * dx_n && M[5] <= kEpsInf * dx_n;
    const bool d_inf = dx_n > 1e-10f && cert_d1 && cert_d2 && rows_ok;
    p.rp[b] = rp;
    p.rd[b] = rd;
    p.rpd[b] = rp_den;
    p.rdd[b] = rd_den;
    p.flags[b] = (ok ? 1 : 0) + (p_inf ? 2 : 0) + (d_inf ? 4 : 0);
  }
  for (int e = tid; e < nx; e += kThreads) p.x[(size_t)e * B + b] = X[e];
  for (int e = tid; e < nr; e += kThreads) {
    p.z[(size_t)e * B + b] = Z[e];
    p.y[(size_t)e * B + b] = Y[e];
  }
}

}  // namespace

// Launches kernel K5 on `stream`; `meta` is the host int array of
// cr_meta_array.  x, z, y are updated in place.  Returns the CUDA error code
// (0 = success).
extern "C" int banded_chunk_f32(
    const float* fac, const float* B0, const float* B1, const float* DP,
    const float* LP, const float* D, const float* Einv, const float* E,
    const float* rho, const float* q, const float* l, const float* u,
    float* x, float* z, float* y, const int* done, float* rp, float* rd,
    float* rpd, float* rdd, int* flags, const int* meta, int B, int nb, int s,
    int r_max, int check_interval, float cinv, float sigma, float alpha,
    float eps_abs, float eps_rel, void* stream) {
  CrMeta cm;
  if (B <= 0 || r_max <= 0 || check_interval < 0 || !cr_meta_from(meta, &cm) ||
      cm.nb != nb || cm.s != s)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * chunk_smem_words(cm, r_max);
  if (smem > kSmemLimit - sizeof(CrLevel) * kCrMaxLevels -
                 4 * kWarps * (kNumMax + kNumSum))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p{fac, B0,   B1, DP,    LP,         D,    Einv,    E,
           rho, q,    l,  u,     x,          z,    y,       done,
           rp,  rd,   rpd, rdd,  flags,      B,    nb,      s,
           r_max, check_interval, cinv, sigma, alpha, eps_abs, eps_rel};
  chunk_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p, cm);
  return (int)cudaGetLastError();
}
