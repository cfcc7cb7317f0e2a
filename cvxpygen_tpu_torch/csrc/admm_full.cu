// Kernel K2: the whole per-instance ADMM solve for a batch of QPs whose P
// and A differ from instance to instance, one thread-block cluster per
// block of `blk` instances.
//
// Replaces cvxpygen_tpu/ops/admm_full_kernel.py::_full_solve_kernel (the
// Pallas TPU kernel) and computes the same function on the same scaled data
// (solvers/admm.py prepares it): per block, M = P + sigma I + A' diag(rho) A
// for each instance; a cold Newton-Schulz inverse from the diagonal start
// with the residual-certificate rescue; check_interval ADMM iterations with
// kkt_refine refinement sweeps against M; the residuals and the OSQP
// section 3.4 infeasibility certificates; per-instance adaptive rho, where a
// change of any instance re-forms M for the whole block and warm-restarts
// Newton-Schulz; a block exit once its instances are done; the objective.
// Its plain torch version is admm_solve_full_plain in
// cvxpygen_tpu_torch/ops/admm_full_kernel.py, which also builds and binds
// this file (nvcc for sm_90a, ctypes).
//
// What bounds it.  The cold factor: n^2 m multiply-adds to form M and
// 2 n^3 per Newton-Schulz sweep (16 sweeps by default), about 0.75 GFLOP
// per instance at the MPC shape n=222, m=252, on the SIMT float32 units:
// operations-bound.  Each iteration then does 2 m n + (1 + 2 kkt_refine) n^2
// multiply-adds on matrices read from global memory.
//
// Design (a first version that is right before it is fast):
//  - the TPU kernel's block of `blk` instances (pick_full_block: 8 at the
//    MPC shape, 16 at the portfolio shape) is part of the answer, because
//    the rescue and the refactorization act on the whole block.  It maps to
//    a thread-block cluster of min(blk, 16) thread blocks of 256 threads,
//    each holding blk / 16 instances or one (16 is Hopper's largest
//    cluster); the block's decisions (exit, refactor, rescue) are ORs over
//    the cluster through distributed shared memory, so every instance has
//    an SM of its own.  Instances of one thread block take their turn for
//    every matrix product, because their matrices differ;
//  - the thread block's instances' x, z, y, q, l, u, D, E and rho0 live in
//    shared memory, with one set of temporaries for the instance whose turn
//    it is;
//  - M and two M^-1 buffers plus a Newton-Schulz temporary live in global
//    scratch (4 n^2 floats per instance, allocated by the wrapper): P, A,
//    M and M^-1 come to 0.8 MB per instance at the MPC shape, far more
//    than a block's 227 KB of shared memory;
//  - matrix products: the 128x128-tiled SIMT GEMM of gemm.cuh for M and
//    Newton-Schulz, the row GEMM for the iteration's matrix-vector products;
//  - control flow is uniform over the cluster: each decision is made by
//    one thread per thread block from the same cluster-wide OR and read by
//    all its threads;
//  - full float32 FMA, no TF32, no fast math.  The TPU kernel's cold start
//    runs its first ns_iters - ns_f32_iters sweeps in a bf16 pass; here
//    every sweep is full float32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm.cuh"

namespace {

using namespace cvxk;

constexpr float kInf = 1e30f;
constexpr float kEpsInf = 1e-4f;
constexpr float kRescueGate = 0.05f;
constexpr size_t kSmemLimit = 232448;
constexpr int kScalars = 9;  // per-instance scalar words
constexpr int kClusterMax = 16;  // Hopper's largest (non-portable) cluster

struct Params {
  const float* Ps;    // (B, n, n) scaled P
  const float* As;    // (B, m, n) scaled A
  const float* At;    // (B, n, m) its transpose
  const float* q;     // (B, n)
  const float* l;     // (B, m)
  const float* u;     // (B, m)
  const float* rho0;  // (B, m)
  const float* D;     // (B, n)
  const float* E;     // (B, m)
  const float* cinv;  // (B,)
  const float* x0;    // (B, n)
  const float* z0;    // (B, m)
  const float* y0;    // (B, m)
  float* ox;          // (B, n)
  float* oz;          // (B, m)
  float* oy;          // (B, m)
  float* oobj;        // (B,)
  int* oit;           // (B,)
  int* ost;           // (B,)
  float* orp;         // (B,)
  float* ord;         // (B,)
  float* scratch;     // (B, 4, n, n): M, two M^-1 buffers, a temporary
  int n, m, per;  // per: instances of one thread block
  float sigma, alpha, eps_abs, eps_rel, rho_tol;
  int check_interval, max_iter, ns_iters, ns_f32_iters, ns_adapt_iters,
      adaptive, kkt_refine, adapt_until;
};

// 4-byte words of dynamic shared memory for a thread block of `per`
// instances (full_smem_bytes in the Python wrapper mirrors this formula).
size_t smem_words(int per, int n, int m) {
  return (size_t)kTileWords + (size_t)per * (3 * n + 6 * m + kScalars) +
         7 * n + 7 * m + kThreads;
}

// max that keeps a NaN (jnp.max propagates it; fmaxf would drop it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (b != b || b > a) ? b : a;
}

// max of v over the block, returned to every thread; ends with a barrier
__device__ float block_max(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] = nanmax(red[tid], red[tid + o]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// OR of v over the thread blocks of the cluster, returned to every thread.
// `slot` and `res` are __shared__ words; the second barrier keeps a later
// call from overwriting `slot` before every block has read it.
__device__ int cluster_or(int v, int* slot, int* res) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cl.sync();
  if (threadIdx.x == 0) {
    int r = 0;
    for (unsigned k = 0; k < cl.num_blocks(); ++k)
      r |= *cl.map_shared_rank(slot, k);
    *res = r;
  }
  cl.sync();
  return *res;
}

struct Inst {
  float* M;
  float* X[2];
  float* T;
};

__global__ void __launch_bounds__(kThreads) full_solve_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m, per = p.per;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t b0 = (size_t)blockIdx.x * per;
  const size_t nn = (size_t)n * n;

  // the tile buffers first: float4 reads need 16-byte alignment
  float* sA = smem;
  float* sB = sA + kTileK * kTileLd;
  // state of this thread block's `per` instances, one copy each
  float* Xs = sB + kTileK * kTile;  // per x n
  float* Qs = Xs + per * n;         // per x n
  float* Ds = Qs + per * n;         // per x n
  float* Zs = Ds + per * n;         // per x m
  float* Ys = Zs + per * m;         // per x m
  float* Ls = Ys + per * m;         // per x m
  float* Us = Ls + per * m;         // per x m
  float* R0 = Us + per * m;         // per x m: rho0
  float* Es = R0 + per * m;         // per x m
  float* s_scale = Es + per * m;    // per
  float* s_rp = s_scale + per;      // per
  float* s_rd = s_rp + per;         // per
  int* s_done = (int*)(s_rd + per);   // per
  int* s_status = s_done + per;       // per
  int* s_itvec = s_status + per;      // per
  int* s_change = s_itvec + per;      // per
  int* s_bad = s_change + per;        // per
  int* s_sel = s_bad + per;           // per: which M^-1 buffer is current
  // temporaries of the instance whose turn it is
  float* XX = (float*)(s_sel + per);  // 2n: iterate x; then [x; dx]
  float* TN1 = XX + 2 * n;            // 2n: rhs, r; then [Px; Pdx]
  float* TN2 = TN1 + 2 * n;           // 2n: x~; then [A'y; A'dy]
  float* Dinv = TN2 + 2 * n;          // n
  float* YY = Dinv + n;               // 2m: iterate y; then [y; dy]
  float* Zi = YY + 2 * m;             // m: iterate z
  float* TM = Zi + m;                 // 2m: v, z~; then [Ax; Adx]
  float* Rho = TM + 2 * m;            // m
  float* Einv = Rho + m;              // m
  float* red = Einv + m;              // kThreads
  __shared__ int s_slot, s_res;  // cluster_or

  auto inst = [&](int r) {
    float* base = p.scratch + (b0 + r) * 4 * nn;
    return Inst{base, {base + nn, base + 2 * nn}, base + 3 * nn};
  };
  const float sigma = p.sigma, alpha = p.alpha;

  for (int e = tid; e < per * n; e += kThreads) {
    Xs[e] = p.x0[b0 * n + e];
    Qs[e] = p.q[b0 * n + e];
    Ds[e] = p.D[b0 * n + e];
  }
  for (int e = tid; e < per * m; e += kThreads) {
    Zs[e] = p.z0[b0 * m + e];
    Ys[e] = p.y0[b0 * m + e];
    Ls[e] = p.l[b0 * m + e];
    Us[e] = p.u[b0 * m + e];
    R0[e] = p.rho0[b0 * m + e];
    Es[e] = p.E[b0 * m + e];
  }
  for (int r = tid; r < per; r += kThreads) {
    s_scale[r] = 1.0f;
    s_rp[r] = kInf;
    s_rd[r] = kInf;
    s_done[r] = 0;
    s_status[r] = 0;
    s_itvec[r] = 0;
    s_sel[r] = 0;
  }
  __syncthreads();

  // ---- factorization helpers (every thread calls them) ----
  // M = P + sigma I + A' diag(rho0 * scale) A for instance r
  auto form_M = [&](int r) {
    const float sc = s_scale[r];
    for (int i = tid; i < m; i += kThreads) Rho[i] = R0[r * m + i] * sc;
    __syncthreads();
    const Inst I = inst(r);
    const float* P = p.Ps + (b0 + r) * nn;
    tile_gemm(p.At + (b0 + r) * (size_t)n * m, m, Rho,
              p.As + (b0 + r) * (size_t)m * n, n, n, n, m, sA, sB,
              [&](int i, int j, float acc) {
                I.M[(size_t)i * n + j] =
                    (P[(size_t)i * n + j] + (i == j ? sigma : 0.f)) + acc;
              });
  };
  // X0 = diag(M)^-1 / max(max_i sum_j |M_ij / M_jj|, 1) into buffer `sel`
  auto diag_start = [&](int r, int sel) {
    const Inst I = inst(r);
    for (int j = tid; j < n; j += kThreads)
      TN1[j] = 1.0f / fmaxf(I.M[(size_t)j * n + j], 1e-12f);
    __syncthreads();
    float rmax = 0.f;
    for (int i = warp; i < n; i += kWarps) {
      float s = 0.f;
      for (int j = lane; j < n; j += 32) s += fabsf(I.M[(size_t)i * n + j] * TN1[j]);
      rmax = nanmax(rmax, warp_sum(s));
    }
    const float den = fmaxf(block_max(rmax, red), 1.0f);
    float* X = I.X[sel];
    for (size_t e = tid; e < nn; e += kThreads) {
      const int i = (int)(e / n), j = (int)(e % n);
      X[e] = (i == j) ? TN1[j] / den : 0.f;
    }
    __syncthreads();
  };
  // `iters` Newton-Schulz sweeps X <- X (2I - M X) on instance r
  auto sweeps = [&](int r, int iters) {
    const Inst I = inst(r);
    for (int s = 0; s < iters; ++s) {
      const float* X = I.X[s_sel[r]];
      float* Xn = I.X[1 - s_sel[r]];
      tile_gemm(I.M, n, nullptr, X, n, n, n, n, sA, sB,
                [&](int i, int j, float acc) {
                  I.T[(size_t)i * n + j] = (i == j ? 2.f : 0.f) - acc;
                });
      tile_gemm(X, n, nullptr, I.T, n, n, n, n, sA, sB,
                [&](int i, int j, float acc) { Xn[(size_t)i * n + j] = acc; });
      if (tid == 0) s_sel[r] = 1 - s_sel[r];
      __syncthreads();
    }
  };
  // ||I - M X||_inf (entrywise) of instance r, NaN kept
  auto cert = [&](int r) {
    const Inst I = inst(r);
    float emax = 0.f;
    tile_gemm(I.M, n, nullptr, I.X[s_sel[r]], n, n, n, n, sA, sB,
              [&](int i, int j, float acc) {
                emax = nanmax(emax, fabsf((i == j ? 1.f : 0.f) - acc));
              });
    return block_max(emax, red);
  };
  // the block's certificate rescue (an OR over the cluster): where any
  // instance fails the 0.05 gate, the failing ones restart from the
  // diagonal start and every instance of the block runs max(ns_iters, 30)
  // more sweeps
  auto rescue = [&]() {
    for (int r = 0; r < per; ++r) {
      const float err = cert(r);
      if (tid == 0) s_bad[r] = !(err < kRescueGate);
    }
    int any = 0;
    if (tid == 0)
      for (int r = 0; r < per; ++r) any |= s_bad[r];
    if (!cluster_or(any, &s_slot, &s_res)) return;
    for (int r = 0; r < per; ++r)
      if (s_bad[r]) diag_start(r, s_sel[r]);
    const int iters = p.ns_iters > 30 ? p.ns_iters : 30;
    for (int r = 0; r < per; ++r) sweeps(r, iters);
  };

  // ---- cold factorization ----
  for (int r = 0; r < per; ++r) {
    form_M(r);
    diag_start(r, 0);
    sweeps(r, p.ns_iters);
  }
  if (p.ns_iters > p.ns_f32_iters) rescue();

  int it = 0;
  bool go = p.max_iter > 0;
  while (go) {
    const int it_new = it + p.check_interval;
    for (int r = 0; r < per; ++r) {
      const Inst I = inst(r);
      const float* Ar = p.As + (b0 + r) * (size_t)m * n;
      const float* Atr = p.At + (b0 + r) * (size_t)n * m;
      const float* Pr = p.Ps + (b0 + r) * nn;
      const float* Minv = I.X[s_sel[r]];
      float* Xr = Xs + r * n;
      float* Qr = Qs + r * n;
      float* Dr = Ds + r * n;
      float* Zr = Zs + r * m;
      float* Yr = Ys + r * m;
      float* Lr = Ls + r * m;
      float* Ur = Us + r * m;
      float* Er = Es + r * m;
      const float sc = s_scale[r];
      const float cinv = p.cinv[b0 + r];
      for (int i = tid; i < m; i += kThreads) {
        Rho[i] = R0[r * m + i] * sc;
        Einv[i] = 1.0f / Er[i];
        Zi[i] = Zr[i];
        YY[i] = Yr[i];
      }
      for (int j = tid; j < n; j += kThreads) {
        Dinv[j] = 1.0f / Dr[j];
        XX[j] = Xr[j];
      }
      __syncthreads();

      // ---- check_interval iterations ----
      float* Rhs = TN1;
      float* Res = TN1 + n;
      float* Xt = TN2;
      float* V = TM;
      float* Zt = TM + m;
      for (int t = 0; t < p.check_interval; ++t) {
        for (int i = tid; i < m; i += kThreads) V[i] = Rho[i] * Zi[i] - YY[i];
        __syncthreads();
        rowgemm<1, true>(V, m, Ar, n, [&](int, int j, float acc) {
          Rhs[j] = (sigma * XX[j] - Qr[j]) + acc;
        });
        __syncthreads();
        rowgemm<1, false>(Rhs, n, Minv, n,
                          [&](int, int j, float acc) { Xt[j] = acc; });
        __syncthreads();
        for (int s = 0; s < p.kkt_refine; ++s) {
          rowgemm<1, false>(Xt, n, I.M, n, [&](int, int j, float acc) {
            Res[j] = Rhs[j] - acc;
          });
          __syncthreads();
          rowgemm<1, false>(Res, n, Minv, n, [&](int, int j, float acc) {
            Xt[j] = Xt[j] + acc;
          });
          __syncthreads();
        }
        rowgemm<1, true>(Xt, n, Atr, m,
                         [&](int, int i, float acc) { Zt[i] = acc; });
        __syncthreads();
        for (int j = tid; j < n; j += kThreads)
          XX[j] = alpha * Xt[j] + (1.0f - alpha) * XX[j];
        for (int i = tid; i < m; i += kThreads) {
          const float w = alpha * Zt[i] + (1.0f - alpha) * Zi[i] +
                          (1.0f / Rho[i]) * YY[i];
          const float z1 = fminf(fmaxf(w, Lr[i]), Ur[i]);
          Zi[i] = z1;
          YY[i] = Rho[i] * (w - z1);
        }
        __syncthreads();
      }

      // ---- freeze blend fmask * old + keep * new, and the deltas ----
      const float fm = s_done[r] ? 1.f : 0.f, keep = 1.f - fm;
      for (int j = tid; j < n; j += kThreads) {
        const float xo = Xr[j], xn = XX[j];
        const float xb = fm * xo + keep * xn;
        XX[n + j] = keep * (xn - xo);
        XX[j] = xb;
        Xr[j] = xb;
      }
      for (int i = tid; i < m; i += kThreads) {
        const float yo = Yr[i], yn = YY[i];
        const float yb = fm * yo + keep * yn;
        YY[m + i] = keep * (yn - yo);
        YY[i] = yb;
        Yr[i] = yb;
        Zr[i] = fm * Zr[i] + keep * Zi[i];
      }
      __syncthreads();

      // ---- residual and certificate products: [x; dx] and [y; dy] ----
      rowgemm<2, true>(XX, n, Atr, m,
                       [&](int rr, int i, float acc) { TM[rr * m + i] = acc; });
      rowgemm<2, true>(XX, n, Pr, n,
                       [&](int rr, int j, float acc) { TN1[rr * n + j] = acc; });
      rowgemm<2, true>(YY, m, Ar, n,
                       [&](int rr, int j, float acc) { TN2[rr * n + j] = acc; });
      __syncthreads();

      // ---- checks of instance r on warp 0 ----
      if (warp == 0) {
        float rd = 0.f, rdP = 0.f, rdA = 0.f, rdQ = 0.f, dxn = 0.f, cd1 = 0.f,
              cp1 = 0.f, qdx = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float di = Dinv[j];
          const float px = TN1[j], aty = TN2[j], qj = Qr[j], dxj = XX[n + j];
          rd = fmaxf(rd, fabsf(di * ((px + qj) + aty)));
          rdP = fmaxf(rdP, fabsf(di * px));
          rdA = fmaxf(rdA, fabsf(di * aty));
          rdQ = fmaxf(rdQ, fabsf(di * qj));
          dxn = fmaxf(dxn, fabsf(Dr[j] * dxj));
          cd1 = fmaxf(cd1, fabsf(di * TN1[n + j]));
          cp1 = fmaxf(cp1, fabsf(di * TN2[n + j]));
          qdx += qj * dxj;
        }
        rd = warp_max(rd);
        rdP = warp_max(rdP);
        rdA = warp_max(rdA);
        rdQ = warp_max(rdQ);
        dxn = warp_max(dxn);
        cd1 = warp_max(cd1);
        cp1 = warp_max(cp1);
        qdx = warp_sum(qdx);
        float rp = 0.f, rpa = 0.f, rpz = 0.f, dyn = 0.f, sup = 0.f;
        bool open_dir = false, box_ok = true;
        const float bar = kEpsInf * dxn;
        for (int i = lane; i < m; i += 32) {
          const float ei = Einv[i];
          const float ax = TM[i], zz = Zr[i];
          rp = fmaxf(rp, fabsf(ei * (ax - zz)));
          rpa = fmaxf(rpa, fabsf(ei * ax));
          rpz = fmaxf(rpz, fabsf(ei * zz));
          const float dy = YY[m + i];
          const float edy = Er[i] * dy;
          dyn = fmaxf(dyn, fabsf(edy));
          const float uu = Ur[i], ll = Lr[i];
          const bool u_open = uu >= kInf * 0.5f, l_open = ll <= -kInf * 0.5f;
          const float u_fin = u_open ? 0.f : uu * ei;
          const float l_fin = l_open ? 0.f : ll * ei;
          sup += u_fin * fmaxf(edy, 0.f) + l_fin * fminf(edy, 0.f);
          open_dir = open_dir || (dy > 1e-12f && u_open) || (dy < -1e-12f && l_open);
          const float adx = ei * TM[m + i];
          box_ok = box_ok && (u_open || adx <= bar) && (l_open || adx >= -bar);
        }
        rp = warp_max(rp);
        rpa = warp_max(rpa);
        rpz = warp_max(rpz);
        dyn = warp_max(dyn);
        sup = warp_sum(sup);
        open_dir = warp_any(open_dir);
        box_ok = warp_all(box_ok);
        if (lane == 0) {
          const float rp_den = fmaxf(rpa, rpz);
          rd = cinv * rd;
          const float rd_den = cinv * fmaxf(fmaxf(rdP, rdA), rdQ);
          const bool ok = (rp <= p.eps_abs + p.eps_rel * rp_den) &&
                          (rd <= p.eps_abs + p.eps_rel * rd_den);
          const float dy_n = dyn * cinv;
          const bool cert_p1 = cp1 * cinv <= kEpsInf * dy_n;
          const bool p_inf = (dy_n > 1e-10f) && cert_p1 &&
                             (sup * cinv <= -kEpsInf * dy_n) && !open_dir;
          const bool cert_d1 = cd1 * cinv <= kEpsInf * dxn;
          const bool cert_d2 = qdx * cinv <= -kEpsInf * dxn;
          const bool d_inf = (dxn > 1e-10f) && cert_d1 && cert_d2 && box_ok;
          if (ok && !s_done[r]) s_itvec[r] = it_new;
          if (s_status[r] == 0) {
            if (ok) s_status[r] = 1;
            else if (p_inf) s_status[r] = -3;
            else if (d_inf) s_status[r] = -4;
          }
          const int dn = s_done[r] | (int)(ok || p_inf || d_inf);
          s_done[r] = dn;
          s_rp[r] = rp;
          s_rd[r] = rd;
          int change = 0;
          if (p.adaptive) {
            const float ratio =
                sqrtf((rp / fmaxf(rp_den, 1e-10f)) /
                      fmaxf(rd / fmaxf(rd_den, 1e-10f), 1e-10f));
            bool ch = (ratio > p.rho_tol ||
                       ratio < (float)(1.0 / (double)p.rho_tol)) && !dn;
            if (p.adapt_until > 0) ch = ch && (it_new <= p.adapt_until);
            const float step = fminf(fmaxf(ch ? ratio : 1.f, 0.1f), 10.f);
            s_scale[r] = fminf(fmaxf(s_scale[r] * step, 1e-6f), 1e6f);
            change = ch;
          }
          s_change[r] = change;
        }
      }
      __syncthreads();
    }
    it = it_new;

    // ---- block decisions over the cluster: loop condition (bit 0: an
    // instance is not done) and the refactorization (bit 1: a rho changed)
    int flags = 0;
    if (tid == 0)
      for (int r = 0; r < per; ++r)
        flags |= (s_done[r] ? 0 : 1) | (s_change[r] ? 2 : 0);
    flags = cluster_or(flags, &s_slot, &s_res);
    go = (flags & 1) && it < p.max_iter;
    if (flags & 2) {
      // re-form M at the new scales and warm-restart Newton-Schulz from
      // the current inverse, rescaled by max(||M X||_inf, 1)
      for (int r = 0; r < per; ++r) {
        form_M(r);
        const Inst I = inst(r);
        float* X = I.X[s_sel[r]];
        tile_gemm(I.M, n, nullptr, X, n, n, n, n, sA, sB,
                  [&](int i, int j, float acc) { I.T[(size_t)i * n + j] = acc; });
        float rmax = 0.f;
        for (int i = warp; i < n; i += kWarps) {
          float s = 0.f;
          for (int j = lane; j < n; j += 32) s += fabsf(I.T[(size_t)i * n + j]);
          rmax = nanmax(rmax, warp_sum(s));
        }
        const float den = fmaxf(block_max(rmax, red), 1.0f);
        for (size_t e = tid; e < nn; e += kThreads) X[e] = X[e] / den;
        __syncthreads();
      }
      for (int r = 0; r < per; ++r) sweeps(r, p.ns_adapt_iters);
      rescue();
    }
  }

  // ---- outputs and the objective c^-1 (x'Px / 2 + q'x) ----
  for (int e = tid; e < per * n; e += kThreads) p.ox[b0 * n + e] = Xs[e];
  for (int e = tid; e < per * m; e += kThreads) {
    p.oz[b0 * m + e] = Zs[e];
    p.oy[b0 * m + e] = Ys[e];
  }
  for (int r = 0; r < per; ++r) {
    const float* Xr = Xs + r * n;
    rowgemm<1, true>(Xr, n, p.Ps + (b0 + r) * nn, n,
                     [&](int, int j, float acc) { TN1[j] = acc; });
    __syncthreads();
    if (warp == 0) {
      float xpx = 0.f, qx = 0.f;
      for (int j = lane; j < n; j += 32) {
        xpx += Xr[j] * TN1[j];
        qx += Qs[r * n + j] * Xr[j];
      }
      xpx = warp_sum(xpx);
      qx = warp_sum(qx);
      if (lane == 0) {
        p.oobj[b0 + r] = p.cinv[b0 + r] * (0.5f * xpx + qx);
        p.oit[b0 + r] = s_done[r] ? s_itvec[r] : it;
        p.ost[b0 + r] = s_status[r];
        p.orp[b0 + r] = s_rp[r];
        p.ord[b0 + r] = s_rd[r];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches kernel K2 on `stream`; returns the CUDA error code (0 = success).
extern "C" int admm_full_solve_f32(
    const float* Ps, const float* As, const float* At, const float* q,
    const float* l, const float* u, const float* rho0, const float* D,
    const float* E, const float* cinv, const float* x0, const float* z0,
    const float* y0, float* ox, float* oz, float* oy, float* oobj, int* oit,
    int* ost, float* orp, float* ord, float* scratch, int B, int n, int m,
    int blk, float sigma, float alpha, float eps_abs, float eps_rel,
    float rho_tol, int check_interval, int max_iter, int ns_iters,
    int ns_f32_iters, int ns_adapt_iters, int adaptive, int kkt_refine,
    int adapt_until, void* stream) {
  // the block of blk instances is one cluster of csize thread blocks
  const int csize = blk < kClusterMax ? blk : kClusterMax;
  if (blk <= 0 || blk % csize != 0 || B % blk != 0 || n <= 0 || m <= 0 ||
      check_interval <= 0)
    return (int)cudaErrorInvalidValue;
  const int per = blk / csize;
  const size_t smem = 4 * smem_words(per, n, m);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      full_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (csize > 8) {
    err = cudaFuncSetAttribute(
        full_solve_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  Params p{Ps, As, At, q, l, u, rho0, D, E, cinv, x0, z0, y0, ox, oz, oy,
           oobj, oit, ost, orp, ord, scratch, n, m, per, sigma, alpha,
           eps_abs, eps_rel, rho_tol, check_interval, max_iter, ns_iters,
           ns_f32_iters, ns_adapt_iters, adaptive, kkt_refine, adapt_until};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B / per);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, full_solve_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
