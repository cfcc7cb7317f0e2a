// Kernel K1: the whole shared-KKT ADMM solve for a batch of QPs that share
// P and A, one thread block per chunk of instances.
//
// Replaces cvxpygen_tpu/ops/admm_shared_kernel.py::_shared_solve_kernel (the
// Pallas TPU kernel) and computes the same function on the same scaled data;
// its plain torch version is admm_shared_solve_plain in
// cvxpygen_tpu_torch/ops/admm_shared_kernel.py, which also builds and binds
// this file (nvcc -gencode arch=compute_90a,code=sm_90a, loaded with ctypes).
//
// What bounds it.  Per instance and iteration with kkt_refine=1 it does
// 3 n^2 + 2 m n multiply-adds (rhs = v A, x~ = rhs M^-1, r = rhs - x~ M,
// x~ += r M^-1, z~ = x~ A'): about 0.52 MFLOP of float32 at the MPC shape
// n=222, m=252, plus the residual and certificate products every
// check_interval iterations and, on each adaptive-rho change, an in-block
// refactorization of 2 n^3 per Newton-Schulz sweep.  Per block-iteration it
// reads about 1 MB of shared matrices; they stay in the 50 MB L2 cache.
//
// Design (a first version that is right before it is fast):
//  - one block of 256 threads per chunk (CH = 8, 4, 2 or 1 instances);
//  - the chunk's x, z, y, the iterate, q, l, u and the temporaries live in
//    dynamic shared memory (about 14 KB per instance at the MPC shape, 137 KB
//    per block at CH = 8, so one block per SM);
//  - the shared P, A, A' and the initial M, M^-1 are read from global
//    memory (L2-resident); a row GEMM gives each thread one output column
//    and all CH rows, so every matrix element read feeds CH multiply-adds,
//    and batches its L2 loads because one block per SM leaves few warps to
//    hide their latency;
//  - an adaptive-rho change re-forms M and restarts Newton-Schulz inside
//    the block with a 128x128-tiled SIMT GEMM over the block's global scratch
//    (M, two M^-1 buffers and a temporary, allocated by the wrapper);
//  - control flow is uniform: the loop condition and the rho change are
//    decided by one thread after __syncthreads and read by all;
//  - full float32 FMA, no TF32, no fast math (logf/expf of the adaptive-rho
//    mean match the plain version).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm.cuh"

namespace {

using namespace cvxk;

constexpr float kInf = 1e30f;
constexpr float kEpsInf = 1e-4f;
constexpr size_t kSmemLimit = 232448;

struct Params {
  const float* Ps;     // (n, n) scaled P
  const float* As;     // (m, n) scaled A
  const float* At;     // (n, m) its transpose
  const float* M0;     // (n, n) KKT matrix at rho_base
  const float* Minv0;  // (n, n) its inverse
  const float* rho0;   // (m,)
  const float* D;      // (n,)
  const float* E;      // (m,)
  float c_inv;
  const float* q;      // (B, n)
  const float* l;      // (B, m)
  const float* u;      // (B, m)
  const float* x0;     // (B, n)
  const float* z0;     // (B, m)
  const float* y0;     // (B, m)
  float* ox;           // (B, n)
  float* oz;           // (B, m)
  float* oy;           // (B, m)
  int* oit;            // (B,)
  int* ost;            // (B,)
  float* orp;          // (B,)
  float* ord;          // (B,)
  float* scratch;      // (B / CH, 4, n, n)
  int n, m;
  float sigma, alpha, eps_abs, eps_rel, rho_tol;
  int check_interval, max_iter, ns_adapt_iters, adaptive, kkt_refine,
      adapt_until;
};

// 4-byte words of dynamic shared memory for one block (pick_shared_chunk in
// the Python wrapper mirrors this formula).
size_t smem_words(int ch, int n, int m) {
  return (size_t)ch * (7 * n + 8 * m) + n + 4 * m + kTileK * kTileLd +
         kTileK * kTile + kThreads + 7 * ch;
}

template <int CH>
__global__ void __launch_bounds__(kThreads)
    shared_solve_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t b0 = (size_t)blockIdx.x * CH;

  // the tile buffers first: float4 reads need 16-byte alignment
  float* sA = smem;                        // kTileK x kTileLd
  float* sB = sA + kTileK * kTileLd;       // kTileK x kTile
  float* XX = sB + kTileK * kTile;  // 2CH x n: rows [0, CH) state x,
                                 //          rows [CH, 2CH) iterate, then dx
  float* YY = XX + 2 * CH * n;   // 2CH x m: state y; iterate, then dy
  float* Zs = YY + 2 * CH * m;   // CH x m state z
  float* Zi = Zs + CH * m;       // CH x m iterate z
  float* Q = Zi + CH * m;        // CH x n
  float* L = Q + CH * n;         // CH x m
  float* U = L + CH * m;         // CH x m
  float* T1 = U + CH * m;        // 2CH x m temporaries
  float* T2 = T1 + 2 * CH * m;   // 2CH x n
  float* T3 = T2 + 2 * CH * n;   // 2CH x n
  float* rho0 = T3 + 2 * CH * n;  // m
  float* rho = rho0 + m;          // m: rho0 * rho_scale
  float* Dinv = rho + m;          // n
  float* Ev = Dinv + n;           // m
  float* Einv = Ev + m;           // m
  float* red = Einv + m;                  // kThreads
  float* s_rp = red + kThreads;           // CH
  float* s_rd = s_rp + CH;                // CH
  float* s_logr = s_rd + CH;              // CH
  int* s_done = (int*)(s_logr + CH);      // CH
  int* s_status = s_done + CH;            // CH
  int* s_itvec = s_status + CH;           // CH
  int* s_active = s_itvec + CH;           // CH
  __shared__ int s_go, s_change;
  __shared__ float s_scale;

  float* Xs = XX;
  float* Xi = XX + CH * n;
  float* Ys = YY;
  float* Yi = YY + CH * m;

  // scratch of this block: M, two M^-1 buffers, one temporary
  const size_t nn = (size_t)n * n;
  float* Mb = p.scratch + (size_t)blockIdx.x * 4 * nn;
  float* Xa = Mb + nn;
  float* Xb = Xa + nn;
  float* Tb = Xb + nn;
  const float* curM = p.M0;
  const float* curMinv = p.Minv0;

  for (int e = tid; e < CH * n; e += kThreads) {
    Q[e] = p.q[b0 * n + e];
    Xs[e] = p.x0[b0 * n + e];
  }
  for (int e = tid; e < CH * m; e += kThreads) {
    L[e] = p.l[b0 * m + e];
    U[e] = p.u[b0 * m + e];
    Zs[e] = p.z0[b0 * m + e];
    Ys[e] = p.y0[b0 * m + e];
  }
  for (int i = tid; i < m; i += kThreads) {
    rho0[i] = p.rho0[i];
    Ev[i] = p.E[i];
    Einv[i] = 1.0f / p.E[i];
  }
  for (int j = tid; j < n; j += kThreads) Dinv[j] = 1.0f / p.D[j];
  if (tid < CH) {
    s_rp[tid] = kInf;
    s_rd[tid] = kInf;
    s_done[tid] = 0;
    s_status[tid] = 0;
    s_itvec[tid] = 0;
  }
  const float sigma = p.sigma, alpha = p.alpha, cinv = p.c_inv;
  float scale = 1.0f;
  int it = 0;
  bool go = p.max_iter > 0;
  __syncthreads();

  while (go) {
    // ---- check_interval ADMM iterations from the state ----
    for (int i = tid; i < m; i += kThreads) rho[i] = rho0[i] * scale;
    for (int e = tid; e < CH * n; e += kThreads) Xi[e] = Xs[e];
    for (int e = tid; e < CH * m; e += kThreads) {
      Zi[e] = Zs[e];
      Yi[e] = Ys[e];
    }
    __syncthreads();
    for (int t = 0; t < p.check_interval; ++t) {
      for (int e = tid; e < CH * m; e += kThreads) {
        const int i = e % m;
        T1[e] = rho[i] * Zi[e] - Yi[e];
      }
      __syncthreads();
      // rhs = sigma x - q + (rho z - y) A  -> T2[0 : CH n]
      rowgemm<CH, true>(T1, m, p.As, n, [&](int r, int j, float acc) {
        T2[r * n + j] = (sigma * Xi[r * n + j] - Q[r * n + j]) + acc;
      });
      __syncthreads();
      // x~ = rhs M^-1  -> T3[0 : CH n]
      rowgemm<CH, false>(T2, n, curMinv, n, [&](int r, int j, float acc) {
        T3[r * n + j] = acc;
      });
      __syncthreads();
      for (int s = 0; s < p.kkt_refine; ++s) {
        float* Rr = T2 + CH * n;
        // r = rhs - x~ M  -> T2[CH n : 2 CH n]
        rowgemm<CH, false>(T3, n, curM, n, [&](int r, int j, float acc) {
          Rr[r * n + j] = T2[r * n + j] - acc;
        });
        __syncthreads();
        // x~ += r M^-1
        rowgemm<CH, false>(Rr, n, curMinv, n, [&](int r, int j, float acc) {
          T3[r * n + j] = T3[r * n + j] + acc;
        });
        __syncthreads();
      }
      // z~ = x~ A'  -> T1[CH m : 2 CH m]
      float* Zt = T1 + CH * m;
      rowgemm<CH, true>(T3, n, p.At, m, [&](int r, int j, float acc) {
        Zt[r * m + j] = acc;
      });
      __syncthreads();
      for (int e = tid; e < CH * n; e += kThreads)
        Xi[e] = alpha * T3[e] + (1.0f - alpha) * Xi[e];
      for (int e = tid; e < CH * m; e += kThreads) {
        const int i = e % m;
        const float w =
            alpha * Zt[e] + (1.0f - alpha) * Zi[e] + (1.0f / rho[i]) * Yi[e];
        const float z1 = fminf(fmaxf(w, L[e]), U[e]);
        Zi[e] = z1;
        Yi[e] = rho[i] * (w - z1);
      }
      __syncthreads();
    }

    // ---- keep done instances, form the deltas ----
    for (int e = tid; e < CH * n; e += kThreads) {
      const float xn = Xi[e], xo = Xs[e];
      if (s_done[e / n]) {
        Xi[e] = 0.f;
      } else {
        Xs[e] = xn;
        Xi[e] = xn - xo;
      }
    }
    for (int e = tid; e < CH * m; e += kThreads) {
      const float yn = Yi[e], yo = Ys[e];
      if (s_done[e / m]) {
        Yi[e] = 0.f;
      } else {
        Zs[e] = Zi[e];
        Ys[e] = yn;
        Yi[e] = yn - yo;
      }
    }
    it += p.check_interval;
    __syncthreads();

    // ---- residual and certificate products: [x; dx] and [y; dy] ----
    rowgemm<2 * CH, true>(XX, n, p.At, m, [&](int r, int j, float acc) {
      T1[r * m + j] = acc;  // [Ax; Adx]
    });
    rowgemm<2 * CH, true>(XX, n, p.Ps, n, [&](int r, int j, float acc) {
      T2[r * n + j] = acc;  // [Px; Pdx]
    });
    rowgemm<2 * CH, true>(YY, m, p.As, n, [&](int r, int j, float acc) {
      T3[r * n + j] = acc;  // [A'y; A'dy]
    });
    __syncthreads();

    // ---- per-instance checks, one warp per instance ----
    for (int r = warp; r < CH; r += kWarps) {
      float rd = 0.f, rdP = 0.f, rdA = 0.f, rdQ = 0.f, dxn = 0.f, cd1 = 0.f,
            cp1 = 0.f, qdx = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float di = Dinv[j];
        const float px = T2[r * n + j], aty = T3[r * n + j];
        const float qj = Q[r * n + j], dxj = Xi[r * n + j];
        rd = fmaxf(rd, fabsf(di * ((px + qj) + aty)));
        rdP = fmaxf(rdP, fabsf(di * px));
        rdA = fmaxf(rdA, fabsf(di * aty));
        rdQ = fmaxf(rdQ, fabsf(di * qj));
        dxn = fmaxf(dxn, fabsf(dxj / di));
        cd1 = fmaxf(cd1, fabsf(di * T2[(CH + r) * n + j]));
        cp1 = fmaxf(cp1, fabsf(di * T3[(CH + r) * n + j]));
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
        const float ax = T1[r * m + i], zz = Zs[r * m + i];
        rp = fmaxf(rp, fabsf(ei * (ax - zz)));
        rpa = fmaxf(rpa, fabsf(ei * ax));
        rpz = fmaxf(rpz, fabsf(ei * zz));
        const float dy = Yi[r * m + i];
        const float edy = Ev[i] * dy;
        dyn = fmaxf(dyn, fabsf(edy));
        const float uu = U[r * m + i], ll = L[r * m + i];
        const bool u_open = uu >= kInf * 0.5f, l_open = ll <= -kInf * 0.5f;
        const float u_fin = u_open ? 0.f : uu * ei;
        const float l_fin = l_open ? 0.f : ll * ei;
        sup += u_fin * fmaxf(edy, 0.f) + l_fin * fminf(edy, 0.f);
        open_dir = open_dir || (dy > 1e-12f && u_open) || (dy < -1e-12f && l_open);
        const float adx = ei * T1[(CH + r) * m + i];
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
        if (ok && !s_done[r]) s_itvec[r] = it;
        if (s_status[r] == 0) {
          if (ok) s_status[r] = 1;
          else if (p_inf) s_status[r] = -3;
          else if (d_inf) s_status[r] = -4;
        }
        const int dn = s_done[r] | (int)(ok || p_inf || d_inf);
        s_done[r] = dn;
        s_active[r] = !dn;
        s_rp[r] = rp;
        s_rd[r] = rd;
        const float ratio =
            sqrtf((rp / fmaxf(rp_den, 1e-10f)) /
                  fmaxf(rd / fmaxf(rd_den, 1e-10f), 1e-10f));
        s_logr[r] = dn ? 0.f : logf(fminf(fmaxf(ratio, 1e-6f), 1e6f));
      }
    }
    __syncthreads();

    // ---- chunk decisions: loop condition and the shared rho ----
    if (tid == 0) {
      bool all_done = true, any_active = false;
      float sum_log = 0.f, n_act = 0.f;
      for (int r = 0; r < CH; ++r) {
        all_done = all_done && s_done[r];
        any_active = any_active || s_active[r];
        sum_log += s_logr[r];
        n_act += s_active[r] ? 1.f : 0.f;
      }
      int change = 0;
      float new_scale = scale;
      if (p.adaptive) {
        const float comb = expf(sum_log / fmaxf(n_act, 1.f));
        bool ch = (comb > p.rho_tol || comb < (float)(1.0 / (double)p.rho_tol)) &&
                  any_active;
        if (p.adapt_until > 0) ch = ch && (it <= p.adapt_until);
        const float step = fminf(fmaxf(ch ? comb : 1.f, 0.1f), 10.f);
        new_scale = fminf(fmaxf(scale * step, 1e-6f), 1e6f);
        change = ch;
      }
      s_change = change;
      s_scale = new_scale;
      s_go = !all_done && it < p.max_iter;
    }
    __syncthreads();
    scale = s_scale;
    go = s_go;

    if (s_change) {
      // re-form M at the new rho and warm-restart Newton-Schulz from the
      // current inverse, with the spectral rescale X /= max(||M X||_inf, 1)
      for (int i = tid; i < m; i += kThreads) rho[i] = rho0[i] * scale;
      __syncthreads();
      const float* Ps = p.Ps;
      tile_gemm(p.At, m, rho, p.As, n, n, n, m, sA, sB,
                [&](int i, int j, float acc) {
                  Mb[(size_t)i * n + j] =
                      (Ps[(size_t)i * n + j] + (i == j ? sigma : 0.f)) + acc;
                });
      tile_gemm(Mb, n, nullptr, curMinv, n, n, n, n, sA, sB,
                [&](int i, int j, float acc) { Tb[(size_t)i * n + j] = acc; });
      float rmax = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        float s = 0.f;
        for (int j = 0; j < n; ++j) s += fabsf(Tb[(size_t)i * n + j]);
        rmax = fmaxf(rmax, s);
      }
      red[tid] = rmax;
      __syncthreads();
      for (int o = kThreads / 2; o > 0; o >>= 1) {
        if (tid < o) red[tid] = fmaxf(red[tid], red[tid + o]);
        __syncthreads();
      }
      const float den = fmaxf(red[0], 1.f);
      float* X = (curMinv == Xa) ? Xb : Xa;
      for (size_t e = tid; e < nn; e += kThreads) X[e] = curMinv[e] / den;
      __syncthreads();
      for (int s = 0; s < p.ns_adapt_iters; ++s) {
        tile_gemm(Mb, n, nullptr, X, n, n, n, n, sA, sB,
                  [&](int i, int j, float acc) {
                    Tb[(size_t)i * n + j] = (i == j ? 2.f : 0.f) - acc;
                  });
        float* Xn = (X == Xa) ? Xb : Xa;
        tile_gemm(X, n, nullptr, Tb, n, n, n, n, sA, sB,
                  [&](int i, int j, float acc) { Xn[(size_t)i * n + j] = acc; });
        X = Xn;
      }
      curM = Mb;
      curMinv = X;
    }
  }

  for (int e = tid; e < CH * n; e += kThreads) p.ox[b0 * n + e] = Xs[e];
  for (int e = tid; e < CH * m; e += kThreads) {
    p.oz[b0 * m + e] = Zs[e];
    p.oy[b0 * m + e] = Ys[e];
  }
  if (tid < CH) {
    p.oit[b0 + tid] = s_done[tid] ? s_itvec[tid] : it;
    p.ost[b0 + tid] = s_status[tid];
    p.orp[b0 + tid] = s_rp[tid];
    p.ord[b0 + tid] = s_rd[tid];
  }
}

template <int CH>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      shared_solve_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  shared_solve_kernel<CH><<<B / CH, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches kernel K1 on `stream`; returns the CUDA error code (0 = success).
extern "C" int admm_shared_solve_f32(
    const float* Ps, const float* As, const float* At, const float* M0,
    const float* Minv0, const float* rho0, const float* D, const float* E,
    float c_inv, const float* q, const float* l, const float* u,
    const float* x0, const float* z0, const float* y0, float* ox, float* oz,
    float* oy, int* oit, int* ost, float* orp, float* ord, float* scratch,
    int B, int n, int m, int chunk, float sigma, float alpha, float eps_abs,
    float eps_rel, float rho_tol, int check_interval, int max_iter,
    int ns_adapt_iters, int adaptive, int kkt_refine, int adapt_until,
    void* stream) {
  if (chunk <= 0 || B % chunk != 0 || n <= 0 || m <= 0 || check_interval <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * smem_words(chunk, n, m);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  Params p{Ps, As, At, M0, Minv0, rho0, D, E, c_inv, q, l, u, x0, z0, y0,
           ox, oz, oy, oit, ost, orp, ord, scratch, n, m, sigma, alpha,
           eps_abs, eps_rel, rho_tol, check_interval, max_iter,
           ns_adapt_iters, adaptive, kkt_refine, adapt_until};
  cudaStream_t s = (cudaStream_t)stream;
  switch (chunk) {
    case 8: return (int)launch<8>(p, B, smem, s);
    case 4: return (int)launch<4>(p, B, smem, s);
    case 2: return (int)launch<2>(p, B, smem, s);
    case 1: return (int)launch<1>(p, B, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
