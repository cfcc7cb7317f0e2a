// Kernel K1: the whole shared-KKT ADMM solve for a batch of QPs that share
// P and A, one chunk of instances (the rho group) spread over many thread
// blocks.
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
// n=222, m=252, 1.06 GFLOP per iteration of a B=2048 batch, 16 us at the
// card's float32 peak; plus the residual and certificate products every
// check_interval iterations and, on each adaptive-rho change, one
// refactorization per chunk of 2 n^3 per Newton-Schulz sweep.  The shared
// matrices (about 1 MB) and the chunk's M and M^-1 stay in the 50 MB L2, and
// every block streams them from there each iteration: each element it reads
// feeds one multiply-add per instance of the block.  On the card the
// products are bound neither by that stream nor by the arithmetic alone but
// by their sum: a block's copies and multiply-adds overlap poorly (PERF.md).
//
// Design.  Rho and M^-1 are fixed between two checks, so within a check
// interval the instances are independent:
//  - iterate_kernel: one block of 256 threads per tile of R instances of one
//    chunk (R = 16, 8, 4, 2 or 1, the largest that divides the chunk and
//    fits: the wrapper's choice, not part of the answer).  The tile's x, z,
//    y, the iterates and the temporaries live in shared memory (q, l, u
//    are read through L1); it runs check_interval iterations, the residual
//    and certificate products and each instance's checks, and writes the
//    state, the status and the log-ratio back.  A tile whose instances are
//    all done exits at once: their state would not change and their checks
//    would give the same results again.  In each
//    product every warp streams 32 columns of the matrix through its own
//    ring in shared memory (16-byte cp.async, four tiles of 8 rows in
//    flight), so no block-wide barrier sits inside a product; a lane sums
//    a micro-tile of R/4 instances by 4 columns in full float32 FMA in k
//    order (so an instance's result does not depend on R; the three-pass
//    TF32 mma.sync products were slower on the card, PERF.md);
//  - decide_kernel: one block per chunk sums the chunk's log-ratios and
//    counts its active instances in a fixed order (each thread a strided
//    slice in ascending order, then a tree over the threads; no float
//    atomics), so every run and every block reads the same decision: the
//    chunk's new rho scale, whether it refactors, whether it runs on;
//  - on a rho change, the refactorization once per chunk, in 2 + 2 x
//    ns_adapt_iters launches of a 32 x 32-tiled SIMT GEMM over the chunks
//    (chunks that did not change exit at once) and one rescale launch:
//    M = P + sigma I + A' diag(rho) A, the spectral rescale
//    X = M^-1 / max(||M M^-1||_inf, 1), then Newton-Schulz sweeps
//    X <- X (2 I - M X), into the chunk's global scratch (M, two M^-1
//    buffers, a temporary);
//  - the host runs the loop: after each decide launch it reads two flags
//    (any chunk running, any chunk refactoring) and launches the next
//    interval, the refactorization, or nothing.
// The n x n and m x n matrices arrive with rows padded to a multiple of 4
// floats (the wrapper pads them), so every row starts on 16 bytes.  Full
// float32 arithmetic, no fast math (logf and expf of the adaptive-rho mean
// match the plain version).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm.cuh"

namespace {

using namespace cvxk;

constexpr float kInf = 1e30f;
constexpr float kEpsInf = 1e-4f;
constexpr size_t kSmemLimit = 232448;
constexpr int kGt = 32;  // output tile of the refactorization GEMM
// tiles of eight rows of 40 words in each warp's ring of the streamed matrix
constexpr int kRingTiles = 5;
constexpr int kRingWords = 8 * kRingTiles * 8 * 40;

// words of a chunk's control state in p.cs (the scale as float bits)
enum { kScale, kIt, kRunning, kChange, kSel, kPrev, kStart, kStateWords = 8 };

struct Params {
  const float* Ps;     // (n, ldn) scaled P, ldn = n rounded up to 4
  const float* As;     // (m, ldn) scaled A
  const float* At;     // (n, ldm) its transpose, ldm = m rounded up to 4
  const float* M0;     // (n, ldn) KKT matrix at rho_base
  const float* Minv0;  // (n, ldn) its inverse
  const float* rho0;   // (m,)
  const float* D;      // (n,)
  const float* E;      // (m,)
  float c_inv;
  const float* q;      // (B, n)
  const float* l;      // (B, m)
  const float* u;      // (B, m)
  float* x;            // (B, n) state, returned
  float* z;            // (B, m)
  float* y;            // (B, m)
  int* oit;            // (B,)
  int* ost;            // (B,)
  float* orp;          // (B,)
  float* ord;          // (B,)
  int* done;           // (B,)
  int* itvec;          // (B,) iteration at which the instance converged
  float* logr;         // (B,) log of its clamped residual ratio, 0 if done
  int* cs;             // (B / chunk, kStateWords)
  int* flags;          // (2,): a chunk runs on, a chunk refactors
  float* scratch;      // (B / chunk, 4, n, ldn)
  int B, n, m, chunk;
  float sigma, alpha, eps_abs, eps_rel, rho_tol;
  int check_interval, max_iter, ns_adapt_iters, adaptive, kkt_refine,
      adapt_until;
};

// row stride in shared memory of a vector of length k: at least k rounded
// up to 8 (the zero padding lets the products read whole 8-deep tiles) and
// 4 modulo 32, so the rows of a micro-tile start in distinct banks
__host__ __device__ inline int pad_stride(int k) {
  const int k8 = (k + 7) / 8 * 8;
  return k8 + ((4 - k8) % 32 + 32) % 32;
}

__host__ __device__ inline int round4(int k) { return (k + 3) / 4 * 4; }

// Offset in 4-byte words of the warps' rings in the dynamic shared memory of
// one iterate block of R rows: after the R x pad_stride vectors, the
// per-row vectors (m, m, m, n) and the per-row scalars (six of R words, 8R
// reserved).  A multiple of 4 for every R, so the rings start on 16 bytes.
__host__ __device__ inline size_t ring_offset(int R, int n, int m) {
  return (size_t)R * (6 * pad_stride(n) + 5 * pad_stride(m)) +
         round4(3 * m + n) + 8 * R;
}

// words of the whole block (shared_smem_bytes in the Python wrapper mirrors
// this formula)
__host__ __device__ inline size_t smem_words(int R, int n, int m) {
  return ring_offset(R, n, m) + kRingWords;
}

// The products stream their matrix W (K x N, row stride ldw, a multiple of
// 4) from L2 into shared memory by 16-byte cp.async.  Each warp owns 32
// columns of W (a pass covers 256; columns past N are never used) and its
// own ring of kRingTiles tiles of kTk rows of them, so it runs its own
// pipeline: kRingTiles - 1 tiles in flight while it multiplies one, and no
// barrier across the block inside a product (rows past K are zero-filled).
constexpr int kTk = 8;
constexpr int kWc = 32;  // columns of W per warp and pass
constexpr int kWs = kWc + 8;  // ring row stride
static_assert(kRingWords == kWarps * kRingTiles * kTk * kWs,
              "the rings' share of shared memory");

__device__ __forceinline__ void cp_async16(float* s, const float* g,
                                           bool valid) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(g), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the warp copies tile kt of its columns [c0, c0 + 32) into its ring
__device__ __forceinline__ void warp_issue(float* wring, const float* W,
                                           int ldw, int K, int c0, int kt) {
  const int lane = threadIdx.x % 32;
  const int chunks = min(ldw - c0, kWc) / 4;
  float* dst = wring + (kt % kRingTiles) * kTk * kWs;
  for (int e = lane; e < kTk * (kWc / 4); e += 32) {
    const int row = e / (kWc / 4), ch = e % (kWc / 4);
    const int k = kt * kTk + row;
    if (ch < chunks)
      cp_async16(dst + row * kWs + 4 * ch,
                 W + (size_t)(k < K ? k : 0) * ldw + c0 + 4 * ch, k < K);
  }
}

// Runs tile(Ws, k0) for every kTk-row tile of the warp's columns, Ws the
// tile in the warp's ring (row stride kWs, column 0 = c0).
template <typename Tile>
__device__ __forceinline__ void warp_pipeline(const float* W, int ldw, int K,
                                              int c0, float* wring,
                                              Tile tile) {
  const int nk = (K + kTk - 1) / kTk;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kRingTiles - 1; ++s) {
    if (s < nk) warp_issue(wring, W, ldw, K, c0, s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<kRingTiles - 2>();
    __syncwarp();
    if (s + kRingTiles - 1 < nk)
      warp_issue(wring, W, ldw, K, c0, s + kRingTiles - 1);
    cp_async_commit();
    tile(wring + (s % kRingTiles) * kTk * kWs, s * kTk);
  }
}

// Y(r, j) = epi(r, j, sum_k X(r, k) W(k, j)) for r < R, j < N: X in shared
// memory with row stride SX (4 mod 32) and zero padding up to a multiple of
// kTk, W in global memory through the warps' rings.  Lane (rg, cg) = (lane
// / 8, lane % 8) of a warp owns rows rg, rg + 4, ... and 4 columns, so each
// 16-byte read of W or X is one shared-memory wavefront and feeds 4 or R/4
// multiply-adds.  Sums in k order (the zero padding adds exact zeros), so a
// row's result does not depend on R.
template <int R, typename Epi>
__device__ __forceinline__ void prod_simt(const float* X, int SX, int K,
                                          const float* W, int ldw, int N,
                                          float* ring, Epi epi) {
  constexpr int RG = R < 4 ? R : 4;
  constexpr int RT = R / RG;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  float* wring = ring + warp * kRingTiles * kTk * kWs;
  for (int j0 = 0; j0 < N; j0 += kThreads) {
    const int c0 = j0 + warp * kWc;
    if (c0 >= N) continue;
    const int j = c0 + 4 * cg;
    const bool active = rg < RG;
    float acc[RT][4];
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    warp_pipeline(W, ldw, K, c0, wring, [&](const float* Ws, int k0) {
      if (!active) return;
      float4 w[kTk];
#pragma unroll
      for (int v = 0; v < kTk; ++v)
        w[v] = *reinterpret_cast<const float4*>(Ws + v * kWs + 4 * cg);
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const float* xr = X + (rg + RG * a) * SX + k0;
        const float4 x0 = *reinterpret_cast<const float4*>(xr);
        const float4 x1 = *reinterpret_cast<const float4*>(xr + 4);
        const float xv[kTk] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int v = 0; v < kTk; ++v) {
          acc[a][0] = fmaf(xv[v], w[v].x, acc[a][0]);
          acc[a][1] = fmaf(xv[v], w[v].y, acc[a][1]);
          acc[a][2] = fmaf(xv[v], w[v].z, acc[a][2]);
          acc[a][3] = fmaf(xv[v], w[v].w, acc[a][3]);
        }
      }
    });
    if (active) {
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (j + b < N) epi(rg + RG * a, j + b, acc[a][b]);
    }
  }
}

// One check interval of one tile of R instances of one chunk.
template <int R>
__global__ void __launch_bounds__(kThreads) iterate_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m;
  const int Sn = pad_stride(n), Sm = pad_stride(m);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * R;
  const int c = b0 / p.chunk;
  const int* cs = p.cs + (size_t)c * kStateWords;
  __shared__ int s_any;
  if (!cs[kRunning]) return;
  if (tid == 0) {
    int any = 0;
    for (int r = 0; r < R; ++r) any |= !p.done[b0 + r];
    s_any = any;
  }
  __syncthreads();
  if (!s_any) return;

  float* Xs = smem;           // R x Sn: state x
  float* Xi = Xs + R * Sn;    // iterate x, then dx
  float* T2 = Xi + R * Sn;    // rhs, then P x
  float* T3 = T2 + R * Sn;    // x~, then P dx
  float* Rr = T3 + R * Sn;    // refinement residual, then A' y
  float* T4 = Rr + R * Sn;    // A' dy
  float* Zs = T4 + R * Sn;    // R x Sm: state z
  float* Zi = Zs + R * Sm;    // iterate z, then A dx
  float* Ys = Zi + R * Sm;    // state y
  float* Yi = Ys + R * Sm;    // iterate y, then dy
  float* T1 = Yi + R * Sm;    // rho z - y, then z~, then A x
  float* rho = T1 + R * Sm;   // m: rho0 * scale
  float* Ev = rho + m;        // m
  float* Einv = Ev + m;       // m
  float* Dinv = Einv + m;     // n
  float* s_rp = rho + round4(3 * m + n);  // R
  float* s_rd = s_rp + R;                 // R
  float* s_logr = s_rd + R;               // R
  int* s_done = (int*)(s_logr + R);       // R
  int* s_status = s_done + R;             // R
  int* s_itvec = s_status + R;            // R
  float* ring = smem + ring_offset(R, n, m);  // kRingWords: warps' rings

  const size_t words = smem_words(R, n, m);
  for (size_t e = tid; e < words; e += kThreads) smem[e] = 0.f;
  __syncthreads();
  const float scale = __int_as_float(cs[kScale]);
  for (int e = tid; e < R * n; e += kThreads) {
    const int r = e / n, j = e % n;
    Xs[r * Sn + j] = p.x[(size_t)b0 * n + e];
  }
  for (int e = tid; e < R * m; e += kThreads) {
    const int r = e / m, i = e % m;
    Zs[r * Sm + i] = p.z[(size_t)b0 * m + e];
    Ys[r * Sm + i] = p.y[(size_t)b0 * m + e];
  }
  for (int i = tid; i < m; i += kThreads) {
    rho[i] = p.rho0[i] * scale;
    Ev[i] = p.E[i];
    Einv[i] = 1.0f / p.E[i];
  }
  for (int j = tid; j < n; j += kThreads) Dinv[j] = 1.0f / p.D[j];
  if (tid < R) {
    s_done[tid] = p.done[b0 + tid];
    s_status[tid] = p.ost[b0 + tid];
    s_itvec[tid] = p.itvec[b0 + tid];
    s_rp[tid] = p.orp[b0 + tid];
    s_rd[tid] = p.ord[b0 + tid];
    s_logr[tid] = p.logr[b0 + tid];
  }
  const int ldn = round4(n), ldm = round4(m);
  const size_t nn = (size_t)n * ldn;
  const int sel = cs[kSel];
  const float* scr = p.scratch + (size_t)c * 4 * nn;
  const float* Minv = sel < 0 ? p.Minv0 : scr + (1 + sel) * nn;
  const float* Mm = sel < 0 ? p.M0 : scr;
  const float* qg = p.q + (size_t)b0 * n;
  const float* lg = p.l + (size_t)b0 * m;
  const float* ug = p.u + (size_t)b0 * m;
  const float sigma = p.sigma, alpha = p.alpha, cinv = p.c_inv;
  __syncthreads();

  // ---- check_interval ADMM iterations from the state ----
  for (int e = tid; e < R * n; e += kThreads) {
    const int o = (e / n) * Sn + e % n;
    Xi[o] = Xs[o];
  }
  for (int e = tid; e < R * m; e += kThreads) {
    const int o = (e / m) * Sm + e % m;
    Zi[o] = Zs[o];
    Yi[o] = Ys[o];
  }
  __syncthreads();
  for (int t = 0; t < p.check_interval; ++t) {
    for (int e = tid; e < R * m; e += kThreads) {
      const int i = e % m, o = (e / m) * Sm + i;
      T1[o] = rho[i] * Zi[o] - Yi[o];
    }
    __syncthreads();
    // rhs = sigma x - q + (rho z - y) A
    prod_simt<R>(T1, Sm, m, p.As, ldn, n, ring, [&](int r, int j, float acc) {
      T2[r * Sn + j] =
          (sigma * Xi[r * Sn + j] - __ldg(qg + (size_t)r * n + j)) + acc;
    });
    __syncthreads();
    // x~ = rhs M^-1
    prod_simt<R>(T2, Sn, n, Minv, ldn, n, ring,
                 [&](int r, int j, float acc) { T3[r * Sn + j] = acc; });
    __syncthreads();
    for (int s = 0; s < p.kkt_refine; ++s) {
      // r = rhs - x~ M, then x~ += r M^-1
      prod_simt<R>(T3, Sn, n, Mm, ldn, n, ring, [&](int r, int j, float acc) {
        Rr[r * Sn + j] = T2[r * Sn + j] - acc;
      });
      __syncthreads();
      prod_simt<R>(Rr, Sn, n, Minv, ldn, n, ring,
                   [&](int r, int j, float acc) {
                     T3[r * Sn + j] = T3[r * Sn + j] + acc;
                   });
      __syncthreads();
    }
    // z~ = x~ A'
    prod_simt<R>(T3, Sn, n, p.At, ldm, m, ring,
                 [&](int r, int j, float acc) { T1[r * Sm + j] = acc; });
    __syncthreads();
    for (int e = tid; e < R * n; e += kThreads) {
      const int o = (e / n) * Sn + e % n;
      Xi[o] = alpha * T3[o] + (1.0f - alpha) * Xi[o];
    }
    for (int e = tid; e < R * m; e += kThreads) {
      const int r = e / m, i = e % m, o = r * Sm + i;
      const float w =
          alpha * T1[o] + (1.0f - alpha) * Zi[o] + (1.0f / rho[i]) * Yi[o];
      const float z1 = fminf(fmaxf(w, __ldg(lg + e)), __ldg(ug + e));
      Zi[o] = z1;
      Yi[o] = rho[i] * (w - z1);
    }
    __syncthreads();
  }

  // ---- keep done instances, form the deltas ----
  for (int e = tid; e < R * n; e += kThreads) {
    const int o = (e / n) * Sn + e % n;
    const float xn = Xi[o], xo = Xs[o];
    if (s_done[e / n]) {
      Xi[o] = 0.f;
    } else {
      Xs[o] = xn;
      Xi[o] = xn - xo;
    }
  }
  for (int e = tid; e < R * m; e += kThreads) {
    const int o = (e / m) * Sm + e % m;
    const float yn = Yi[o], yo = Ys[o];
    if (s_done[e / m]) {
      Yi[o] = 0.f;
    } else {
      Zs[o] = Zi[o];
      Ys[o] = yn;
      Yi[o] = yn - yo;
    }
  }
  const int it = cs[kIt] + p.check_interval;
  __syncthreads();

  // ---- residual and certificate products ----
  prod_simt<R>(Xs, Sn, n, p.At, ldm, m, ring,
               [&](int r, int j, float acc) { T1[r * Sm + j] = acc; });
  prod_simt<R>(Xi, Sn, n, p.At, ldm, m, ring,
               [&](int r, int j, float acc) { Zi[r * Sm + j] = acc; });
  prod_simt<R>(Xs, Sn, n, p.Ps, ldn, n, ring,
               [&](int r, int j, float acc) { T2[r * Sn + j] = acc; });
  prod_simt<R>(Xi, Sn, n, p.Ps, ldn, n, ring,
               [&](int r, int j, float acc) { T3[r * Sn + j] = acc; });
  prod_simt<R>(Ys, Sm, m, p.As, ldn, n, ring,
               [&](int r, int j, float acc) { Rr[r * Sn + j] = acc; });
  prod_simt<R>(Yi, Sm, m, p.As, ldn, n, ring,
               [&](int r, int j, float acc) { T4[r * Sn + j] = acc; });
  __syncthreads();

  // ---- per-instance checks, one warp per instance ----
  for (int r = warp; r < R; r += kWarps) {
    const float* qr = qg + (size_t)r * n;
    float rd = 0.f, rdP = 0.f, rdA = 0.f, rdQ = 0.f, dxn = 0.f, cd1 = 0.f,
          cp1 = 0.f, qdx = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float di = Dinv[j];
      const float px = T2[r * Sn + j], aty = Rr[r * Sn + j];
      const float qj = __ldg(qr + j), dxj = Xi[r * Sn + j];
      rd = fmaxf(rd, fabsf(di * ((px + qj) + aty)));
      rdP = fmaxf(rdP, fabsf(di * px));
      rdA = fmaxf(rdA, fabsf(di * aty));
      rdQ = fmaxf(rdQ, fabsf(di * qj));
      dxn = fmaxf(dxn, fabsf(dxj / di));
      cd1 = fmaxf(cd1, fabsf(di * T3[r * Sn + j]));
      cp1 = fmaxf(cp1, fabsf(di * T4[r * Sn + j]));
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
      const float ax = T1[r * Sm + i], zz = Zs[r * Sm + i];
      rp = fmaxf(rp, fabsf(ei * (ax - zz)));
      rpa = fmaxf(rpa, fabsf(ei * ax));
      rpz = fmaxf(rpz, fabsf(ei * zz));
      const float dy = Yi[r * Sm + i];
      const float edy = Ev[i] * dy;
      dyn = fmaxf(dyn, fabsf(edy));
      const float uu = __ldg(ug + (size_t)r * m + i);
      const float ll = __ldg(lg + (size_t)r * m + i);
      const bool u_open = uu >= kInf * 0.5f, l_open = ll <= -kInf * 0.5f;
      const float u_fin = u_open ? 0.f : uu * ei;
      const float l_fin = l_open ? 0.f : ll * ei;
      sup += u_fin * fmaxf(edy, 0.f) + l_fin * fminf(edy, 0.f);
      open_dir = open_dir || (dy > 1e-12f && u_open) || (dy < -1e-12f && l_open);
      const float adx = ei * Zi[r * Sm + i];
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
      s_rp[r] = rp;
      s_rd[r] = rd;
      const float ratio =
          sqrtf((rp / fmaxf(rp_den, 1e-10f)) /
                fmaxf(rd / fmaxf(rd_den, 1e-10f), 1e-10f));
      s_logr[r] = dn ? 0.f : logf(fminf(fmaxf(ratio, 1e-6f), 1e6f));
    }
  }
  __syncthreads();

  for (int e = tid; e < R * n; e += kThreads)
    p.x[(size_t)b0 * n + e] = Xs[(e / n) * Sn + e % n];
  for (int e = tid; e < R * m; e += kThreads) {
    const int o = (e / m) * Sm + e % m;
    p.z[(size_t)b0 * m + e] = Zs[o];
    p.y[(size_t)b0 * m + e] = Ys[o];
  }
  if (tid < R) {
    const int b = b0 + tid;
    p.done[b] = s_done[tid];
    p.ost[b] = s_status[tid];
    p.itvec[b] = s_itvec[tid];
    p.orp[b] = s_rp[tid];
    p.ord[b] = s_rd[tid];
    p.logr[b] = s_logr[tid];
  }
}

// The chunk-wide decision after an interval, one block per chunk, sums in
// a fixed order.  Also brings the chunk's iteration counts up to date.
__global__ void __launch_bounds__(kThreads) decide_kernel(const Params p) {
  __shared__ float s_sum[kThreads];
  __shared__ int s_act[kThreads];
  const int c = blockIdx.x, tid = threadIdx.x;
  int* cs = p.cs + (size_t)c * kStateWords;
  if (!cs[kRunning]) {
    if (tid == 0) cs[kChange] = 0;
    return;
  }
  const int it = cs[kIt] + p.check_interval;
  const size_t b0 = (size_t)c * p.chunk;
  float sum = 0.f;
  int act = 0;
  for (int r = tid; r < p.chunk; r += kThreads) {
    const size_t b = b0 + r;
    const int d = p.done[b];
    act += !d;
    sum += p.logr[b];
    p.oit[b] = d ? p.itvec[b] : it;
  }
  s_sum[tid] = sum;
  s_act[tid] = act;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (tid < o) {
      s_sum[tid] += s_sum[tid + o];
      s_act[tid] += s_act[tid + o];
    }
    __syncthreads();
  }
  if (tid != 0) return;
  const int n_act = s_act[0];
  float scale = __int_as_float(cs[kScale]);
  int change = 0;
  if (p.adaptive) {
    const float comb = expf(s_sum[0] / fmaxf((float)n_act, 1.f));
    bool ch = (comb > p.rho_tol || comb < (float)(1.0 / (double)p.rho_tol)) &&
              n_act > 0;
    if (p.adapt_until > 0) ch = ch && (it <= p.adapt_until);
    const float step = fminf(fmaxf(ch ? comb : 1.f, 0.1f), 10.f);
    scale = fminf(fmaxf(scale * step, 1e-6f), 1e6f);
    change = ch;
  }
  const int running = n_act > 0 && it < p.max_iter;
  // a chunk that stops needs no new factorization: its state is final
  change = change && running;
  cs[kScale] = __float_as_int(scale);
  cs[kIt] = it;
  cs[kRunning] = running;
  cs[kChange] = change;
  if (change) {
    const int sel = cs[kSel];
    const int start = sel == 0 ? 1 : 0;
    cs[kPrev] = sel;
    cs[kStart] = start;
    cs[kSel] = start ^ (p.ns_adapt_iters & 1);
  }
  if (running) atomicOr(p.flags, 1);
  if (change) atomicOr(p.flags + 1, 1);
}

// One product of a chunk's refactorization, for every chunk that changed
// rho (grid: output tiles x chunks):
//   mode 0: M = (P + sigma I) + (A' diag(rho0 scale)) A
//   mode 1: T = M X_old
//   mode 2: T = 2 I - M X_step
//   mode 3: X_step+1 = X_step T
// The n x n matrices have row stride ldn = n rounded up to 4, their padding
// columns written as zeros.  A block takes a 32 x 32 output tile: its 32
// rows of the left factor and 32 columns of the right one over the whole k
// range arrive at once by 16-byte cp.async (one L2 round trip), then each
// thread sums 2 x 2 outputs in k order.
__host__ __device__ inline size_t gemm_smem_words(int K) {
  return (size_t)kGt * (round4(K) + 4) + (size_t)K * (kGt + 4) + round4(K);
}

__global__ void __launch_bounds__(kThreads)
    refactor_gemm_kernel(const Params p, int mode, int step) {
  extern __shared__ __align__(16) float gsm[];
  const int c = blockIdx.y;
  const int* cs = p.cs + (size_t)c * kStateWords;
  if (!cs[kChange]) return;
  const int n = p.n, m = p.m, ldn = round4(n);
  const size_t nn = (size_t)n * ldn;
  float* scr = p.scratch + (size_t)c * 4 * nn;
  float* Mb = scr;
  float* Tb = scr + 3 * nn;
  const int start = cs[kStart], prev = cs[kPrev];
  float* Xk = scr + (1 + (start ^ (step & 1))) * nn;
  float* Xk1 = scr + (1 + (start ^ ((step + 1) & 1))) * nn;
  const float* Xold = prev < 0 ? p.Minv0 : scr + (1 + prev) * nn;
  const float scale = __int_as_float(cs[kScale]);
  const float* A = mode == 0 ? p.At : (mode == 3 ? Xk : Mb);
  const float* Bm = mode == 0 ? p.As : (mode == 1 ? Xold : (mode == 2 ? Xk : Tb));
  float* C = mode == 0 ? Mb : (mode == 3 ? Xk1 : Tb);
  const int K = mode == 0 ? m : n;
  const int lda = round4(K);  // At: round4(m); the n x n factors: ldn
  const int tiles = (n + kGt - 1) / kGt;
  const int i0 = (blockIdx.x / tiles) * kGt, j0 = (blockIdx.x % tiles) * kGt;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int sa = lda + 4;           // sA row stride
  constexpr int sb = kGt + 4;       // sB row stride
  float* sA = gsm;                  // kGt x sa: rows i0.. of A, all k
  float* sB = sA + kGt * sa;        // K x sb: columns j0.. of B, all k
  float* rs = sB + (size_t)K * sb;  // K: rho0 * scale (mode 0)
  const int qa = lda / 4;
  for (int e = tid; e < kGt * qa; e += kThreads) {
    const int r = e / qa, q = e % qa;
    const int i = i0 + r;
    cp_async16(sA + r * sa + 4 * q, A + (size_t)(i < n ? i : 0) * lda + 4 * q,
               i < n);
  }
  for (int e = tid; e < K * (kGt / 4); e += kThreads) {
    const int k = e / (kGt / 4), q = e % (kGt / 4);
    const int j = j0 + 4 * q;
    cp_async16(sB + k * sb + 4 * q, Bm + (size_t)k * ldn + (j < ldn ? j : 0),
               j < ldn);
  }
  cp_async_commit();
  if (mode == 0)
    for (int k = tid; k < K; k += kThreads) rs[k] = p.rho0[k] * scale;
  cp_async_wait<0>();
  __syncthreads();
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const float* a0 = sA + (2 * ty) * sa;
  const float* a1 = a0 + sa;
  for (int k = 0; k < K; ++k) {
    float x0 = a0[k], x1 = a1[k];
    if (mode == 0) {
      x0 *= rs[k];
      x1 *= rs[k];
    }
    const float y0 = sB[k * sb + 2 * tx], y1 = sB[k * sb + 2 * tx + 1];
    acc[0][0] = fmaf(x0, y0, acc[0][0]);
    acc[0][1] = fmaf(x0, y1, acc[0][1]);
    acc[1][0] = fmaf(x1, y0, acc[1][0]);
    acc[1][1] = fmaf(x1, y1, acc[1][1]);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + 2 * ty + a, j = j0 + 2 * tx + b;
      if (i >= n || j >= ldn) continue;
      const size_t o = (size_t)i * ldn + j;
      float v = acc[a][b];
      if (j >= n) v = 0.f;
      else if (mode == 0) v = (p.Ps[o] + (i == j ? p.sigma : 0.f)) + v;
      else if (mode == 2) v = (i == j ? 2.f : 0.f) - v;
      C[o] = v;
    }
}

// The spectral rescale of a changed chunk's old inverse, one block per
// chunk: X_start = X_old / max(||T||_inf, 1) with T = M X_old.  A warp sums
// a row (lanes in a fixed order, then a fixed tree); the maximum over the
// rows does not depend on order.
__global__ void __launch_bounds__(kThreads) rescale_kernel(const Params p) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int* cs = p.cs + (size_t)c * kStateWords;
  if (!cs[kChange]) return;
  const int n = p.n, ldn = round4(n);
  const size_t nn = (size_t)n * ldn;
  float* scr = p.scratch + (size_t)c * 4 * nn;
  const int start = cs[kStart], prev = cs[kPrev];
  const float* Xold = prev < 0 ? p.Minv0 : scr + (1 + prev) * nn;
  const float* Tb = scr + 3 * nn;
  float* X0 = scr + (1 + start) * nn;
  float rmax = 0.f;
  for (int i = warp; i < n; i += kWarps) {
    float s = 0.f;
    for (int j = lane; j < n; j += 32) s += fabsf(Tb[(size_t)i * ldn + j]);
    rmax = fmaxf(rmax, warp_sum(s));
  }
  if (lane == 0) red[warp] = rmax;
  __syncthreads();
  float den = 0.f;
  for (int w = 0; w < kWarps; ++w) den = fmaxf(den, red[w]);
  den = fmaxf(den, 1.f);
  for (size_t e = tid; e < nn; e += kThreads) X0[e] = Xold[e] / den;
}

// Per-instance results and every chunk's control state before the loop.
__global__ void init_kernel(const Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < p.B) {
    p.done[b] = 0;
    p.itvec[b] = 0;
    p.logr[b] = 0.f;
    p.oit[b] = 0;
    p.ost[b] = 0;
    p.orp[b] = kInf;
    p.ord[b] = kInf;
  }
  if (b < p.B / p.chunk) {
    int* cs = p.cs + (size_t)b * kStateWords;
    cs[kScale] = __float_as_int(1.0f);
    cs[kIt] = 0;
    cs[kRunning] = p.max_iter > 0;
    cs[kChange] = 0;
    cs[kSel] = -1;
    cs[kPrev] = -1;
    cs[kStart] = 0;
  }
}

template <int R>
cudaError_t launch_iterate(const Params& p, cudaStream_t s) {
  const size_t smem = 4 * smem_words(R, p.n, p.m);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      iterate_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  iterate_kernel<R><<<p.B / R, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t iterate(const Params& p, int rows, cudaStream_t s) {
  switch (rows) {
    case 16: return launch_iterate<16>(p, s);
    case 8: return launch_iterate<8>(p, s);
    case 4: return launch_iterate<4>(p, s);
    case 2: return launch_iterate<2>(p, s);
    case 1: return launch_iterate<1>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Runs kernel K1 on `stream`: the host loop over check intervals, which
// reads two flags after each; returns the CUDA error code (0 = success) and
// the number of kernel launches in *launches.
extern "C" int admm_shared_solve_f32(
    const float* Ps, const float* As, const float* At, const float* M0,
    const float* Minv0, const float* rho0, const float* D, const float* E,
    float c_inv, const float* q, const float* l, const float* u,
    const float* x0, const float* z0, const float* y0, float* ox, float* oz,
    float* oy, int* oit, int* ost, float* orp, float* ord, int* work_i,
    float* work_f, int* cs, int* flags, float* scratch, int B, int n, int m,
    int chunk, int cta_rows, float sigma, float alpha,
    float eps_abs, float eps_rel, float rho_tol, int check_interval,
    int max_iter, int ns_adapt_iters, int adaptive, int kkt_refine,
    int adapt_until, void* stream, int* launches) {
  *launches = 0;
  if (chunk <= 0 || B % chunk != 0 || cta_rows <= 0 || chunk % cta_rows != 0 ||
      n <= 0 || m <= 0 || check_interval <= 0 || ns_adapt_iters < 0 ||
      B / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  if (4 * smem_words(cta_rows, n, m) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  Params p{Ps, As, At, M0, Minv0, rho0, D, E, c_inv, q, l, u, ox, oz, oy,
           oit, ost, orp, ord, work_i, work_i + B, work_f, cs, flags,
           scratch, B, n, m, chunk, sigma, alpha, eps_abs, eps_rel, rho_tol,
           check_interval, max_iter, ns_adapt_iters, adaptive, kkt_refine,
           adapt_until};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bn = (size_t)B * n * sizeof(float);
  const size_t bm = (size_t)B * m * sizeof(float);
  cudaError_t err;
  if ((err = cudaMemcpyAsync(ox, x0, bn, cudaMemcpyDeviceToDevice, s)) ||
      (err = cudaMemcpyAsync(oz, z0, bm, cudaMemcpyDeviceToDevice, s)) ||
      (err = cudaMemcpyAsync(oy, y0, bm, cudaMemcpyDeviceToDevice, s)))
    return (int)err;
  const int nc = B / chunk;
  init_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(p);
  if ((err = cudaGetLastError())) return (int)err;
  int nl = 1;
  const int tiles = (n + kGt - 1) / kGt;
  const dim3 ggrid(tiles * tiles, nc);
  const size_t smem_m = 4 * gemm_smem_words(m), smem_n = 4 * gemm_smem_words(n);
  if ((smem_m > smem_n ? smem_m : smem_n) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(refactor_gemm_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)(smem_m > smem_n ? smem_m : smem_n))))
    return (int)err;
  while (max_iter > 0) {
    if ((err = iterate(p, cta_rows, s))) return (int)err;
    if ((err = cudaMemsetAsync(flags, 0, 2 * sizeof(int), s))) return (int)err;
    decide_kernel<<<nc, kThreads, 0, s>>>(p);
    if ((err = cudaGetLastError())) return (int)err;
    nl += 2;
    int h[2];
    if ((err = cudaMemcpyAsync(h, flags, sizeof(h), cudaMemcpyDeviceToHost,
                               s)) ||
        (err = cudaStreamSynchronize(s)))
      return (int)err;
    if (!h[0]) break;
    if (!h[1]) continue;
    refactor_gemm_kernel<<<ggrid, kThreads, smem_m, s>>>(p, 0, 0);
    refactor_gemm_kernel<<<ggrid, kThreads, smem_n, s>>>(p, 1, 0);
    rescale_kernel<<<nc, kThreads, 0, s>>>(p);
    if ((err = cudaGetLastError())) return (int)err;
    nl += 3;
    for (int k = 0; k < ns_adapt_iters; ++k) {
      refactor_gemm_kernel<<<ggrid, kThreads, smem_n, s>>>(p, 2, k);
      refactor_gemm_kernel<<<ggrid, kThreads, smem_n, s>>>(p, 3, k);
      if ((err = cudaGetLastError())) return (int)err;
      nl += 2;
    }
  }
  *launches = nl;
  return 0;
}
