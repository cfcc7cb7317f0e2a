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
// The block of `blk` instances (pick_full_block: 8 at the MPC shape n=222,
// m=252, 16 at the portfolio shape n=130, m=172) is part of the answer,
// because the rescue and the refactorization act on the whole block: it is
// one thread-block cluster, and the block's decisions (exit, refactor,
// rescue) are ORs over the cluster through distributed shared memory.
// Control flow is uniform over the cluster: every instance runs every
// factorization step and every iteration of the block (a finished instance
// is frozen by a blend), so cluster barriers may sit anywhere on that path.
//
// Two phases, and what bounds each:
//  - The factorization: n^2 m multiply-adds to form M, 2 n^3 per
//    Newton-Schulz sweep (16 cold by default, ns_adapt_iters warm after
//    each rho change, max(ns_iters, 30) in a rescue) and n^3 for each
//    certificate ||I - M X||: about 0.75 GFLOP per instance at the MPC
//    shape, operations-bound.  All of these products run on the tensor
//    cores (mma_tf32.cuh: wgmma m64n112k8 with the three-pass TF32 split,
//    float32 accumulation, 128 x 112 tiles over two warpgroups), operands
//    streamed from global memory (L2) through a three-stage cp.async ring
//    and split into TF32 parts in shared memory once per element.  Each instance's products
//    are split by output rows over the c blocks that hold it (below), with
//    a barrier between dependent products.  The TPU kernel runs its first
//    ns_iters - ns_f32_iters cold sweeps in a bf16 pass and the rest at
//    float32; here every sweep takes the three-pass split, whose
//    certificate on the MPC matrices stays within 2x of float32 sweeps'.
//  - The iterations: 2 m n + (1 + 2 kkt_refine) n^2 multiply-adds per
//    instance and iteration, one per matrix element read.  The resident
//    layout (c x blk <= 16, Hopper's largest cluster) keeps each instance's
//    M^-1 and A in the shared memory of a team of c blocks, split by rows
//    (c the smallest of 1, 2, 4, 8 that fits: 2 at the MPC shape, 1 at the
//    portfolio shape), copied in once after every factorization, as K3
//    (admm_iterate.cu) does; A' v comes from the resident A (partials over
//    each block's rows added in team-rank order through distributed shared
//    memory), and only the refinement's M x~ and the checks' P x stream
//    from global memory (M stays in L2: per instance 197 KB at the MPC
//    shape, against 1.04 MB per iteration read by the streaming layout).
//    The refinement's other form, (P + sigma I) x~ + A' (rho A x~) from P
//    and the resident A, was not built: which is faster is not measured.
//    What bounds it now: shared-memory bandwidth and the team barriers
//    (two per iteration, two more per refinement sweep).  The tile buffers
//    of the factorization alias the matrix region, which is free while a
//    factorization runs.  The streaming layout (c x blk > 16, or no c fits)
//    keeps the first design's iterations: min(blk, 16) blocks of blk / 16
//    instances or one, each instance's P, A, M and M^-1 read from global
//    memory every iteration, only its vectors in shared memory.
//  - Full float32 FMA outside the tensor-core products, no fast math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mma_tf32.cuh"

namespace {

using namespace cvxk;
namespace cg = cooperative_groups;

constexpr float kInf = 1e30f;
constexpr float kEpsInf = 1e-4f;
constexpr float kRescueGate = 0.05f;
constexpr size_t kSmemLimit = 232448;
constexpr int kScalars = 9;  // per-instance scalar words
constexpr int kClusterMax = 16;  // Hopper's largest (non-portable) cluster
constexpr int kStats = 16;       // the checks' partial reductions

struct Params {
  const float* Ps;    // (B, n, n) scaled P
  const float* As;    // (B, m, n) scaled A
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
  float* ocert;       // (B,) or null: ||I - M X|| after the cold sweeps
  float* scratch;     // (B, 4, n, n): M, two M^-1 buffers, a temporary
  int n, m, per, ctas;  // per: instances of a streaming block; ctas: team
  float sigma, alpha, eps_abs, eps_rel, rho_tol;
  int check_interval, max_iter, ns_iters, ns_f32_iters, ns_adapt_iters,
      adaptive, kkt_refine, adapt_until;
};

// 4-byte words of dynamic shared memory of the streaming layout for a
// thread block of `per` instances (full_smem_bytes in the Python wrapper
// mirrors this formula)
size_t stream_words(int per, int n, int m) {
  return (size_t)kWgWords + (size_t)per * (3 * n + 6 * m + kScalars) +
         7 * n + 7 * m + kThreads;
}

// the resident layout's region: the block's rows of M^-1 and A while it
// iterates, the tile stages while it factors
__host__ __device__ size_t region_words(int n, int m, int c) {
  const Rows kr = team_rows(n, c, 0), ir = team_rows(m, c, 0);
  const size_t mat =
      slice_words(kr.hi - kr.lo, n) + slice_words(ir.hi - ir.lo, n);
  return mat > (size_t)kWgWords ? mat : (size_t)kWgWords;
}

// 4-byte words of dynamic shared memory of the resident layout for a team
// of c blocks (full_smem_bytes mirrors it): the region, 12 n-vectors, rho0
// (m), 12 vectors on the block's rows of A, the block reduction, the
// checks' partials and the scalars
size_t resident_words(int n, int m, int c) {
  const Rows ir = team_rows(m, c, 0);
  return region_words(n, m, c) + (size_t)12 * n + m +
         (size_t)12 * (ir.hi - ir.lo) + kThreads + kStats + kScalars;
}

// max that keeps a NaN (jnp.max propagates it; fmaxf would drop it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (b != b || b > a) ? b : a;
}

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
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

// The c thread blocks of a cluster that hold one instance; this block
// computes rows [r0, r1) of the instance's n x n products.  sync() is a
// barrier over the team (team_bar_sync on the team's mbarriers) when c > 1,
// else a block barrier; every block of the team reaches each call.
struct Team {
  int c, base, rank, r0, r1;
  unsigned long long* bar;
  mutable unsigned phase;
  __device__ void sync() const {
    if (c > 1)
      team_bar_sync(bar, phase, base, c);
    else
      __syncthreads();
  }
};

__device__ Team make_team(int c, int crank, int n, unsigned long long* bar) {
  const Rows kr = team_rows(n, c, crank % c);
  return Team{c, crank - crank % c, crank % c, kr.lo, kr.hi, bar, 0u};
}

// max over the team of v (NaN kept), combined in rank order; `slot` is a
// __shared__ word
__device__ float team_max(const Team& tm, float v, float* slot) {
  if (tm.c == 1) return v;
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  tm.sync();
  float r = *cl.map_shared_rank(slot, tm.base);
  for (int k = 1; k < tm.c; ++k)
    r = nanmax(r, *cl.map_shared_rank(slot, tm.base + k));
  tm.sync();
  return r;
}

// one instance's factorization buffers in global memory and its inputs
struct Fac {
  float* M;
  float* X[2];
  float* T;
  const float* P;
  const float* A;
};

__device__ Fac fac_of(const Params& p, size_t b) {
  const size_t nn = (size_t)p.n * p.n;
  float* base = p.scratch + b * 4 * nn;
  return Fac{base, {base + nn, base + 2 * nn}, base + 3 * nn, p.Ps + b * nn,
             p.As + b * (size_t)p.m * p.n};
}

// this block's rows of M = P + sigma I + A' diag(rho0 * sc) A
__device__ void form_M(const Fac& f, const Team& tm, int n, int m,
                       const float* rho0, float sc, float sigma,
                       float* tiles) {
  wg_gemm<true>(f.A, n, rho0, sc, f.A, n, tm.r0, tm.r1, n, m, tiles,
                 [&](int i, int j, float acc) {
                   f.M[(size_t)i * n + j] =
                       (f.P[(size_t)i * n + j] + (i == j ? sigma : 0.f)) + acc;
                 });
}

// this block's rows of X0 = diag(M)^-1 / max(max_i sum_j |M_ij / M_jj|, 1);
// every block of the team takes the scale over all of M, the same way, so
// no barrier across the team is needed (the rescue calls it for some
// instances only).  M visible on entry; ends with a block barrier.
__device__ void diag_start(const Fac& f, float* X, const Team& tm, int n,
                           float* tmp, float* red) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int j = tid; j < n; j += kThreads)
    tmp[j] = 1.0f / fmaxf(f.M[(size_t)j * n + j], 1e-12f);
  __syncthreads();
  float rmax = 0.f;
  for (int i = warp; i < n; i += kWarps) {
    float s = 0.f;
    for (int j = lane; j < n; j += 32) s += fabsf(f.M[(size_t)i * n + j] * tmp[j]);
    rmax = nanmax(rmax, warp_sum(s));
  }
  const float den = fmaxf(block_max(rmax, red), 1.0f);
  for (size_t e = (size_t)tm.r0 * n + tid; e < (size_t)tm.r1 * n;
       e += kThreads) {
    const int i = (int)(e / n), j = (int)(e % n);
    X[e] = (i == j) ? tmp[j] / den : 0.f;
  }
  __syncthreads();
}

// `iters` Newton-Schulz sweeps X <- X (2I - M X), X = f.X[*sel], each
// product split by rows over the team; every row of X visible on entry.
// Ends with a team barrier, *sel naming the newest iterate.
__device__ void ns_sweeps(const Fac& f, int* sel, int iters, const Team& tm,
                          int n, float* tiles) {
  for (int s = 0; s < iters; ++s) {
    const float* X = f.X[*sel];
    float* Xn = f.X[1 - *sel];
    wg_gemm<false>(f.M, n, nullptr, 1.f, X, n, tm.r0, tm.r1, n, n, tiles,
                    [&](int i, int j, float acc) {
                      f.T[(size_t)i * n + j] = (i == j ? 2.f : 0.f) - acc;
                    });
    tm.sync();
    wg_gemm<false>(X, n, nullptr, 1.f, f.T, n, tm.r0, tm.r1, n, n, tiles,
                    [&](int i, int j, float acc) { Xn[(size_t)i * n + j] = acc; });
    if (threadIdx.x == 0) *sel = 1 - *sel;
    tm.sync();
  }
}

// ||I - M X||_inf (entrywise) over the team, NaN kept
__device__ float cert(const Fac& f, const float* X, const Team& tm, int n,
                      float* tiles, float* red, float* slot) {
  float emax = 0.f;
  wg_gemm<false>(f.M, n, nullptr, 1.f, X, n, tm.r0, tm.r1, n, n, tiles,
                  [&](int i, int j, float acc) {
                    emax = nanmax(emax, fabsf((i == j ? 1.f : 0.f) - acc));
                  });
  return team_max(tm, block_max(emax, red), slot);
}

// the warm restart's rescale X <- X / max(||M X||_inf, 1) over the team;
// every row of X visible on entry, ends with a team barrier
__device__ void warm_scale(const Fac& f, float* X, const Team& tm, int n,
                           float* tiles, float* red, float* slot) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  wg_gemm<false>(f.M, n, nullptr, 1.f, X, n, tm.r0, tm.r1, n, n, tiles,
                  [&](int i, int j, float acc) { f.T[(size_t)i * n + j] = acc; });
  float rmax = 0.f;
  for (int i = tm.r0 + warp; i < tm.r1; i += kWarps) {
    float s = 0.f;
    for (int j = lane; j < n; j += 32) s += fabsf(f.T[(size_t)i * n + j]);
    rmax = nanmax(rmax, warp_sum(s));
  }
  const float den = fmaxf(team_max(tm, block_max(rmax, red), slot), 1.0f);
  for (size_t e = (size_t)tm.r0 * n + tid; e < (size_t)tm.r1 * n;
       e += kThreads)
    X[e] = X[e] / den;
  tm.sync();
}

// y_v(i) = sum_j W(i, j) x_v(j) for rows lo <= i < hi of W (row stride K,
// global memory) and NV vectors x_v = x + v ldx in shared memory; epi(i, y)
// on lane 0 with y the NV sums.  One warp per row, four rows at a time,
// each lane issuing its loads of the four rows (eight per row per pass)
// before it uses them: the reads wait on L2, not on the arithmetic.  RO
// marks W read-only for the whole kernel (the non-coherent load path).  No
// barrier.
template <int NV, bool RO, typename Epi>
__device__ __forceinline__ void growdot(const float* W, int K,
                                        const float* x, int ldx, int lo,
                                        int hi, Epi epi) {
  constexpr int kR = 4, kU = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i0 = lo + warp; i0 < hi; i0 += kR * kWarps) {
    float acc[kR][NV];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[r][v] = 0.f;
    for (int j0 = 0; j0 < K; j0 += 32 * kU) {
      float w[kR][kU];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int i = i0 + r * kWarps, j = j0 + lane + 32 * u;
          w[r][u] = (i < hi && j < K) ? load_w<RO>(W + (size_t)i * K + j)
                                      : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = j0 + lane + 32 * u;
        if (j < K)
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const float xj = x[v * ldx + j];
#pragma unroll
            for (int r = 0; r < kR; ++r) acc[r][v] = fmaf(w[r][u], xj, acc[r][v]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[r][v] = warp_sum(acc[r][v]);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (i0 + r * kWarps < hi) epi(i0 + r * kWarps, acc[r]);
  }
}

// the block's rescue: where any instance fails the 0.05 certificate gate
// (an OR over the cluster), the failing ones restart from the diagonal
// start and every instance of the block runs max(ns_iters, 30) more sweeps.
// With `cold` the certificates go to p.ocert.
__device__ void rescue(const Params& p, const Fac* fs, int per, int* s_sel,
                       int* s_bad, const Team& tm, float* tiles, float* tmp,
                       float* red, float* fslot, int* slot, int* res,
                       size_t b0, bool cold) {
  const int n = p.n;
  for (int r = 0; r < per; ++r) {
    const float err = cert(fs[r], fs[r].X[s_sel[r]], tm, n, tiles, red, fslot);
    if (threadIdx.x == 0) {
      s_bad[r] = !(err < kRescueGate);
      if (cold && p.ocert && tm.rank == 0) p.ocert[b0 + r] = err;
    }
  }
  __syncthreads();
  int any = 0;
  if (threadIdx.x == 0)
    for (int r = 0; r < per; ++r) any |= s_bad[r];
  if (!cluster_or(any, slot, res)) return;
  for (int r = 0; r < per; ++r)
    if (s_bad[r]) diag_start(fs[r], fs[r].X[s_sel[r]], tm, n, tmp, red);
  tm.sync();
  const int iters = p.ns_iters > 30 ? p.ns_iters : 30;
  for (int r = 0; r < per; ++r) ns_sweeps(fs[r], &s_sel[r], iters, tm, n, tiles);
}

// ---------------------------------------------------------------------------
// the resident layout: one team of c blocks per instance, blk teams per
// cluster
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) full_resident_kernel(
    const Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = p.n, m = p.m, c = p.ctas;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  __shared__ unsigned long long s_tbar;  // the team's barrier
  team_bar_init(&s_tbar, c);
  const Team tm = make_team(c, (int)cl.block_rank(), n, &s_tbar);
  cl.sync();  // every barrier of the cluster is set up before its first use
  const size_t b = blockIdx.x / c;
  const Rows ir = team_rows(m, c, tm.rank);
  const int nk = tm.r1 - tm.r0, ni = ir.hi - ir.lo;
  const int rm = team_rows(m, c, 0).hi;  // rows of A of the team's first block
  const Fac f = fac_of(p, b);

  float* tiles = smem;
  float* mbuf = smem;
  float* abuf = mbuf + slice_words(team_rows(n, c, 0).hi, n);
  float* X = smem + region_words(n, m, c);  // n: x
  float* Q = X + n;                         // n
  float* Dv = Q + n;                        // n: D
  float* Dinv = Dv + n;                     // n
  float* XX = Dinv + n;                     // 2n: iterate x; then [x; dx]
  float* Rhs = XX + 2 * n;                  // n
  float* Xt = Rhs + n;                      // n: x~, every row
  float* Part = Xt + n;  // 2n: partial A'v, then the residual; [A'y; A'dy]
  float* Res = Part + n;
  float* TN = Part + 2 * n;  // 2n: [Px; Pdx] on this block's rows
  float* R0 = TN + 2 * n;    // m: rho0, every row (the factor scales by it)
  float* Z = R0 + m;         // rm each: this block's rows of A
  float* Y = Z + rm;
  float* L = Y + rm;
  float* U = L + rm;
  float* Ev = U + rm;
  float* Zi = Ev + rm;      // iterate z
  float* YY = Zi + rm;      // 2 rm: iterate y; then [y; dy]
  float* TM = YY + 2 * rm;  // 2 rm: v, z~; then [Ax; Adx]
  float* Rho = TM + 2 * rm;
  float* Einv = Rho + rm;
  float* red = Einv + rm;       // kThreads
  float* stat = red + kThreads;  // kStats: this block's partial checks
  float* s_f = stat + kStats;    // scale, rp, rd
  int* s_i = (int*)(s_f + 3);    // done, status, itvec, change, bad, sel
  float& s_scale = s_f[0];
  float& s_rp = s_f[1];
  float& s_rd = s_f[2];
  int& s_done = s_i[0];
  int& s_status = s_i[1];
  int& s_itvec = s_i[2];
  int& s_change = s_i[3];
  int* s_bad = s_i + 4;
  int* s_sel = s_i + 5;
  __shared__ int s_slot, s_res;
  __shared__ float s_fslot;
  const float sigma = p.sigma, alpha = p.alpha;

  for (int j = tid; j < n; j += kThreads) {
    X[j] = p.x0[b * n + j];
    Q[j] = p.q[b * n + j];
    Dv[j] = p.D[b * n + j];
  }
  for (int i = tid; i < m; i += kThreads) R0[i] = p.rho0[b * m + i];
  for (int i = tid; i < ni; i += kThreads) {
    const size_t g = b * m + ir.lo + i;
    Z[i] = p.z0[g];
    Y[i] = p.y0[g];
    L[i] = p.l[g];
    U[i] = p.u[g];
    Ev[i] = p.E[g];
  }
  if (tid == 0) {
    s_scale = 1.0f;
    s_rp = kInf;
    s_rd = kInf;
    s_done = 0;
    s_status = 0;
    s_itvec = 0;
    *s_sel = 0;
  }
  __syncthreads();

  // ---- cold factorization ----
  form_M(f, tm, n, m, R0, 1.0f, sigma, tiles);
  tm.sync();
  diag_start(f, f.X[0], tm, n, Rhs, red);
  tm.sync();
  ns_sweeps(f, s_sel, p.ns_iters, tm, n, tiles);
  if (p.ns_iters > p.ns_f32_iters)
    rescue(p, &f, 1, s_sel, s_bad, tm, tiles, Rhs, red, &s_fslot, &s_slot,
           &s_res, b, true);
  bool resident = false;
  const float* Ms = nullptr;
  const float* As = nullptr;

  int it = 0;
  bool go = p.max_iter > 0;
  while (go) {
    const int it_new = it + p.check_interval;
    if (!resident) {
      // this block's rows of the current M^-1 and of A, once per
      // factorization (they overwrite the tile stages)
      Ms = load_slice(mbuf, f.X[*s_sel] + (size_t)tm.r0 * n, nk * n);
      As = load_slice(abuf, f.A + (size_t)ir.lo * n, ni * n);
      cp_async_wait_all();
      resident = true;
    }
    const float sc = s_scale;
    const float cinv = p.cinv[b];
    for (int i = tid; i < ni; i += kThreads) {
      Rho[i] = R0[ir.lo + i] * sc;
      Einv[i] = 1.0f / Ev[i];
      Zi[i] = Z[i];
      YY[i] = Y[i];
    }
    for (int j = tid; j < n; j += kThreads) {
      Dinv[j] = 1.0f / Dv[j];
      XX[j] = X[j];
    }
    __syncthreads();

    // ---- check_interval iterations ----
    float* V = TM;
    for (int t = 0; t < p.check_interval; ++t) {
      for (int i = tid; i < ni; i += kThreads) V[i] = Rho[i] * Zi[i] - YY[i];
      __syncthreads();
      scolsum<1>(As, n, V, 0, ni, n, Part, 0);
      tm.sync();
      for (int j = tid; j < n; j += kThreads)
        Rhs[j] = (sigma * XX[j] - Q[j]) + team_sum(Part, j, tm.base, c);
      __syncthreads();
      srowdot(Ms, n, Rhs, nk, n, [&](int k, float acc) {
        team_put(Xt, tm.r0 + k, acc, tm.base, c);
      });
      tm.sync();
      for (int s = 0; s < p.kkt_refine; ++s) {
        // this block's rows of rhs - M x~ (M from global memory, where the
        // factorization wrote it), then of x~ += M^-1 (rhs - M x~)
        growdot<1, false>(f.M, n, Xt, 0, tm.r0, tm.r1,
                          [&](int k, const float* acc) {
                            team_put(Res, k, Rhs[k] - acc[0], tm.base, c);
                          });
        tm.sync();
        srowdot(Ms, n, Res, nk, n, [&](int k, float acc) {
          team_put(Xt, tm.r0 + k, Xt[tm.r0 + k] + acc, tm.base, c);
        });
        tm.sync();
      }
      srowdot(As, n, Xt, ni, n, [&](int i, float zt) {
        const float w =
            alpha * zt + (1.0f - alpha) * Zi[i] + (1.0f / Rho[i]) * YY[i];
        const float z1 = fminf(fmaxf(w, L[i]), U[i]);
        Zi[i] = z1;
        YY[i] = Rho[i] * (w - z1);
      });
      for (int j = tid; j < n; j += kThreads)
        XX[j] = alpha * Xt[j] + (1.0f - alpha) * XX[j];
      __syncthreads();
    }

    // ---- freeze blend fmask * old + keep * new, and the deltas ----
    const float fm = s_done ? 1.f : 0.f, keep = 1.f - fm;
    for (int j = tid; j < n; j += kThreads) {
      const float xo = X[j], xn = XX[j];
      const float xb = fm * xo + keep * xn;
      XX[n + j] = keep * (xn - xo);
      XX[j] = xb;
      X[j] = xb;
    }
    for (int i = tid; i < ni; i += kThreads) {
      const float yo = Y[i], yn = YY[i];
      const float yb = fm * yo + keep * yn;
      YY[rm + i] = keep * (yn - yo);
      YY[i] = yb;
      Y[i] = yb;
      Z[i] = fm * Z[i] + keep * Zi[i];
    }
    __syncthreads();

    // ---- residual and certificate products ----
    srowdot(As, n, XX, ni, n, [&](int i, float acc) { TM[i] = acc; });
    srowdot(As, n, XX + n, ni, n, [&](int i, float acc) { TM[rm + i] = acc; });
    scolsum<2>(As, n, YY, rm, ni, n, Part, n);
    growdot<2, true>(f.P, n, XX, n, tm.r0, tm.r1, [&](int k, const float* a) {
      TN[k] = a[0];
      TN[n + k] = a[1];
    });
    tm.sync();

    // ---- this block's partial checks on warp 0: its rows of x and of A ----
    if (warp == 0) {
      float rd = 0.f, rdP = 0.f, rdA = 0.f, rdQ = 0.f, dxn = 0.f, cd1 = 0.f,
            cp1 = 0.f, qdx = 0.f;
      for (int j = tm.r0 + lane; j < tm.r1; j += 32) {
        const float di = Dinv[j];
        const float px = TN[j], qj = Q[j], dxj = XX[n + j];
        const float aty = team_sum(Part, j, tm.base, c);
        const float atdy = team_sum(Part, n + j, tm.base, c);
        rd = fmaxf(rd, fabsf(di * ((px + qj) + aty)));
        rdP = fmaxf(rdP, fabsf(di * px));
        rdA = fmaxf(rdA, fabsf(di * aty));
        rdQ = fmaxf(rdQ, fabsf(di * qj));
        dxn = fmaxf(dxn, fabsf(Dv[j] * dxj));
        cd1 = fmaxf(cd1, fabsf(di * TN[n + j]));
        cp1 = fmaxf(cp1, fabsf(di * atdy));
        qdx += qj * dxj;
      }
      float rp = 0.f, rpa = 0.f, rpz = 0.f, dyn = 0.f, sup = 0.f, odir = 0.f;
      float up = -INFINITY, lo = -INFINITY;
      for (int i = lane; i < ni; i += 32) {
        const float ei = Einv[i];
        const float ax = TM[i], zz = Z[i];
        rp = fmaxf(rp, fabsf(ei * (ax - zz)));
        rpa = fmaxf(rpa, fabsf(ei * ax));
        rpz = fmaxf(rpz, fabsf(ei * zz));
        const float dy = YY[rm + i];
        const float edy = Ev[i] * dy;
        dyn = fmaxf(dyn, fabsf(edy));
        const float uu = U[i], ll = L[i];
        const bool u_open = uu >= kInf * 0.5f, l_open = ll <= -kInf * 0.5f;
        const float u_fin = u_open ? 0.f : uu * ei;
        const float l_fin = l_open ? 0.f : ll * ei;
        sup += u_fin * fmaxf(edy, 0.f) + l_fin * fminf(edy, 0.f);
        if ((dy > 1e-12f && u_open) || (dy < -1e-12f && l_open)) odir = 1.f;
        const float adx = ei * TM[rm + i];
        if (!u_open) up = nanmax(up, adx);
        if (!l_open) lo = nanmax(lo, -adx);
      }
      const float v[kStats] = {
          warp_max(rd),  warp_max(rdP), warp_max(rdA), warp_max(rdQ),
          warp_max(dxn), warp_max(cd1), warp_max(cp1), warp_sum(qdx),
          warp_max(rp),  warp_max(rpa), warp_max(rpz), warp_max(dyn),
          warp_sum(sup), warp_max(odir), warp_nanmax(up), warp_nanmax(lo)};
      if (lane == 0)
        for (int k = 0; k < kStats; ++k) stat[k] = v[k];
    }
    tm.sync();

    // ---- the team's checks, combined in rank order, on thread 0 of each
    // of its blocks (the same arithmetic, hence the same decisions) ----
    if (tid == 0) {
      float a[kStats];
      for (int k = 0; k < kStats; ++k) a[k] = *cl.map_shared_rank(stat + k, tm.base);
      for (int r = 1; r < c; ++r)
        for (int k = 0; k < kStats; ++k) {
          const float v = *cl.map_shared_rank(stat + k, tm.base + r);
          if (k == 7 || k == 12) a[k] += v;
          else if (k >= 14) a[k] = nanmax(a[k], v);
          else a[k] = fmaxf(a[k], v);
        }
      float rd = a[0];
      const float rdP = a[1], rdA = a[2], rdQ = a[3], dxn = a[4], cd1 = a[5],
                  cp1 = a[6], qdx = a[7], rp = a[8], rpa = a[9], rpz = a[10],
                  dyn = a[11], sup = a[12];
      const bool open_dir = a[13] > 0.f;
      const float bar = kEpsInf * dxn;
      const bool box_ok = (a[14] <= bar) && (a[15] <= bar);
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
      if (ok && !s_done) s_itvec = it_new;
      if (s_status == 0) {
        if (ok) s_status = 1;
        else if (p_inf) s_status = -3;
        else if (d_inf) s_status = -4;
      }
      const int dn = s_done | (int)(ok || p_inf || d_inf);
      s_done = dn;
      s_rp = rp;
      s_rd = rd;
      int change = 0;
      if (p.adaptive) {
        const float ratio = sqrtf((rp / fmaxf(rp_den, 1e-10f)) /
                                  fmaxf(rd / fmaxf(rd_den, 1e-10f), 1e-10f));
        bool ch = (ratio > p.rho_tol ||
                   ratio < (float)(1.0 / (double)p.rho_tol)) && !dn;
        if (p.adapt_until > 0) ch = ch && (it_new <= p.adapt_until);
        const float step = fminf(fmaxf(ch ? ratio : 1.f, 0.1f), 10.f);
        s_scale = fminf(fmaxf(s_scale * step, 1e-6f), 1e6f);
        change = ch;
      }
      s_change = change;
    }
    __syncthreads();
    it = it_new;

    // ---- block decisions over the cluster: loop condition (bit 0: an
    // instance is not done) and the refactorization (bit 1: a rho changed)
    int flags = 0;
    if (tid == 0) flags = (s_done ? 0 : 1) | (s_change ? 2 : 0);
    flags = cluster_or(flags, &s_slot, &s_res);
    go = (flags & 1) && it < p.max_iter;
    if (flags & 2) {
      // re-form M at the new scale and warm-restart Newton-Schulz from the
      // current inverse, rescaled by max(||M X||_inf, 1)
      form_M(f, tm, n, m, R0, s_scale, sigma, tiles);
      warm_scale(f, f.X[*s_sel], tm, n, tiles, red, &s_fslot);
      ns_sweeps(f, s_sel, p.ns_adapt_iters, tm, n, tiles);
      rescue(p, &f, 1, s_sel, s_bad, tm, tiles, Rhs, red, &s_fslot, &s_slot,
             &s_res, b, false);
      resident = false;
    }
  }

  // ---- outputs and the objective c^-1 (x'Px / 2 + q'x) ----
  for (int i = tid; i < ni; i += kThreads) {
    p.oz[b * m + ir.lo + i] = Z[i];
    p.oy[b * m + ir.lo + i] = Y[i];
  }
  if (tm.rank == 0) {
    for (int j = tid; j < n; j += kThreads) p.ox[b * n + j] = X[j];
    rowgemm<1, true>(X, n, f.P, n, [&](int, int j, float acc) { TN[j] = acc; });
  }
  __syncthreads();
  if (tm.rank == 0 && warp == 0) {
    float xpx = 0.f, qx = 0.f;
    for (int j = lane; j < n; j += 32) {
      xpx += X[j] * TN[j];
      qx += Q[j] * X[j];
    }
    xpx = warp_sum(xpx);
    qx = warp_sum(qx);
    if (lane == 0) {
      p.oobj[b] = p.cinv[b] * (0.5f * xpx + qx);
      p.oit[b] = s_done ? s_itvec : it;
      p.ost[b] = s_status;
      p.orp[b] = s_rp;
      p.ord[b] = s_rd;
    }
  }
  // no block leaves while a peer may still read its shared memory
  cl.sync();
}

// ---------------------------------------------------------------------------
// the streaming layout: min(blk, 16) blocks of `per` instances each (one
// instance per block up to block 16), every matrix read from global memory
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) full_stream_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m, per = p.per;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t b0 = (size_t)blockIdx.x * per;
  const size_t nn = (size_t)n * n;
  const Team tm{1, 0, 0, 0, n, nullptr, 0u};

  // the tile stages first: cp.async and float4 reads need 16-byte alignment
  float* tiles = smem;
  // state of this thread block's `per` instances, one copy each
  float* Xs = tiles + kWgWords;    // per x n
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
  __shared__ float s_fslot;      // team_max (a team of one here)
  Fac fs[2];  // the instances' buffers (per <= 2: blocks up to 32)

  for (int r = 0; r < per; ++r) fs[r] = fac_of(p, b0 + r);
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

  // ---- cold factorization ----
  for (int r = 0; r < per; ++r) {
    form_M(fs[r], tm, n, m, R0 + r * m, 1.0f, sigma, tiles);
    diag_start(fs[r], fs[r].X[0], tm, n, TN1, red);
    ns_sweeps(fs[r], &s_sel[r], p.ns_iters, tm, n, tiles);
  }
  if (p.ns_iters > p.ns_f32_iters)
    rescue(p, fs, per, s_sel, s_bad, tm, tiles, TN1, red, &s_fslot, &s_slot,
           &s_res, b0, true);

  int it = 0;
  bool go = p.max_iter > 0;
  while (go) {
    const int it_new = it + p.check_interval;
    for (int r = 0; r < per; ++r) {
      const Fac& I = fs[r];
      const float* Ar = I.A;
      const float* Pr = I.P;
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
        rowdot(Ar, Xt, m, n, [&](int i, float acc) { Zt[i] = acc; });
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
      growdot<2, true>(Ar, n, XX, n, 0, m, [&](int i, const float* a) {
        TM[i] = a[0];
        TM[m + i] = a[1];
      });
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
        form_M(fs[r], tm, n, m, R0 + r * m, s_scale[r], sigma, tiles);
        warm_scale(fs[r], fs[r].X[s_sel[r]], tm, n, tiles, red, &s_fslot);
      }
      for (int r = 0; r < per; ++r)
        ns_sweeps(fs[r], &s_sel[r], p.ns_adapt_iters, tm, n, tiles);
      rescue(p, fs, per, s_sel, s_bad, tm, tiles, TN1, red, &s_fslot,
             &s_slot, &s_res, b0, false);
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

template <typename K>
cudaError_t launch(K kernel, const Params& p, int grid, int csize,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (csize > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Launches kernel K2 on `stream`; returns the CUDA error code (0 = success).
// ctas 1, 2, 4 or 8 with ctas * blk <= 16 takes the resident layout (one
// cluster of ctas * blk blocks per block of instances); ctas 0 the
// streaming one (one cluster of min(blk, 16) blocks).  ocert may be null.
extern "C" int admm_full_solve_f32(
    const float* Ps, const float* As, const float* q, const float* l,
    const float* u, const float* rho0, const float* D, const float* E,
    const float* cinv, const float* x0, const float* z0, const float* y0,
    float* ox, float* oz, float* oy, float* oobj, int* oit, int* ost,
    float* orp, float* ord, float* ocert, float* scratch, int B, int n,
    int m, int blk, int ctas, float sigma, float alpha, float eps_abs,
    float eps_rel, float rho_tol, int check_interval, int max_iter,
    int ns_iters, int ns_f32_iters, int ns_adapt_iters, int adaptive,
    int kkt_refine, int adapt_until, void* stream) {
  if (blk <= 0 || B % blk != 0 || n <= 0 || m <= 0 || check_interval <= 0 ||
      ctas < 0 || ctas > kMaxTeam || (ctas & (ctas - 1)))
    return (int)cudaErrorInvalidValue;
  Params p{Ps, As, q, l, u, rho0, D, E, cinv, x0, z0, y0, ox, oz, oy,
           oobj, oit, ost, orp, ord, ocert, scratch, n, m, 1, ctas, sigma,
           alpha, eps_abs, eps_rel, rho_tol, check_interval, max_iter,
           ns_iters, ns_f32_iters, ns_adapt_iters, adaptive, kkt_refine,
           adapt_until};
  if (ctas > 0) {
    if (ctas * blk > kClusterMax) return (int)cudaErrorInvalidValue;
    const size_t smem = 4 * resident_words(n, m, ctas);
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    return (int)launch(full_resident_kernel, p, B * ctas, ctas * blk, smem,
                       (cudaStream_t)stream);
  }
  // the block of blk instances is one cluster of csize thread blocks
  const int csize = blk < kClusterMax ? blk : kClusterMax;
  if (blk % csize != 0 || blk / csize > 2) return (int)cudaErrorInvalidValue;
  p.per = blk / csize;
  const size_t smem = 4 * stream_words(p.per, n, m);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  return (int)launch(full_stream_kernel, p, B / p.per, csize, smem,
                     (cudaStream_t)stream);
}
