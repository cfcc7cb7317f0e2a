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
//   x~  = M^-1 rhs                      (the CR solve of csrc/cr_group.cuh)
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
// binds this file (nvcc for sm_90a, ctypes) and picks the launch plan
// (chunk_launch_plan).
//
// What bounds it.  At MPC H=30 (nb=41, s=16, r_max=24) an iteration is
// about 115k multiply-adds per instance (the grouped A' and A products,
// 2 * 2 * 41 * 24 * 16, and the CR solve, about 5 s^2 nb): at B=2048 and
// 15 iterations, 7 GFLOP, about 0.1 ms at the FP32 peak, against 17 MB of
// state in and out (5 us).  Operations bound it on paper.  Every instance
// and iteration reads the shared factor (214 KB) and B0/B1 (126 KB), so
// with one instance per thread block (the first design) those reads, about
// 10 GB per call at B=2048 through L2, set the time.
//
// Design.  As in the TPU kernel, instances share those reads: a thread
// block takes a group of G consecutive instances (G = 1, 2, 4 or 8, the
// wrapper's plan; the last group may be partial), so each staged value of
// the factor, B0 or B1 serves G instances.
// - State.  x, z, y, v = rho z - y and the CR state of the G instances live
//   in shared memory, interleaved so that the G values of an element are
//   adjacent (G-wide vector accesses); rho once per block.  q, l and u are
//   read from global memory where they are used, as G-wide vectors (a
//   thread's first ones of an A step before the step's wait); x0 and
//   y0 for the deltas come back from the in/out tensors, which the kernel
//   writes only at its end.  x, z, y are updated in place (the wrapper
//   passes the same tensors in and out, as the reference aliases them);
//   each block touches only its own instances.
// - Steps.  An iteration is a sequence of steps, each one block barrier:
//   the A' product over tiles of gt blocks (rhs into the CR state), the
//   CR solve's steps (csrc/cr_group.cuh, tiles of `tile` block pairs), then
//   the A product with the z, y, v and x updates over tiles of gt blocks.
//   Each step's matrix blocks come into a ring of two stages one step
//   ahead, across phases and iterations, by bulk copies (the Tensor Memory
//   Accelerator) that one thread issues and an mbarrier per stage counts
//   in: the other threads never wait to issue a copy, so the copies
//   overlap the compute (16-byte cp.async by every thread stalled the
//   threads that issued them, and the copies added to the compute
//   instead).  Each step's barrier and latency cost more than its work, so
//   steps are as large as shared memory allows (up to 24 block pairs or
//   blocks: 14 at MPC H=30 with eight instances, 24 with two).
// - Threads.  For G >= 2 the block has 512 threads in two halves, each
//   taking G / 2 of the instances of every row it works on (256 threads
//   for G = 1).  A thread loads each matrix value once and applies it to
//   its instances from registers; in the A' product it takes four adjacent
//   rows, and two threads split a row's B0 and B1 halves and add them as
//   the reference does (lo + hi).
// - Done.  A done instance keeps its state and gets zero deltas, as the
//   reference's masking gives; a group whose instances are all done skips
//   the iterations.
// - Order.  Every instance runs the first design's multiply-adds in the
//   same order (dot products from zero by fmaf, the same expressions for
//   the updates, the residual sums over the same threads and warps), so
//   its results do not depend on G and equal the first design's to the
//   bit.  Where the compiler may fuse a product into a subtraction or not
//   (sigma x - q, rho z - y), the fused form the first design compiled to
//   is written out as __fmaf_rn, so register pressure cannot change it.
//   No atomics: two calls give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "cr_group.cuh"

namespace {

using namespace cvxk;

constexpr size_t kSmemLimit = 232448;
constexpr float kInf = 1e30f;
constexpr float kEpsInf = 1e-4f;
// stages of the ring: the step in use and the next one
constexpr int kRing = 2;
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
  int tile, gt, sw, vec;  // CR pairs and A blocks per step, stage words
};

__host__ __device__ inline size_t round4(size_t w) {
  return (w + 3) & ~(size_t)3;
}

// Words of one ring stage: a CR step's factor blocks or an A step's B0 and
// B1 windows.
inline size_t stage_words(int s, int r, int tile, int gt) {
  const size_t cr = (size_t)kSlots * tile * s * s;
  const size_t a = 2 * (size_t)gt * r * s;
  return round4(cr > a ? cr : a);
}

// Dynamic shared-memory words of a block (ops/banded_shared_kernel.py::
// chunk_smem_bytes mirrors it): the CR state, x, z, y and v of G
// instances, rho, and the ring.
inline size_t smem_words(int nb, int s, int r, int G, int tile, int gt) {
  const size_t nx = (size_t)nb * s, nr = (size_t)nb * r;
  return (size_t)nb * (s * G + kPad) + round4(nx * G) + 3 * round4(nr * G) +
         round4(nr) + kRing * stage_words(s, r, tile, gt);
}

inline size_t static_bytes(int G) {
  return sizeof(CrLevel) * kCrMaxLevels +
         4 * (size_t)kWarps * (kNumMax + kNumSum) * G + 8 * kRing;
}

enum { kAtv = 0, kCr = 1, kAv = 2, kEnd = 3 };

// A step of the iteration sequence: an A' or A tile [g0, g0 + gt) of
// iteration `it`, or a CR step.
struct KStep {
  int kind, g0, it;
  Step cr;
};

__device__ __forceinline__ void advance(KStep& ks, const Params& p,
                                        const CrLevel* lv, int n_levels) {
  if (ks.kind == kAtv) {
    ks.g0 += p.gt;
    if (ks.g0 >= p.nb) {
      ks.kind = kCr;
      ks.cr = first_step(n_levels);
    }
  } else if (ks.kind == kCr) {
    next_step(ks.cr, lv, n_levels, p.tile);
    if (ks.cr.phase == kDone) {
      ks.kind = kAv;
      ks.g0 = 0;
    }
  } else if (ks.kind == kAv) {
    ks.g0 += p.gt;
    if (ks.g0 >= p.nb) {
      ks.g0 = 0;
      ks.kind = ++ks.it < p.check_interval ? kAtv : kEnd;
    }
  }
}

// Thread 0: the copies of step `ks`'s matrix blocks into `stage`, then its
// arrival on `bar` with their byte count, which completes the barrier's
// phase when they have landed (at once when there is nothing to copy: the
// end).  A' tiles: B0 of blocks [g0, g1) and B1 of blocks [g0 - 1, g1 - 1);
// A tiles: B0 and B1 of [g0, g1); the B1 slots at gt * r * s.
__device__ void fetch(const KStep& ks, const Params& p, const CrLevel* lv,
                      int root, float* stage, unsigned long long* bar) {
  int bytes = 0;
  auto copy = [&](float* dst, const float* src, int n) {
    bulk_copy(dst, src, 4 * n, bar);
    bytes += 4 * n;
  };
  ring_fence();
  if (ks.kind == kCr) {
    fetch_step(ks.cr, lv, root, p.fac, stage, p.tile, p.s * p.s, copy);
  } else if (ks.kind != kEnd) {
    const int win = p.r * p.s, g0 = ks.g0, g1 = min(g0 + p.gt, p.nb);
    copy(stage, p.B0 + (size_t)g0 * win, (g1 - g0) * win);
    float* hi = stage + p.gt * win;
    if (ks.kind == kAv) {
      copy(hi, p.B1 + (size_t)g0 * win, (g1 - g0) * win);
    } else {
      const int lo = max(g0 - 1, 0);
      if (g1 - 1 > lo)
        copy(hi + (lo - (g0 - 1)) * win, p.B1 + (size_t)lo * win,
             (g1 - 1 - lo) * win);
    }
  }
  ring_arrive(bar, bytes);
}

// The residual pass's products from the matrices in global memory, for W
// instances of a vector v in shared memory (G-wide elements, the first of
// the W at v).
// (A v)_(g, r): the row's B0 window on block g and B1 window on block g + 1
template <int G, int W>
__device__ __forceinline__ void av_glob(const Params& p, const float* v,
                                        int s, int g, int r,
                                        float (&acc)[W]) {
  const size_t row = ((size_t)g * p.r + r) * s;
  dot_row_ldg<W>(p.B0 + row, v + (size_t)g * s * G, s, G, acc);
  if (g + 1 < p.nb) {
    float d[W];
    dot_row_ldg<W>(p.B1 + row, v + (size_t)(g + 1) * s * G, s, G, d);
#pragma unroll
    for (int u = 0; u < W; ++u) acc[u] += d[u];
  }
}

// (A' v)_(g, i): B0 of block g plus B1 of block g - 1
template <int G, int W>
__device__ __forceinline__ void atv_glob(const Params& p, const float* v,
                                         int s, int g, int i,
                                         float (&acc)[W]) {
  const int R = p.r;
  float hi[W];
  dot_col<W>(p.B0 + (size_t)g * R * s + i, s, v + (size_t)g * R * G, R, G,
             acc);
#pragma unroll
  for (int u = 0; u < W; ++u) hi[u] = 0.f;
  if (g > 0)
    dot_col<W>(p.B1 + (size_t)(g - 1) * R * s + i, s,
               v + (size_t)(g - 1) * R * G, R, G, hi);
#pragma unroll
  for (int u = 0; u < W; ++u) acc[u] = acc[u] + hi[u];
}

// Block j of the grid runs instances [j G, j G + G) (fewer in a partial
// last group) with kThreads threads per H = 2 halves of the group (H = 1
// for G = 1): a (row, pair) of a step takes H threads, each applying it to
// G / H of the instances.
template <int G, int S>
__global__ void __launch_bounds__(G >= 2 ? 2 * kThreads : kThreads)
    chunk_kernel(const Params p, const CrMeta cm) {
  constexpr int H = G >= 2 ? 2 : 1, W = G / H, NT = kThreads * H;
  extern __shared__ __align__(16) float smem[];
  __shared__ CrLevel lv[kCrMaxLevels];
  __shared__ float red_max[kWarps][kNumMax][G];
  __shared__ float red_sum[kWarps][kNumSum][G];
  __shared__ unsigned long long ring_bar[kRing];
  const int s = S ? S : p.s, nb = p.nb, R = p.r;
  const int nx = nb * s, nr = nb * R;
  const int bs = s * G + kPad;
  const bool warp_local = s * H <= 32 && 32 % (s * H) == 0;
  float* state = smem;                                  // CR state, then dx
  float* X = state + (size_t)nb * bs;
  float* Z = X + round4((size_t)nx * G);
  float* Y = Z + round4((size_t)nr * G);
  float* V = Y + round4((size_t)nr * G);                // rho z - y, then dy
  float* Rho = V + round4((size_t)nr * G);
  float* ring = Rho + round4(nr);
  cr_load_levels(cm, lv);
  const int tid = threadIdx.x;
  const size_t B = p.B, j0 = (size_t)blockIdx.x * G;
  const int nv = min(G, p.B - (int)j0);
  const bool full = p.vec && nv == G;
  bool dn[G];
  bool active = false;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    dn[u] = u < nv && p.done[j0 + u] > 0;
    active = active || (u < nv && !dn[u]);
  }
  active = active && p.check_interval > 0;
  const float sigma = p.sigma, alpha = p.alpha;
  for (int e = tid; e < nx; e += NT) {
    float v[G];
    ld_inst<G, false>(p.x + (size_t)e * B + j0, nv, full, v);
    st_vec<G>(X + (size_t)e * G, v);
  }
  for (int e = tid; e < nr; e += NT) {
    float zv[G], yv[G], vv[G];
    ld_inst<G, false>(p.z + (size_t)e * B + j0, nv, full, zv);
    ld_inst<G, false>(p.y + (size_t)e * B + j0, nv, full, yv);
    const float rh = __ldg(p.rho + e);
#pragma unroll
    for (int u = 0; u < G; ++u) vv[u] = __fmaf_rn(rh, zv[u], -yv[u]);
    st_vec<G>(Z + (size_t)e * G, zv);
    st_vec<G>(Y + (size_t)e * G, yv);
    st_vec<G>(V + (size_t)e * G, vv);
    Rho[e] = rh;
  }
  __syncthreads();

  if (active) {
    // the ring: stage n % kRing holds step n, filled by thread 0 one step
    // ahead and awaited on its mbarrier, whose phase n / kRing it is
    if (tid == 0) ring_init(ring_bar, kRing);
    __syncthreads();
    KStep cs{kAtv, 0, 0, first_step(cm.n_levels)};
    KStep is = cs;
    if (tid == 0) fetch(is, p, lv, cm.root, ring, &ring_bar[0]);
    advance(is, p, lv, cm.n_levels);
    for (int n = 0; cs.kind != kEnd; ++n) {
      const int buf = n % kRing, nxt = (n + 1) % kRing;
      // an A step's first operands from global memory (inputs the kernel
      // never writes) before the wait, so that their latency overlaps it
      float pq[4][W], pl[W], pu[W];
      if (cs.kind == kAtv) {
        const int nq = (min(cs.g0 + p.gt, nb) - cs.g0) * (s / 4);
        const int u0 = ((tid >> 1) % H) * W, rest = tid / (2 * H);
        if ((tid & 1) == 0 && rest < nq) {
          const int gl = rest / (s / 4), i0 = 4 * (rest - gl * (s / 4));
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
            ld_inst<W>(p.q + (size_t)((cs.g0 + gl) * s + i0 + ii) * B + j0 +
                           u0, nv - u0, full, pq[ii]);
        }
      } else if (cs.kind == kAv) {
        const int row = tid / H, u0 = (tid - row * H) * W;
        if (row < (min(cs.g0 + p.gt, nb) - cs.g0) * R) {
          const size_t o = (size_t)cs.g0 * R + row;
          ld_inst<W>(p.l + o * B + j0 + u0, nv - u0, full, pl);
          ld_inst<W>(p.u + o * B + j0 + u0, nv - u0, full, pu);
        }
      }
      bar_wait(&ring_bar[buf], (n / kRing) & 1);
      __syncthreads();
      if (tid == 0)
        fetch(is, p, lv, cm.root, ring + nxt * p.sw, &ring_bar[nxt]);
      advance(is, p, lv, cm.n_levels);
      const float* stage = ring + buf * p.sw;
      if (cs.kind == kCr) {
        compute<G, S, H>(cs.cr, lv, state, stage, p.tile, s, bs, warp_local);
      } else if (cs.kind == kAtv) {
        // rhs = (sigma x - q) + (lo + hi) into the CR state.  A thread takes
        // four adjacent rows i of a block g, W instances and one half: lo =
        // B0 of block g against v_g, hi = B1 of block g - 1 against v_{g-1}
        // (zero for g = 0), each dot in r order; the halves meet by a
        // shuffle
        const int g0 = cs.g0, nq = (min(g0 + p.gt, nb) - g0) * (s / 4);
        const float* sB1 = stage + p.gt * R * s;
        for (int base = 0; base < 2 * H * nq; base += NT) {
          const int e = base + tid, half = e & 1, u0 = ((e >> 1) % H) * W;
          const int rest = min(e / (2 * H), nq - 1);
          const int gl = rest / (s / 4), i0 = 4 * (rest - gl * (s / 4));
          const int g = g0 + gl;
          float acc[4][W];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int u = 0; u < W; ++u) acc[ii][u] = 0.f;
          if (e < 2 * H * nq && (half == 0 || g > 0)) {
            const float* w = (half ? sB1 : stage) + gl * R * s + i0;
            const float* v = V + (size_t)(half ? g - 1 : g) * R * G + u0;
#pragma unroll 4
            for (int r = 0; r < R; ++r) {
              const float4 w4 = *reinterpret_cast<const float4*>(w + r * s);
              const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
              float vv[W];
              ld_vec<W>(v + r * G, vv);
#pragma unroll
              for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                for (int u = 0; u < W; ++u)
                  acc[ii][u] = fmaf(wr[ii], vv[u], acc[ii][u]);
            }
          }
          float hi[4][W];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int u = 0; u < W; ++u)
              hi[ii][u] = __shfl_xor_sync(0xffffffffu, acc[ii][u], 1);
          if (e < 2 * H * nq && half == 0) {
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              const int o = g * s + i0 + ii;
              float xv[W], qv[W], out[W];
              ld_vec<W>(X + (size_t)o * G + u0, xv);
              if (base == 0) {
#pragma unroll
                for (int u = 0; u < W; ++u) qv[u] = pq[ii][u];
              } else {
                ld_inst<W>(p.q + (size_t)o * B + j0 + u0, nv - u0, full, qv);
              }
#pragma unroll
              for (int u = 0; u < W; ++u)
                out[u] = __fmaf_rn(sigma, xv[u], -qv[u]) +
                         (acc[ii][u] + hi[ii][u]);
              st_vec<W>(state + (size_t)g * bs + (i0 + ii) * G + u0, out);
            }
          }
        }
      } else {
        // z~ = A x~ and the z, y, v updates row by row; then x
        const int g0 = cs.g0, g1 = min(g0 + p.gt, nb);
        const float* sB1 = stage + p.gt * R * s;
        for (int e = tid; e < H * (g1 - g0) * R; e += NT) {
          const int row = e / H, u0 = (e - row * H) * W;
          const int gl = row / R, r = row - gl * R, g = g0 + gl;
          const size_t o = (size_t)g * R + r;
          float zv[W], yv[W], lo[W], up[W], vv[W], acc[W], d[W];
          if (e == tid) {
#pragma unroll
            for (int u = 0; u < W; ++u) {
              lo[u] = pl[u];
              up[u] = pu[u];
            }
          } else {
            ld_inst<W>(p.l + o * B + j0 + u0, nv - u0, full, lo);
            ld_inst<W>(p.u + o * B + j0 + u0, nv - u0, full, up);
          }
          ld_vec<W>(Z + o * G + u0, zv);
          ld_vec<W>(Y + o * G + u0, yv);
          dot_row<W>(stage + (gl * R + r) * s, state + (size_t)g * bs + u0,
                     s, G, acc);
          if (g + 1 < nb) {
            dot_row<W>(sB1 + (gl * R + r) * s,
                       state + (size_t)(g + 1) * bs + u0, s, G, d);
#pragma unroll
            for (int u = 0; u < W; ++u) acc[u] += d[u];
          }
          const float rh = Rho[o];
#pragma unroll
          for (int u = 0; u < W; ++u) {
            const float w =
                alpha * acc[u] + (1.f - alpha) * zv[u] + yv[u] / rh;
            const float z1 = fminf(fmaxf(w, lo[u]), up[u]);
            yv[u] = rh * (w - z1);
            zv[u] = z1;
            vv[u] = __fmaf_rn(rh, zv[u], -yv[u]);
          }
          st_vec<W>(Z + o * G + u0, zv);
          st_vec<W>(Y + o * G + u0, yv);
          st_vec<W>(V + o * G + u0, vv);
        }
        for (int e = tid; e < H * (g1 - g0) * s; e += NT) {
          const int row = e / H, u0 = (e - row * H) * W;
          const int gl = row / s, i = row - gl * s, g = g0 + gl;
          float xt[W], xv[W];
          ld_vec<W>(state + (size_t)g * bs + i * G + u0, xt);
          ld_vec<W>(X + ((size_t)g * s + i) * G + u0, xv);
#pragma unroll
          for (int u = 0; u < W; ++u)
            xv[u] = alpha * xt[u] + (1.f - alpha) * xv[u];
          st_vec<W>(X + ((size_t)g * s + i) * G + u0, xv);
        }
      }
      advance(cs, p, lv, cm.n_levels);
    }
    __syncthreads();
  }

  // deltas against the entry state, which the in/out tensors still hold;
  // a done instance takes its entry state back and zero deltas
  float* DX = state;
  float* DY = V;
  for (int e = tid; e < nx; e += NT) {
    float x0[G], xv[G], dv[G];
    ld_inst<G, false>(p.x + (size_t)e * B + j0, nv, full, x0);
    ld_vec<G>(X + (size_t)e * G, xv);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (dn[u]) xv[u] = x0[u];
      dv[u] = dn[u] ? 0.f : xv[u] - x0[u];
    }
    st_vec<G>(X + (size_t)e * G, xv);
    st_vec<G>(DX + (size_t)e * G, dv);
  }
  for (int e = tid; e < nr; e += NT) {
    float y0[G], z0[G], yv[G], zv[G], dv[G];
    ld_inst<G, false>(p.y + (size_t)e * B + j0, nv, full, y0);
    ld_inst<G, false>(p.z + (size_t)e * B + j0, nv, full, z0);
    ld_vec<G>(Y + (size_t)e * G, yv);
    ld_vec<G>(Z + (size_t)e * G, zv);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (dn[u]) {
        yv[u] = y0[u];
        zv[u] = z0[u];
      }
      dv[u] = dn[u] ? 0.f : yv[u] - y0[u];
    }
    st_vec<G>(Y + (size_t)e * G, yv);
    st_vec<G>(Z + (size_t)e * G, zv);
    st_vec<G>(DY + (size_t)e * G, dv);
  }
  __syncthreads();

  // maxima: 0 rp, 1-2 rp_den terms, 3 |E dy|, 4 E_inv A dx on finite-u
  // rows, 5 -E_inv A dx on finite-l rows, 6 open direction, 7 rd, 8-10
  // rd_den terms, 11 |D_inv A' dy|, 12 |D dx|, 13 |D_inv P dx|;
  // sums: 0 the support-function term, 1 q'dx.  Rows first (maxima 0-6,
  // sum 0), then columns (7-13, sum 1).  Half h of the threads takes the
  // instances from u0 = h W, and its thread t the rows t, t + 256, ...;
  // then a reduction over each warp and over the half's warps in order.
  const int t = tid % kThreads, u0 = (tid / kThreads) * W;
  const int warp = t / 32, lane = t % 32;
  const int nvh = nv - u0;
  {
    float mx[7][W], sm[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
#pragma unroll
      for (int k = 0; k < 7; ++k) mx[k][u] = 0.f;
      mx[4][u] = mx[5][u] = -INFINITY;
      sm[u] = 0.f;
    }
    for (int o = t; o < nr; o += kThreads) {
      const int g = o / R, r = o - g * R;
      float ax[W], adx[W], zv[W], dyv[W], Lo[W], Up[W];
      av_glob<G, W>(p, X + u0, s, g, r, ax);
      av_glob<G, W>(p, DX + u0, s, g, r, adx);
      ld_vec<W>(Z + (size_t)o * G + u0, zv);
      ld_vec<W>(DY + (size_t)o * G + u0, dyv);
      ld_inst<W>(p.l + (size_t)o * B + j0 + u0, nvh, full, Lo);
      ld_inst<W>(p.u + (size_t)o * B + j0 + u0, nvh, full, Up);
      const float einv = __ldg(p.Einv + o), e = __ldg(p.E + o);
#pragma unroll
      for (int u = 0; u < W; ++u) {
        mx[0][u] = fmaxf(mx[0][u], fabsf(einv * (ax[u] - zv[u])));
        mx[1][u] = fmaxf(mx[1][u], fabsf(einv * ax[u]));
        mx[2][u] = fmaxf(mx[2][u], fabsf(einv * zv[u]));
        const float dy = dyv[u], edy = e * dy;
        mx[3][u] = fmaxf(mx[3][u], fabsf(edy));
        const bool u_open = Up[u] >= kInf * 0.5f,
                   l_open = Lo[u] <= -kInf * 0.5f;
        const float u_fin = u_open ? 0.f : Up[u] * einv;
        const float l_fin = l_open ? 0.f : Lo[u] * einv;
        sm[u] += u_fin * fmaxf(edy, 0.f) + l_fin * fminf(edy, 0.f);
        if ((dy > 1e-12f && u_open) || (dy < -1e-12f && l_open))
          mx[6][u] = 1.f;
        const float eadx = einv * adx[u];
        if (!u_open) mx[4][u] = fmaxf(mx[4][u], eadx);
        if (!l_open) mx[5][u] = fmaxf(mx[5][u], -eadx);
      }
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const float v = warp_max(mx[k][u]);
        if (lane == 0) red_max[warp][k][u0 + u] = v;
      }
      const float v = warp_sum(sm[u]);
      if (lane == 0) red_sum[warp][0][u0 + u] = v;
    }
  }
  {
    float mx[7][W], sm[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
#pragma unroll
      for (int k = 0; k < 7; ++k) mx[k][u] = 0.f;
      sm[u] = 0.f;
    }
    for (int o = t; o < nx; o += kThreads) {
      const int g = o / s, i = o - g * s;
      float px[W], pdx[W], aty[W], atdy[W], qv[W], dxv[W];
      btmv_glob<G, W>(p.DP, p.LP, p.nb, X + u0, s, g, i, px);
      btmv_glob<G, W>(p.DP, p.LP, p.nb, DX + u0, s, g, i, pdx);
      atv_glob<G, W>(p, Y + u0, s, g, i, aty);
      atv_glob<G, W>(p, DY + u0, s, g, i, atdy);
      ld_inst<W>(p.q + (size_t)o * B + j0 + u0, nvh, full, qv);
      ld_vec<W>(DX + (size_t)o * G + u0, dxv);
      const float d = __ldg(p.D + o), dinv = 1.f / d;
#pragma unroll
      for (int u = 0; u < W; ++u) {
        mx[0][u] = fmaxf(mx[0][u], fabsf(dinv * ((px[u] + qv[u]) + aty[u])));
        mx[1][u] = fmaxf(mx[1][u], fabsf(dinv * px[u]));
        mx[2][u] = fmaxf(mx[2][u], fabsf(dinv * aty[u]));
        mx[3][u] = fmaxf(mx[3][u], fabsf(dinv * qv[u]));
        mx[4][u] = fmaxf(mx[4][u], fabsf(dinv * atdy[u]));
        mx[5][u] = fmaxf(mx[5][u], fabsf(d * dxv[u]));
        mx[6][u] = fmaxf(mx[6][u], fabsf(dinv * pdx[u]));
        sm[u] += qv[u] * dxv[u];
      }
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const float v = warp_max(mx[k][u]);
        if (lane == 0) red_max[warp][7 + k][u0 + u] = v;
      }
      const float v = warp_sum(sm[u]);
      if (lane == 0) red_sum[warp][1][u0 + u] = v;
    }
  }
  __syncthreads();
  if (tid < nv) {
    const int u = tid;
    for (int w = 1; w < kWarps; ++w) {
      for (int k = 0; k < kNumMax; ++k)
        red_max[0][k][u] = fmaxf(red_max[0][k][u], red_max[w][k][u]);
      for (int k = 0; k < kNumSum; ++k) red_sum[0][k][u] += red_sum[w][k][u];
    }
    float M[kNumMax];
    for (int k = 0; k < kNumMax; ++k) M[k] = red_max[0][k][u];
    const float cinv = p.cinv;
    const float rp = M[0], rp_den = fmaxf(M[1], M[2]);
    const float rd = cinv * M[7];
    const float rd_den = cinv * fmaxf(fmaxf(M[8], M[9]), M[10]);
    const bool ok = rp <= p.eps_abs + p.eps_rel * rp_den &&
                    rd <= p.eps_abs + p.eps_rel * rd_den;
    const float dy_n = M[3] * cinv;
    const bool cert_p1 = M[11] * cinv <= kEpsInf * dy_n;
    const float sup = red_sum[0][0][u] * cinv;
    const bool p_inf = dy_n > 1e-10f && cert_p1 && sup <= -kEpsInf * dy_n &&
                       !(M[6] > 0.f);
    const float dx_n = M[12];
    const bool cert_d1 = M[13] * cinv <= kEpsInf * dx_n;
    const bool cert_d2 = red_sum[0][1][u] * cinv <= -kEpsInf * dx_n;
    const bool rows_ok = M[4] <= kEpsInf * dx_n && M[5] <= kEpsInf * dx_n;
    const bool d_inf = dx_n > 1e-10f && cert_d1 && cert_d2 && rows_ok;
    const size_t b = j0 + u;
    p.rp[b] = rp;
    p.rd[b] = rd;
    p.rpd[b] = rp_den;
    p.rdd[b] = rd_den;
    p.flags[b] = (ok ? 1 : 0) + (p_inf ? 2 : 0) + (d_inf ? 4 : 0);
  }
  for (int e = tid; e < nx; e += NT) {
    float v[G];
    ld_vec<G>(X + (size_t)e * G, v);
    st_inst<G>(p.x + (size_t)e * B + j0, nv, full, v);
  }
  for (int e = tid; e < nr; e += NT) {
    float v[G];
    ld_vec<G>(Z + (size_t)e * G, v);
    st_inst<G>(p.z + (size_t)e * B + j0, nv, full, v);
    ld_vec<G>(Y + (size_t)e * G, v);
    st_inst<G>(p.y + (size_t)e * B + j0, nv, full, v);
  }
}

template <int G>
cudaError_t launch(const Params& p, const CrMeta& cm, size_t smem,
                   cudaStream_t stream) {
  const int grid = (p.B + G - 1) / G;
  const void* fn = p.s == 16 ? (const void*)chunk_kernel<G, 16>
                             : (const void*)chunk_kernel<G, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = G >= 2 ? 2 * kThreads : kThreads;
  if (p.s == 16)
    chunk_kernel<G, 16><<<grid, threads, smem, stream>>>(p, cm);
  else
    chunk_kernel<G, 0><<<grid, threads, smem, stream>>>(p, cm);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one K5 block (ops/banded_shared_kernel.py::
// chunk_smem_bytes mirrors it), or 0 when it does not fit beside the
// block's static shared memory.
extern "C" long long banded_chunk_smem_bytes(int nb, int s, int r_max,
                                             int group, int tile, int gt) {
  const size_t bytes = 4 * smem_words(nb, s, r_max, group, tile, gt);
  return bytes + static_bytes(group) <= kSmemLimit ? (long long)bytes : 0;
}

// Launches kernel K5 on `stream`: `group` instances per thread block (1, 2,
// 4 or 8), CR steps of at most `tile` block pairs, A steps of `gt` blocks;
// `meta` is the host int array of cr_meta_array.  x, z, y are updated in
// place.  Returns the CUDA error code (0 = success).
extern "C" int banded_chunk_f32(
    const float* fac, const float* B0, const float* B1, const float* DP,
    const float* LP, const float* D, const float* Einv, const float* E,
    const float* rho, const float* q, const float* l, const float* u,
    float* x, float* z, float* y, const int* done, float* rp, float* rd,
    float* rpd, float* rdd, int* flags, const int* meta, int B, int nb, int s,
    int r_max, int check_interval, float cinv, float sigma, float alpha,
    float eps_abs, float eps_rel, int group, int tile, int gt,
    void* stream) {
  CrMeta cm;
  if (B <= 0 || r_max <= 0 || check_interval < 0 || !cr_meta_from(meta, &cm) ||
      cm.nb != nb || cm.s != s || s % 4 != 0 || tile < 1 || gt < 1 ||
      (long long)tile * s > (long long)kPairsPerThread * kThreads ||
      (uintptr_t)fac % 16 || (uintptr_t)B0 % 16 || (uintptr_t)B1 % 16 ||
      (uintptr_t)DP % 16 || (uintptr_t)LP % 16)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      banded_chunk_smem_bytes(nb, s, r_max, group, tile, gt);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const int lanes = group < 4 ? group : 4;
  const int vec = B % lanes == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)l % 16 == 0 && (uintptr_t)u % 16 == 0 &&
                  (uintptr_t)x % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  Params p{fac, B0,   B1, DP,    LP,         D,    Einv,    E,
           rho, q,    l,  u,     x,          z,    y,       done,
           rp,  rd,   rpd, rdd,  flags,      B,    nb,      s,
           r_max, check_interval, cinv, sigma, alpha, eps_abs, eps_rel,
           tile, gt, (int)stage_words(s, r_max, tile, gt), vec};
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return (int)launch<1>(p, cm, (size_t)smem, st);
    case 2: return (int)launch<2>(p, cm, (size_t)smem, st);
    case 4: return (int)launch<4>(p, cm, (size_t)smem, st);
    case 8: return (int)launch<8>(p, cm, (size_t)smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
