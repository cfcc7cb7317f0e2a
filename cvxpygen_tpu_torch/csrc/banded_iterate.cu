// Kernel K11: check_interval fused banded ADMM iterations per instance on a
// shared block-banded KKT, on the rho-scaled state, with no checks.
//
// Replaces cvxpygen_tpu/ops/banded_shared_kernel.py::_banded_iterate_kernel
// (the Pallas TPU kernel; wrapper banded_iterate), the reference's large-nb
// iterate kernel, and computes the same function on the same data: x/q (nb, s,
// B), z/y/l/u (nb, r_max, B), the grouped A windows B0/B1 and, scaled by rho,
// B0r/B1r (given r-major, (r_max, nb, s), by the wrapper), the packed CR
// factor, and the banded M (D_M, L_M) for refinement.  z, l and u are
// rho-scaled (rho z, rho l, rho u), so no rho multiply is left in the
// iteration:
//   rhs = sigma x - q + A'(z - y)        (grouped A': B1 shifted one block)
//   x~  = M^-1 rhs                       (the CR solve of csrc/cr_group.cuh;
//         each refinement sweep adds M^-1 (rhs - M x~))
//   w   = alpha (rho A) x~ + (1 - alpha) z + y
//   z = clip(w, l, u),  y = w - z,  x = alpha x~ + (1 - alpha) x.
// Its plain torch version is banded_iterate_plain in
// cvxpygen_tpu_torch/ops/banded_shared_kernel.py, which also builds and
// binds this file (nvcc for sm_90a, ctypes) and picks the launch plan
// (iterate_launch_plan).
//
// What bounds it.  At charging T=1440 (nb=541, s=8, r_max=24, 2711 packed
// blocks; B=256, 50 iterations) an iteration needs per instance the A' and
// A products (nnz(A) multiply-adds each) and the CR solve (every packed
// block applied once, 2711 * 64 multiply-adds): about 0.41 MFLOP, 5.25
// GFLOP in all, 0.078 ms at the FP32 peak, against the state and shared
// inputs read once and written once (76 MB, 0.023 ms; chip_smoke.py::
// k11_bound).  So operations bound it on paper.  In practice the latency
// of one block's chain sets its time: the reads that every iteration makes
// from L2 and device memory (the A windows and the instances' state) and
// the CR solve's ~35 dependent steps; on the H100 one block alone takes
// about two thirds of the time that 128 take (chip_smoke.py phase 13 by
// batch; PERF.md).
//
// Design.  As in kernels K4 and K5, instances share the reads of the
// shared matrices: a thread block takes a group of G consecutive instances
// (G = 1, 2, 4 or 8, the wrapper's plan; the last group may be partial).
// - State.  The CR state (csrc/cr_group.cuh) and x of the G instances live
//   in shared memory, G-wide vectors of adjacent instances; with
//   refinement also the right-hand side and the refined solution.  z, y,
//   l, u and q, touched once or twice per iteration, stay in device memory
//   (z and y at charging are 104 KB per instance): the block copies its
//   group's rows from their (., B) layout, where the group takes 4 G
//   bytes of each 32-byte sector, into its stretch of a device scratch
//   (the wrapper allocates it) where the group's values of a row are
//   adjacent, iterates there, and copies z and y back at the end: the
//   (., B) layout is read and written once per call, not per iteration.
//   Each block touches only its own instances.
// - Steps.  An iteration is a sequence of steps, each one block barrier:
//   the A' pass over all rows (rhs into the CR state), the CR solve's steps
//   (tiles of `tile` block pairs), with refinement a fold of the solution
//   and the residual rhs - M x~ per sweep and the sweep's solve, then the A
//   pass over all rows with the z, y and x updates.  The CR steps' factor
//   blocks come into a ring of kRing stages, kRing - 1 steps ahead across
//   phases and iterations, by bulk copies (the Tensor Memory Accelerator)
//   that one thread issues and an mbarrier per stage counts in.  The A
//   windows (and M) are read from L2 by the thread that uses them, one
//   read for the group's G instances; the wrapper passes them r-major, and
//   the scratch keeps z, y, l, u r-major too, so that the threads of a
//   warp, which take neighbouring blocks g, read neighbouring words.
// - Threads.  512 threads for G >= 2 (two halves of the group in the CR
//   steps), 256 for G = 1.  In the A' and A passes a thread takes all G
//   instances of its rows: a block's rows (four of them above s = 8 or
//   G = 2) and one of the two halves of A' (B0 of block g or B1 of block
//   g - 1, met by a shuffle and added as the reference adds them), or two
//   rows of A.
// - Order.  Every instance runs the one-instance design's arithmetic in
//   its order: the dot products in r or j order from zero by fmaf, the A'
//   halves as lo + hi, the CR solve's order (csrc/cr_group.cuh), the
//   refinement residual rhs - ((D x_g + L x_{g-1}) + L' x_{g+1}), and the
//   updates as the same expressions.  Where the compiler may contract a
//   product into an addition or not (sigma x - q; the w and x updates),
//   the form that design compiled to is written out (__fmaf_rn, __fmul_rn),
//   so that no instantiation can choose another.  So x, z and y do not
//   depend on G and equal that design's to the bit.  No atomics: two calls
//   give the same bits.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cr_group.cuh"

namespace {

using namespace cvxk;

constexpr size_t kSmemLimit = 232448;
// stages of the ring: the CR step in use and the two after it
constexpr int kRing = 3;

struct Params {
  const float* fac;  // (NB_TOT, s, s) packed CR factor
  const float* B0;   // (r_max, nb, s) grouped A, block g, r-major
  const float* B1;   // (r_max, nb, s) grouped A, block g + 1, r-major
  const float* B0r;  // B0 scaled by rho row by row, r-major
  const float* B1r;  // B1 scaled by rho row by row, r-major
  const float* DM;   // (nb, s, s) diagonal blocks of M, or null
  const float* LM;   // (nb - 1, s, s) sub-diagonal blocks of M, or null
  const float* q;    // (nb, s, B)
  const float* l;    // (nb, r_max, B), rho-scaled
  const float* u;    // (nb, r_max, B), rho-scaled
  float* x;          // (nb, s, B) in/out
  float* z;          // (nb, r_max, B) in/out, rho-scaled
  float* y;          // (nb, r_max, B) in/out
  float* scr;        // per group: z, y, l, u, q with the group's instances
                     // adjacent, (4 nb r_max + nb s) G floats
  int B, nb, s, r, check_interval, kkt_refine;
  float sigma, alpha;
  int tile, sw, vec;  // CR pairs per step, words of a ring stage
};

__host__ __device__ inline size_t round4(size_t w) {
  return (w + 3) & ~(size_t)3;
}

inline size_t stage_words(int s, int tile) {
  return round4((size_t)kSlots * tile * s * s);
}

// Dynamic shared-memory words of a block (ops/banded_shared_kernel.py::
// iterate_smem_bytes mirrors it): the CR state and x of G instances, with
// refinement also their refined solution and right-hand side (x's layout),
// and the ring.
inline size_t smem_words(int nb, int s, int G, int tile, int refine) {
  return (size_t)nb * (s * G + kPad) +
         (refine ? 3 : 1) * round4((size_t)nb * s * G) +
         kRing * stage_words(s, tile);
}

constexpr size_t kStaticBytes = sizeof(CrLevel) * kCrMaxLevels + 8 * kRing;

// The group's stretch of the scratch: its instances' z and y, which the
// iteration updates, and l, u, q; element (row o, instance u) at o G + u,
// the rows of z, y, l, u r-major (row r of block g at o = r nb + g, as in
// the A windows), q's block-major.
struct Rows {
  float* z;
  float* y;
  const float* l;
  const float* u;
  const float* q;
};

enum { kAtv = 0, kCr = 1, kFold = 2, kRes = 3, kAv = 4, kEnd = 5 };

// A step of the iteration sequence: the A' pass of iteration `it`, a CR
// step of solve `solve` (0 the iteration's, k >= 1 the k-th refinement
// sweep's), the fold of that solve's result into the refined solution, a
// sweep's residual, or the A pass.
struct KStep {
  int kind, it, solve;
  Step cr;
};

__device__ __forceinline__ void advance(KStep& ks, const Params& p,
                                        const CrLevel* lv, int n_levels) {
  switch (ks.kind) {
    case kAtv:
      ks.kind = kCr;
      ks.solve = 0;
      ks.cr = first_step(n_levels);
      break;
    case kCr:
      next_step(ks.cr, lv, n_levels, p.tile);
      if (ks.cr.phase == kDone) ks.kind = p.kkt_refine ? kFold : kAv;
      break;
    case kFold:
      ks.kind = ks.solve < p.kkt_refine ? kRes : kAv;
      break;
    case kRes:
      ks.kind = kCr;
      ++ks.solve;
      ks.cr = first_step(n_levels);
      break;
    case kAv:
      ks.kind = ++ks.it < p.check_interval ? kAtv : kEnd;
      break;
  }
}

// Thread 0: the copies of step `ks`'s factor blocks into `stage` (CR steps
// only), then its arrival on `bar` with their byte count.
__device__ void fetch(const KStep& ks, const Params& p, const CrLevel* lv,
                      int root, float* stage, unsigned long long* bar) {
  int bytes = 0;
  ring_fence();
  if (ks.kind == kCr)
    fetch_step(ks.cr, lv, root, p.fac, stage, p.tile, p.s * p.s,
               [&](float* dst, const float* src, int n) {
                 bulk_copy(dst, src, 4 * n, bar);
                 bytes += 4 * n;
               });
  ring_arrive(bar, bytes);
}

// rhs = (sigma x - q) + (lo + hi) into the CR state (and RHS) for every
// row of the group: a thread takes QW adjacent rows i of a block g (the
// whole block at s = 8 for G <= 2, else four) and one half: lo = B0 of
// block g against z_g - y_g, hi = B1 of block g - 1 against
// z_{g-1} - y_{g-1} (zero for g = 0), each dot in r order, eight r at a
// time (their loads issued together); the halves meet by a shuffle.
template <int G, int S, int NT>
__device__ __forceinline__ void atv_pass(const Params& p, const Rows& st,
                                         const float* X, float* state,
                                         float* RHS, int bs) {
  constexpr int QW = S == 8 && G <= 2 ? 8 : 4;
  const int s = S ? S : p.s, nb = p.nb, R = p.r;
  const int nq = nb * (s / QW);
  for (int base = 0; base < 2 * nq; base += NT) {
    const int e = base + threadIdx.x, half = e & 1;
    const int rest = min(e >> 1, nq - 1);
    const int g = rest / (s / QW), i0 = QW * (rest - g * (s / QW));
    float acc[QW][G];
#pragma unroll
    for (int ii = 0; ii < QW; ++ii)
#pragma unroll
      for (int u = 0; u < G; ++u) acc[ii][u] = 0.f;
    if (e < 2 * nq && (half == 0 || g > 0)) {
      const int gb = half ? g - 1 : g;
      const float* w = (half ? p.B1 : p.B0) + (size_t)gb * s + i0;
      const float* zr = st.z + (size_t)gb * G;
      const float* yr = st.y + (size_t)gb * G;
#pragma unroll 8
      for (int r = 0; r < R; ++r) {
        float wr[QW];
#pragma unroll
        for (int q = 0; q < QW / 4; ++q) {
          const float4 w4 = __ldg(
              reinterpret_cast<const float4*>(w + (size_t)r * nb * s) + q);
          wr[4 * q] = w4.x;
          wr[4 * q + 1] = w4.y;
          wr[4 * q + 2] = w4.z;
          wr[4 * q + 3] = w4.w;
        }
        float zv[G], yv[G];
        ld_vec<G>(zr + (size_t)r * nb * G, zv);
        ld_vec<G>(yr + (size_t)r * nb * G, yv);
#pragma unroll
        for (int ii = 0; ii < QW; ++ii)
#pragma unroll
          for (int u = 0; u < G; ++u)
            acc[ii][u] = fmaf(wr[ii], zv[u] - yv[u], acc[ii][u]);
      }
    }
    float hi[QW][G];
#pragma unroll
    for (int ii = 0; ii < QW; ++ii)
#pragma unroll
      for (int u = 0; u < G; ++u)
        hi[ii][u] = __shfl_xor_sync(0xffffffffu, acc[ii][u], 1);
    if (e < 2 * nq && half == 0) {
#pragma unroll
      for (int ii = 0; ii < QW; ++ii) {
        const int o = g * s + i0 + ii;
        float xv[G], qv[G], out[G];
        ld_vec<G>(X + (size_t)o * G, xv);
        ld_vec<G>(st.q + (size_t)o * G, qv);
#pragma unroll
        for (int u = 0; u < G; ++u)
          out[u] = __fmaf_rn(p.sigma, xv[u], -qv[u]) +
                   (acc[ii][u] + hi[ii][u]);
        st_vec<G>(state + (size_t)g * bs + (i0 + ii) * G, out);
        if (RHS) st_vec<G>(RHS + (size_t)o * G, out);
      }
    }
  }
}

// (rho A) x~ row by row (the row's scaled B0 window on block g, B1 window
// on block g + 1) and the z and y updates, r-major rows, so that a warp's
// reads of the windows and the state are contiguous, two rows per thread
// at a time (their loads issued together), then x; x~ has its blocks xbs
// words apart (the CR state's or x's layout).
template <int G, int S, int NT>
__device__ __forceinline__ void av_pass(const Params& p, const Rows& st,
                                        const float* xt, int xbs, float* X) {
  constexpr int RR = 2;
  const int s = S ? S : p.s, nb = p.nb, R = p.r;
  const int nx = nb * s, nr = nb * R;
  const float alpha = p.alpha;
  for (int o0 = threadIdx.x; o0 < nr; o0 += RR * NT) {
    float zv[RR][G], yv[RR][G], lo[RR][G], up[RR][G], acc[RR][G];
#pragma unroll
    for (int k = 0; k < RR; ++k) {
      const int o = o0 + k * NT, g = o % nb;
      if (o >= nr) continue;
      ld_vec<G>(st.z + (size_t)o * G, zv[k]);
      ld_vec<G>(st.y + (size_t)o * G, yv[k]);
      ld_vec<G>(st.l + (size_t)o * G, lo[k]);
      ld_vec<G>(st.u + (size_t)o * G, up[k]);
      dot_row_ldg<G>(p.B0r + (size_t)o * s, xt + (size_t)g * xbs, s, G,
                     acc[k]);
      if (g + 1 < nb) {
        float d[G];
        dot_row_ldg<G>(p.B1r + (size_t)o * s, xt + (size_t)(g + 1) * xbs, s,
                       G, d);
#pragma unroll
        for (int u = 0; u < G; ++u) acc[k][u] += d[u];
      }
    }
#pragma unroll
    for (int k = 0; k < RR; ++k) {
      const int o = o0 + k * NT;
      if (o >= nr) continue;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float w =
            __fmaf_rn(alpha, acc[k][u], __fmul_rn(1.f - alpha, zv[k][u])) +
            yv[k][u];
        const float z1 = fminf(fmaxf(w, lo[k][u]), up[k][u]);
        yv[k][u] = w - z1;
        zv[k][u] = z1;
      }
      st_vec<G>(st.z + (size_t)o * G, zv[k]);
      st_vec<G>(st.y + (size_t)o * G, yv[k]);
    }
  }
  for (int o = threadIdx.x; o < nx; o += NT) {
    const int g = o / s, i = o - g * s;
    float xv[G], tv[G];
    ld_vec<G>(xt + (size_t)g * xbs + i * G, tv);
    ld_vec<G>(X + (size_t)o * G, xv);
#pragma unroll
    for (int u = 0; u < G; ++u)
      xv[u] = __fmaf_rn(alpha, tv[u], __fmul_rn(1.f - alpha, xv[u]));
    st_vec<G>(X + (size_t)o * G, xv);
  }
}

// Block j of the grid runs instances [j G, j G + G) (fewer in a partial
// last group) with kThreads threads per H = 2 halves of the group (H = 1
// for G = 1).
template <int G, int S>
__global__ void __launch_bounds__(G >= 2 ? 2 * kThreads : kThreads)
    iterate_kernel(const Params p, const CrMeta cm) {
  constexpr int H = G >= 2 ? 2 : 1, NT = kThreads * H;
  extern __shared__ __align__(16) float smem[];
  __shared__ CrLevel lv[kCrMaxLevels];
  __shared__ unsigned long long ring_bar[kRing];
  const int s = S ? S : p.s, nb = p.nb;
  const int nx = nb * s;
  const int bs = s * G + kPad;
  const bool warp_local = s * H <= 32 && 32 % (s * H) == 0;
  const bool refine = p.kkt_refine > 0;
  const size_t xw = round4((size_t)nx * G);
  float* state = smem;                         // the CR state
  float* X = state + (size_t)nb * bs;
  float* XT = refine ? X + xw : nullptr;       // the refined solution
  float* RHS = refine ? X + 2 * xw : nullptr;  // the right-hand side
  float* ring = X + (refine ? 3 : 1) * xw;
  cr_load_levels(cm, lv);
  const int tid = threadIdx.x;
  const size_t B = p.B, j0 = (size_t)blockIdx.x * G;
  const int nv = min(G, p.B - (int)j0);
  const bool full = p.vec && nv == G;
  for (int e = tid; e < nx; e += NT) {
    float v[G];
    ld_inst<G, false>(p.x + (size_t)e * B + j0, nv, full, v);
    st_vec<G>(X + (size_t)e * G, v);
  }
  // the group's z, y, l, u (r-major) and q into its stretch of the scratch
  const int R = p.r, nr = nb * R;
  float* sc = p.scr + (size_t)blockIdx.x * (4 * nr + nx) * G;
  const Rows st{sc, sc + (size_t)nr * G, sc + 2 * (size_t)nr * G,
                sc + 3 * (size_t)nr * G, sc + 4 * (size_t)nr * G};
  {
    const float* src[5] = {p.z, p.y, p.l, p.u, p.q};
    for (int a = 0; a < 5; ++a) {
      const int rows = a < 4 ? nr : nx;
      for (int e = tid; e < rows; e += NT) {
        const int o = a < 4 ? (e % R) * nb + e / R : e;
        float v[G];
        if (a < 2)  // z and y: the kernel writes them back
          ld_inst<G, false>(src[a] + (size_t)e * B + j0, nv, full, v);
        else
          ld_inst<G>(src[a] + (size_t)e * B + j0, nv, full, v);
        st_vec<G>(sc + (size_t)a * nr * G + (size_t)o * G, v);
      }
    }
  }
  if (tid == 0) ring_init(ring_bar, kRing);
  __syncthreads();

  if (p.check_interval > 0) {
    // the ring: stage n % kRing holds step n, filled by thread 0 kRing - 1
    // steps ahead and awaited on its mbarrier, whose phase n / kRing it is
    KStep cs{kAtv, 0, 0, first_step(cm.n_levels)};
    KStep is = cs;
    for (int q = 0; q < kRing - 1; ++q) {
      if (tid == 0) fetch(is, p, lv, cm.root, ring + q * p.sw, &ring_bar[q]);
      advance(is, p, lv, cm.n_levels);
    }
    for (int n = 0; cs.kind != kEnd; ++n) {
      const int buf = n % kRing, nxt = (n + kRing - 1) % kRing;
      bar_wait(&ring_bar[buf], (n / kRing) & 1);
      __syncthreads();
      if (tid == 0)
        fetch(is, p, lv, cm.root, ring + nxt * p.sw, &ring_bar[nxt]);
      advance(is, p, lv, cm.n_levels);
      if (cs.kind == kCr) {
        compute<G, S, H>(cs.cr, lv, state, ring + buf * p.sw, p.tile, s, bs,
                         warp_local);
      } else if (cs.kind == kAtv) {
        atv_pass<G, S, NT>(p, st, X, state, RHS, bs);
      } else if (cs.kind == kFold) {
        // the solve's result into the refined solution: x~ after the first
        // solve, x~ + dx after each sweep's
        for (int e = tid; e < nx; e += NT) {
          const int g = e / s, i = e - g * s;
          float a[G], t[G];
          ld_vec<G>(state + (size_t)g * bs + i * G, a);
          if (cs.solve > 0) {
            ld_vec<G>(XT + (size_t)e * G, t);
#pragma unroll
            for (int u = 0; u < G; ++u) a[u] = t[u] + a[u];
          }
          st_vec<G>(XT + (size_t)e * G, a);
        }
      } else if (cs.kind == kRes) {
        // rhs - M x~ into the CR state, for the sweep's solve
        for (int e = tid; e < nx; e += NT) {
          const int g = e / s, i = e - g * s;
          float m[G], r[G];
          btmv_glob<G, G>(p.DM, p.LM, nb, XT, s, g, i, m);
          ld_vec<G>(RHS + (size_t)e * G, r);
#pragma unroll
          for (int u = 0; u < G; ++u) r[u] = r[u] - m[u];
          st_vec<G>(state + (size_t)g * bs + i * G, r);
        }
      } else {
        if (refine)
          av_pass<G, S, NT>(p, st, XT, s * G, X);
        else
          av_pass<G, S, NT>(p, st, state, bs, X);
      }
      advance(cs, p, lv, cm.n_levels);
    }
    __syncthreads();
  }
  for (int e = tid; e < nx; e += NT) {
    float v[G];
    ld_vec<G>(X + (size_t)e * G, v);
    st_inst<G>(p.x + (size_t)e * B + j0, nv, full, v);
  }
  for (int e = tid; e < nr; e += NT) {
    const int o = (e % R) * nb + e / R;
    float v[G];
    ld_vec<G>(st.z + (size_t)o * G, v);
    st_inst<G>(p.z + (size_t)e * B + j0, nv, full, v);
    ld_vec<G>(st.y + (size_t)o * G, v);
    st_inst<G>(p.y + (size_t)e * B + j0, nv, full, v);
  }
}

template <int G>
cudaError_t launch(const Params& p, const CrMeta& cm, size_t smem,
                   cudaStream_t stream) {
  const int grid = (p.B + G - 1) / G;
  const void* fn = p.s == 8 ? (const void*)iterate_kernel<G, 8>
                            : (const void*)iterate_kernel<G, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = G >= 2 ? 2 * kThreads : kThreads;
  if (p.s == 8)
    iterate_kernel<G, 8><<<grid, threads, smem, stream>>>(p, cm);
  else
    iterate_kernel<G, 0><<<grid, threads, smem, stream>>>(p, cm);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one K11 block (ops/banded_shared_kernel.py::
// iterate_smem_bytes mirrors it), or 0 when it does not fit beside the
// block's static shared memory.
extern "C" long long banded_iterate_smem_bytes(int nb, int s, int group,
                                               int tile, int kkt_refine) {
  const size_t bytes = 4 * smem_words(nb, s, group, tile, kkt_refine);
  return bytes + kStaticBytes <= kSmemLimit ? (long long)bytes : 0;
}

// Launches kernel K11 on `stream`: `group` instances per thread block (1,
// 2, 4 or 8), CR steps of at most `tile` block pairs; `meta` is the host
// int array of cr_meta_array.  DM and LM may be null when kkt_refine is 0.
// x, z, y are updated in place.  Returns the CUDA error code (0 =
// success).
extern "C" int banded_iterate_f32(
    const float* fac, const float* B0, const float* B1, const float* B0r,
    const float* B1r, const float* DM, const float* LM, const float* q,
    const float* l, const float* u, float* x, float* z, float* y,
    float* scratch, const int* meta, int B, int nb, int s, int r_max,
    int check_interval, int kkt_refine, float sigma, float alpha, int group,
    int tile, void* stream) {
  CrMeta cm;
  if (B <= 0 || r_max <= 0 || check_interval < 0 || kkt_refine < 0 ||
      !cr_meta_from(meta, &cm) || cm.nb != nb || cm.s != s || s % 4 != 0 ||
      tile < 1 ||
      (long long)tile * s > (long long)kPairsPerThread * kThreads ||
      (kkt_refine > 0 && (!DM || (nb > 1 && !LM))) ||
      (uintptr_t)fac % 16 || (uintptr_t)B0 % 16 || (uintptr_t)B1 % 16 ||
      (uintptr_t)B0r % 16 || (uintptr_t)B1r % 16 || (uintptr_t)DM % 16 ||
      (uintptr_t)LM % 16 || !scratch || (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      banded_iterate_smem_bytes(nb, s, group, tile, kkt_refine);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const int lanes = group < 4 ? group : 4;
  const int vec = B % lanes == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)l % 16 == 0 && (uintptr_t)u % 16 == 0 &&
                  (uintptr_t)x % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  Params p{fac,   B0,    B1,   B0r, B1r,   DM, LM, q, l, u, x, z, y,
           scratch, B, nb, s, r_max, check_interval, kkt_refine,
           sigma, alpha, tile, (int)stage_words(s, tile), vec};
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return (int)launch<1>(p, cm, (size_t)smem, st);
    case 2: return (int)launch<2>(p, cm, (size_t)smem, st);
    case 4: return (int)launch<4>(p, cm, (size_t)smem, st);
    case 8: return (int)launch<8>(p, cm, (size_t)smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
