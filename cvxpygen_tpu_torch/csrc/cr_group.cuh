// The grouped cyclic-reduction (CR) solve of kernels K4 (cr_solve.cu) and
// K5 (banded_chunk.cu): x = M^-1 b for one shared block-tridiagonal SPD M,
// given its packed factor (csrc/cr.cuh's layout and level table), for a
// group of G instances per thread block whose state lives in shared memory.
//
// - State.  One nb * s buffer per instance, interleaved so that the G
//   instances of an element are adjacent (a G-wide vector: one 16-byte
//   access for G = 4), with kPad words between blocks to spread the blocks
//   of a level over the banks: element (block P, row i, instance u) at
//   P * bs + i * G + u, bs = s * G + kPad.
// - In-place strided cyclic reduction.  Level k works on the blocks at
//   stride 2^k: its block m sits at m << k.  The forward sweep writes b'_t
//   into the even block 2t (which is block t of the next level) and leaves
//   the odd block 2t + 1 in place: the odd blocks are the stack.  The root
//   solve leaves x_0 at block 0.  The backward sweep writes
//   x_{2t+1} = Dinv_t (b_{2t+1} - L_even_t x_2t - L_left_t' x_{2t+2})
//   over the odd block, whose even neighbours already hold x.  The padding
//   block of an odd level (zero in the reference) is skipped: nothing reads
//   its x.
// - The factor through shared memory.  The work is a sequence of steps: a
//   tile of up to `tile` consecutive block pairs t of one level and sweep
//   (forward: A_{t-1} and C_t; the root; backward: L_even_t, L_left_t and
//   Dinv_t).  fetch_step names the runs of a step's blocks for a stage of
//   kSlots * tile * s * s words, and the kernel copies them into a ring of
//   stages ahead of their use (K4: 16-byte cp.async by every thread, three
//   stages; K5: bulk copies by one thread, two), so the dependent chain
//   sees shared-memory latency and one block barrier per step.
// - Threads.  H threads (1 in K4, 2 in K5) take each of up to
//   kPairsPerThread (block, row) pairs of a step, each for G / H of the
//   instances: a thread loads each factor row once (four floats at a time)
//   and applies it to its instances from registers.  The threads of a
//   block's s rows sit in one warp when they divide 32, so the backward
//   sweep's in-place Dinv product and the root's need only __syncwarp;
//   above that they take block barriers.
// - Order.  Every dot product runs in j order from zero by fmaf, and each
//   row subtracts them in the order of csrc/cr.cuh's cr_solve_block (even
//   block, then A_{t-1} b_{2t-1}, then C_t b_{2t+1}; then L_even, then
//   L_left'), so an instance's result does not depend on G and equals the
//   one-instance solve's to the bit.  No atomics.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "cr.cuh"

namespace cvxk {

constexpr int kSlots = 3;           // factor kinds a step reads
constexpr int kPairsPerThread = 2;  // (block, row) pairs per thread and step
constexpr int kPad = 4;             // words between two state blocks

enum { kFwd = 0, kRoot = 1, kBwd = 2, kDone = 3 };

// A step of the sweep: forward or backward at level k over the block pairs
// [t0, t0 + tile) of that level, or the root.
struct Step {
  int phase, k, t0;
};

__device__ __forceinline__ Step first_step(int n_levels) {
  return Step{n_levels ? kFwd : kRoot, 0, 0};
}

__device__ __forceinline__ void next_step(Step& st, const CrLevel* lv,
                                          int n_levels, int tile) {
  if (st.phase == kFwd) {
    st.t0 += tile;
    if (st.t0 >= lv[st.k].n2) {
      st.t0 = 0;
      if (++st.k == n_levels) st.phase = kRoot;
    }
  } else if (st.phase == kRoot) {
    st.phase = n_levels ? kBwd : kDone;
    st.k = n_levels - 1;
    st.t0 = 0;
  } else if (st.phase == kBwd) {
    st.t0 += tile;
    if (st.t0 >= lv[st.k].n2) {
      st.t0 = 0;
      if (--st.k < 0) st.phase = kDone;
    }
  }
}

// The copies of step `st`'s factor blocks into `stage` (slot q at
// q * tile * ss; the block of pair t at (t - t0) * ss), none when the sweep
// is done: copy(dst, src, n) for each run of n consecutive floats.
template <class Copy>
__device__ __forceinline__ void fetch_step(const Step& st, const CrLevel* lv,
                                           int root,
                                           const float* __restrict__ fac,
                                           float* stage, int tile, int ss,
                                           Copy&& copy) {
  if (st.phase == kFwd || st.phase == kBwd) {
    const CrLevel L = lv[st.k];
    const int t0 = st.t0, t1 = min(t0 + tile, L.n2);
    if (st.phase == kFwd) {
      const int lo = max(t0, 1), hi = min(t1, L.nA + 1);
      if (hi > lo)
        copy(stage + (lo - t0) * ss, fac + (size_t)(L.oA + lo - 1) * ss,
             (hi - lo) * ss);
      copy(stage + tile * ss, fac + (size_t)(L.oC + t0) * ss, (t1 - t0) * ss);
    } else {
      copy(stage, fac + (size_t)(L.oLe + t0) * ss, (t1 - t0) * ss);
      const int hi = min(t1, L.nLl);
      if (hi > t0)
        copy(stage + tile * ss, fac + (size_t)(L.oLl + t0) * ss,
             (hi - t0) * ss);
      copy(stage + 2 * tile * ss, fac + (size_t)(L.oD + t0) * ss,
           (t1 - t0) * ss);
    }
  } else if (st.phase == kRoot) {
    copy(stage, fac + (size_t)root * ss, ss);
  }
}

// G-wide vectors of adjacent instances
template <int G>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[G]) {
  if constexpr (G == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (G == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (G == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = p[0];
  }
}

template <int G>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[G]) {
  if constexpr (G == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// acc[u] = sum_j w[j] x[j][u] in j order from zero: w one factor row (s
// floats, 16-byte aligned, in shared memory), x W-wide vectors xs words
// apart (element j at j * xs)
template <int W>
__device__ __forceinline__ void dot_row(const float* w, const float* x, int s,
                                        int xs, float (&acc)[W]) {
#pragma unroll
  for (int u = 0; u < W; ++u) acc[u] = 0.f;
  for (int j = 0; j < s; j += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + j);
    const float wj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[W];
      ld_vec<W>(x + (j + q) * xs, v);
#pragma unroll
      for (int u = 0; u < W; ++u) acc[u] = fmaf(wj[q], v[u], acc[u]);
    }
  }
}

// the same over n terms with w a column, ld words between its entries
template <int W>
__device__ __forceinline__ void dot_col(const float* w, int ld,
                                        const float* x, int n, int xs,
                                        float (&acc)[W]) {
#pragma unroll
  for (int u = 0; u < W; ++u) acc[u] = 0.f;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float wj = w[j * ld];
    float v[W];
    ld_vec<W>(x + j * xs, v);
#pragma unroll
    for (int u = 0; u < W; ++u) acc[u] = fmaf(wj, v[u], acc[u]);
  }
}

// the barrier between reading a block's rows and overwriting them: the
// threads of its s rows are in one warp when they divide 32 (the caller
// passes the same `warp_local` to every thread)
__device__ __forceinline__ void rows_sync(bool warp_local) {
  if (warp_local)
    __syncwarp();
  else
    __syncthreads();
}

// One step on the state (element (block P, row i, instance u) at
// P * bs + i * G + u) with the step's factor blocks in `stage`.  H threads
// share a (block, row) pair, each applying its rows to G / H of the
// instances (u from (threadIdx.x % H) * G / H); the block has H * kThreads
// threads.
template <int G, int S, int H = 1>
__device__ __forceinline__ void compute(const Step& st, const CrLevel* lv,
                                        float* state, const float* stage,
                                        int tile, int s_run, int bs,
                                        bool warp_local) {
  constexpr int W = G / H;
  const int s = S ? S : s_run, ss = s * s;
  const int pid = threadIdx.x / H, u0 = (threadIdx.x % H) * W;
  if (st.phase == kRoot) {
    // x_0 = Root b'_0 over block 0, in place
    const int i = pid;
    float y[W];
    if (i < s) dot_row<W>(stage + i * s, state + u0, s, G, y);
    rows_sync(warp_local);
    if (i < s) st_vec<W>(state + i * G + u0, y);
    return;
  }
  const CrLevel L = lv[st.k];
  const int k = st.k, t0 = st.t0, t1 = min(t0 + tile, L.n2);
  const int npairs = (t1 - t0) * s;
  if (st.phase == kFwd) {
    const float* sA = stage;
    const float* sC = stage + tile * ss;
#pragma unroll
    for (int p = 0; p < kPairsPerThread; ++p) {
      const int o = pid + p * kThreads;
      if (o >= npairs) continue;
      const int tl = o / s, i = o - tl * s, t = t0 + tl;
      float* ev = state + (size_t)((2 * t) << k) * bs + i * G + u0;
      float acc[W], d[W];
      ld_vec<W>(ev, acc);
      if (t >= 1 && t - 1 < L.nA) {
        dot_row<W>(sA + tl * ss + i * s,
                   state + (size_t)((2 * t - 1) << k) * bs + u0, s, G, d);
#pragma unroll
        for (int u = 0; u < W; ++u) acc[u] -= d[u];
      }
      if (2 * t + 1 < L.nb_in) {
        dot_row<W>(sC + tl * ss + i * s,
                   state + (size_t)((2 * t + 1) << k) * bs + u0, s, G, d);
#pragma unroll
        for (int u = 0; u < W; ++u) acc[u] -= d[u];
      }
      st_vec<W>(ev, acc);
    }
    return;
  }
  // backward: r = b_odd - L_even x_2t - L_left' x_{2t+2} over the odd
  // block's own row, then x_odd = Dinv r over the whole block, in place
  const float* sLe = stage;
  const float* sLl = stage + tile * ss;
  const float* sD = stage + 2 * tile * ss;
  float y[kPairsPerThread][W];
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const int o = pid + p * kThreads;
    if (o >= npairs) continue;
    const int tl = o / s, i = o - tl * s, t = t0 + tl;
    if (2 * t + 1 >= L.nb_in) continue;  // the padding block
    float* od = state + (size_t)((2 * t + 1) << k) * bs + i * G + u0;
    float r[W], d[W];
    ld_vec<W>(od, r);
    dot_row<W>(sLe + tl * ss + i * s,
               state + (size_t)((2 * t) << k) * bs + u0, s, G, d);
#pragma unroll
    for (int u = 0; u < W; ++u) r[u] -= d[u];
    if (t < L.nLl) {
      dot_col<W>(sLl + tl * ss + i, s,
                 state + (size_t)((2 * t + 2) << k) * bs + u0, s, G, d);
#pragma unroll
      for (int u = 0; u < W; ++u) r[u] -= d[u];
    }
    st_vec<W>(od, r);
  }
  rows_sync(warp_local);
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const int o = pid + p * kThreads;
    if (o >= npairs) continue;
    const int tl = o / s, i = o - tl * s, t = t0 + tl;
    if (2 * t + 1 >= L.nb_in) continue;
    dot_row<W>(sD + tl * ss + i * s,
               state + (size_t)((2 * t + 1) << k) * bs + u0, s, G, y[p]);
  }
  rows_sync(warp_local);
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const int o = pid + p * kThreads;
    if (o >= npairs) continue;
    const int tl = o / s, i = o - tl * s, t = t0 + tl;
    if (2 * t + 1 >= L.nb_in) continue;
    st_vec<W>(state + (size_t)((2 * t + 1) << k) * bs + i * G + u0, y[p]);
  }
}

}  // namespace cvxk
