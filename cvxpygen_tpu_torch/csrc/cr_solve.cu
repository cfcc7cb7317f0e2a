// Kernel K4: x = M^-1 b for one shared block-tridiagonal SPD M, given its
// packed cyclic-reduction factor, for B right-hand sides.
//
// Replaces cvxpygen_tpu/ops/banded_shared_kernel.py::_cr_solve_only_kernel
// (the Pallas TPU kernel; wrapper cr_solve_pallas) and computes the same
// function in the same layout: b and x are (nb, s, B), one instance per
// column.  Its plain torch version is cr_solve_plain in
// cvxpygen_tpu_torch/ops/banded_shared_kernel.py, which also builds and
// binds this file (nvcc for sm_90a, ctypes) and picks the launch plan
// (cr_launch_plan).  The shared-KKT banded solve loop for nb > 96
// (solvers/admm_banded_shared.py::_impl_crk) launches it once per ADMM
// iteration.
//
// What bounds it.  At the charging T=1440 shape (nb=541, s=8, 2711 packed
// blocks, B=256) the kernel must read b and write x, 2 * 4328 * 256 floats
// (8.9 MB), and read the 0.69 MB factor once: about 3 us at 3.35 TB/s.  Its
// 2 * 64 * 2711 FLOP per instance (89 MFLOP in all) take about 1.3 us at
// the FP32 peak.  So it is bytes-bound on paper; in practice the chain of
// dependent levels (ten forward, the root, ten backward at charging) and
// the factor's trips from L2 set its time.
//
// Design.  As in the TPU kernel, instances share the factor: a thread block
// takes a group of G consecutive instances (G = 1, 2, 4 or 8, the
// wrapper's rule) and reads the factor once for all of them, so the L2
// traffic for the factor is B / G times 0.69 MB.
// - State.  One nb * s buffer per instance, interleaved so that the G
//   instances of an element are adjacent (a G-wide vector: one 16-byte
//   access for G = 4), with kPad words between blocks to spread the
//   blocks of a level over the banks.  b comes in by cp.async with the
//   first step's factor blocks, and x goes out, as G-wide vectors of
//   adjacent instances.
// - In-place strided cyclic reduction.  Level k works on the blocks at
//   stride 2^k: its block m sits at m << k.  The forward sweep writes b'_t
//   into the even block 2t (which is block t of the next level) and leaves
//   the odd block 2t + 1 in place: the odd blocks are the stack.  The root
//   solve leaves x_0 at block 0.  The backward sweep writes
//   x_{2t+1} = Dinv_t (b_{2t+1} - L_even_t x_2t - L_left_t' x_{2t+2})
//   over the odd block, whose even neighbours already hold x.  The padding
//   block of an odd level (zero in the reference) is skipped: nothing
//   reads its x.
// - The factor through shared memory.  The work is a sequence of steps: a
//   tile of up to `tile` consecutive block pairs t of one level and sweep
//   (forward: A_{t-1} and C_t; the root; backward: L_even_t, L_left_t and
//   Dinv_t).  The blocks a step needs come in by 16-byte cp.async two steps
//   ahead, into a ring of three stages, so the dependent chain sees
//   shared-memory latency and one block barrier per step.
// - Threads.  Each thread takes up to kPairsPerThread (block, row) pairs
//   of a step, loads each factor row once (four floats at a time) and
//   applies it to the G instances from registers.  The s rows of a block
//   sit in one warp when s divides 32 (every s <= 32 that analyze_banded
//   picks), so the backward sweep's in-place Dinv product and the root's
//   need only __syncwarp; above that they take block barriers.  s = 8 (the
//   charging family's) is compiled as a constant, other sizes at run time.
// - Order.  Every dot product runs in j order from zero by fmaf, and each
//   row subtracts them in the order of csrc/cr.cuh (even block, then
//   A_{t-1} b_{2t-1}, then C_t b_{2t+1}; then L_even, then L_left'), so an
//   instance's result does not depend on G.  No atomics: two calls give the
//   same bits.  FP32 FMA, no tensor cores (8 x 8 blocks at charging).
// Kernels K5 and K11 keep csrc/cr.cuh's one-instance solve.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cr.cuh"

namespace {

using namespace cvxk;

constexpr size_t kSmemLimit = 232448;
constexpr int kStages = 3;          // factor tiles: the one in use, two ahead
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

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g));
}

// G adjacent floats (4 G bytes, aligned to them) by cp.async
template <int G>
__device__ __forceinline__ void cp_async_vec(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  if constexpr (G >= 4) {
#pragma unroll
    for (int q = 0; q < G / 4; ++q)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       sa + 16 * q),
                   "l"(g + 4 * q));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa),
                 "l"(g), "n"(4 * G));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// nblk consecutive s x s blocks of the factor into shared memory (s * s is
// a multiple of 16, so every block is whole 16-byte lines)
__device__ __forceinline__ void copy_blocks(float* dst, const float* src,
                                            int nblk, int ss) {
  const int n4 = nblk * ss / 4;
  for (int c = threadIdx.x; c < n4; c += kThreads)
    cp_async16(dst + 4 * c, src + 4 * c);
}

// Starts the copies of step `st`'s factor blocks into `stage` (slot q at
// q * tile * ss; the block of pair t at (t - t0) * ss) and commits them as
// one group (an empty one when the sweep is done).
__device__ void fetch_step(const Step& st, const CrLevel* lv, int root,
                           const float* __restrict__ fac, float* stage,
                           int tile, int ss) {
  if (st.phase == kFwd || st.phase == kBwd) {
    const CrLevel L = lv[st.k];
    const int t0 = st.t0, t1 = min(t0 + tile, L.n2);
    if (st.phase == kFwd) {
      const int lo = max(t0, 1), hi = min(t1, L.nA + 1);
      if (hi > lo)
        copy_blocks(stage + (lo - t0) * ss, fac + (size_t)(L.oA + lo - 1) * ss,
                    hi - lo, ss);
      copy_blocks(stage + tile * ss, fac + (size_t)(L.oC + t0) * ss, t1 - t0,
                  ss);
    } else {
      copy_blocks(stage, fac + (size_t)(L.oLe + t0) * ss, t1 - t0, ss);
      const int hi = min(t1, L.nLl);
      if (hi > t0)
        copy_blocks(stage + tile * ss, fac + (size_t)(L.oLl + t0) * ss,
                    hi - t0, ss);
      copy_blocks(stage + 2 * tile * ss, fac + (size_t)(L.oD + t0) * ss,
                  t1 - t0, ss);
    }
  } else if (st.phase == kRoot) {
    copy_blocks(stage, fac + (size_t)root * ss, 1, ss);
  }
  cp_async_commit();
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
// floats, 16-byte aligned, in shared memory), x one state block (element j
// at j * G)
template <int G>
__device__ __forceinline__ void dot_row(const float* w, const float* x, int s,
                                        float (&acc)[G]) {
#pragma unroll
  for (int u = 0; u < G; ++u) acc[u] = 0.f;
  for (int j = 0; j < s; j += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + j);
    const float wj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[G];
      ld_vec<G>(x + (j + q) * G, v);
#pragma unroll
      for (int u = 0; u < G; ++u) acc[u] = fmaf(wj[q], v[u], acc[u]);
    }
  }
}

// the same with w a column: w[j * s]
template <int G>
__device__ __forceinline__ void dot_col(const float* w, const float* x, int s,
                                        float (&acc)[G]) {
#pragma unroll
  for (int u = 0; u < G; ++u) acc[u] = 0.f;
#pragma unroll 4
  for (int j = 0; j < s; ++j) {
    const float wj = w[j * s];
    float v[G];
    ld_vec<G>(x + j * G, v);
#pragma unroll
    for (int u = 0; u < G; ++u) acc[u] = fmaf(wj, v[u], acc[u]);
  }
}

// the barrier between reading a block's rows and overwriting them: its s
// rows are in one warp when s divides 32 (the caller passes the same
// `warp_local` to every thread)
__device__ __forceinline__ void rows_sync(bool warp_local) {
  if (warp_local)
    __syncwarp();
  else
    __syncthreads();
}

// One step on the state (element (block P, row i, instance u) at
// P * bs + i * G + u) with the step's factor blocks in `stage`.
template <int G, int S>
__device__ __forceinline__ void compute(const Step& st, const CrLevel* lv,
                                        float* state, const float* stage,
                                        int tile, int s_run, int bs,
                                        bool warp_local) {
  const int s = S ? S : s_run, ss = s * s;
  if (st.phase == kRoot) {
    // x_0 = Root b'_0 over block 0, in place
    const int i = threadIdx.x;
    float y[G];
    if (i < s) dot_row<G>(stage + i * s, state, s, y);
    rows_sync(warp_local);
    if (i < s) st_vec<G>(state + i * G, y);
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
      const int o = threadIdx.x + p * kThreads;
      if (o >= npairs) continue;
      const int tl = o / s, i = o - tl * s, t = t0 + tl;
      float* ev = state + (size_t)((2 * t) << k) * bs + i * G;
      float acc[G], d[G];
      ld_vec<G>(ev, acc);
      if (t >= 1 && t - 1 < L.nA) {
        dot_row<G>(sA + tl * ss + i * s,
                   state + (size_t)((2 * t - 1) << k) * bs, s, d);
#pragma unroll
        for (int u = 0; u < G; ++u) acc[u] -= d[u];
      }
      if (2 * t + 1 < L.nb_in) {
        dot_row<G>(sC + tl * ss + i * s,
                   state + (size_t)((2 * t + 1) << k) * bs, s, d);
#pragma unroll
        for (int u = 0; u < G; ++u) acc[u] -= d[u];
      }
      st_vec<G>(ev, acc);
    }
    return;
  }
  // backward: r = b_odd - L_even x_2t - L_left' x_{2t+2} over the odd
  // block's own row, then x_odd = Dinv r over the whole block, in place
  const float* sLe = stage;
  const float* sLl = stage + tile * ss;
  const float* sD = stage + 2 * tile * ss;
  float y[kPairsPerThread][G];
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const int o = threadIdx.x + p * kThreads;
    if (o >= npairs) continue;
    const int tl = o / s, i = o - tl * s, t = t0 + tl;
    if (2 * t + 1 >= L.nb_in) continue;  // the padding block
    float* od = state + (size_t)((2 * t + 1) << k) * bs + i * G;
    float r[G], d[G];
    ld_vec<G>(od, r);
    dot_row<G>(sLe + tl * ss + i * s, state + (size_t)((2 * t) << k) * bs, s,
               d);
#pragma unroll
    for (int u = 0; u < G; ++u) r[u] -= d[u];
    if (t < L.nLl) {
      dot_col<G>(sLl + tl * ss + i, state + (size_t)((2 * t + 2) << k) * bs,
                 s, d);
#pragma unroll
      for (int u = 0; u < G; ++u) r[u] -= d[u];
    }
    st_vec<G>(od, r);
  }
  rows_sync(warp_local);
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const int o = threadIdx.x + p * kThreads;
    if (o >= npairs) continue;
    const int tl = o / s, i = o - tl * s, t = t0 + tl;
    if (2 * t + 1 >= L.nb_in) continue;
    dot_row<G>(sD + tl * ss + i * s, state + (size_t)((2 * t + 1) << k) * bs,
               s, y[p]);
  }
  rows_sync(warp_local);
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const int o = threadIdx.x + p * kThreads;
    if (o >= npairs) continue;
    const int tl = o / s, i = o - tl * s, t = t0 + tl;
    if (2 * t + 1 >= L.nb_in) continue;
    st_vec<G>(state + (size_t)((2 * t + 1) << k) * bs + i * G, y[p]);
  }
}

// Block j of the grid solves instances [j * G, j * G + G) (fewer in a
// partial last group).  `vec`: b and x take G-wide global accesses (16-byte
// aligned pointers and B a multiple of min(G, 4)).
template <int G, int S>
__global__ void __launch_bounds__(kThreads)
    cr_solve_kernel(const float* __restrict__ fac, const float* __restrict__ b,
                    float* __restrict__ x, int B, const CrMeta cm, int tile,
                    int vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ CrLevel lv[kCrMaxLevels];
  const int s = S ? S : cm.s, ss = s * s, nb = cm.nb, nbs = nb * s;
  const int bs = s * G + kPad;
  const bool warp_local = s <= 32 && 32 % s == 0;
  float* state = smem;
  float* stages = smem + (size_t)nb * bs;
  const int stage_words = kSlots * tile * ss;
  cr_load_levels(cm, lv);
  // b in: a full group by cp.async (committed with step 0's factor
  // blocks), a partial one through registers
  const int j0 = blockIdx.x * G;
  const int nv = min(G, B - j0);
  const bool full = vec && nv == G;
  for (int e = threadIdx.x; e < nbs; e += kThreads) {
    const int blk = e / s, i = e - blk * s;
    const float* src = b + (size_t)e * B + j0;
    float* dst = state + (size_t)blk * bs + i * G;
    if (full) {
      cp_async_vec<G>(dst, src);
    } else {
      float v[G];
#pragma unroll
      for (int u = 0; u < G; ++u) v[u] = u < nv ? src[u] : 0.f;
      st_vec<G>(dst, v);
    }
  }
  __syncthreads();
  Step is = first_step(cm.n_levels);
  fetch_step(is, lv, cm.root, fac, stages, tile, ss);
  next_step(is, lv, cm.n_levels, tile);
  fetch_step(is, lv, cm.root, fac, stages + stage_words, tile, ss);
  next_step(is, lv, cm.n_levels, tile);

  Step cs = first_step(cm.n_levels);
  int buf = 0;
  while (cs.phase != kDone) {
    cp_async_wait_one();
    __syncthreads();
    int nxt = buf + 2;
    if (nxt >= kStages) nxt -= kStages;
    fetch_step(is, lv, cm.root, fac, stages + nxt * stage_words, tile, ss);
    next_step(is, lv, cm.n_levels, tile);
    compute<G, S>(cs, lv, state, stages + buf * stage_words, tile, s, bs,
                  warp_local);
    next_step(cs, lv, cm.n_levels, tile);
    if (++buf == kStages) buf = 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nbs; e += kThreads) {
    const int blk = e / s, i = e - blk * s;
    float* dst = x + (size_t)e * B + j0;
    float v[G];
    ld_vec<G>(state + (size_t)blk * bs + i * G, v);
    if (full) {
      st_vec<G>(dst, v);
    } else {
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (u < nv) dst[u] = v[u];
    }
  }
}

// Bytes of dynamic shared memory of a launch: the state and the stages.
size_t smem_bytes(int nb, int s, int group, int tile) {
  return 4 * ((size_t)nb * (s * group + kPad) +
              (size_t)kStages * kSlots * tile * s * s);
}

// the block size of the charging family (s = 8) compiled as a constant
template <int G>
cudaError_t launch(const float* fac, const float* b, float* x, int B,
                   const CrMeta& cm, int tile, size_t smem,
                   cudaStream_t stream) {
  const int vec = (B % (G < 4 ? G : 4) == 0) &&
                  ((uintptr_t)b % 16 == 0) && ((uintptr_t)x % 16 == 0);
  const int grid = (B + G - 1) / G;
  if (cm.s == 8)
    cr_solve_kernel<G, 8><<<grid, kThreads, smem, stream>>>(fac, b, x, B, cm,
                                                            tile, vec);
  else
    cr_solve_kernel<G, 0><<<grid, kThreads, smem, stream>>>(fac, b, x, B, cm,
                                                            tile, vec);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a launch needs (ops/banded_shared_kernel.py::
// cr_launch_plan mirrors it), or 0 when it does not fit.
extern "C" long long cr_solve_smem_bytes(int nb, int s, int group, int tile) {
  const size_t bytes = smem_bytes(nb, s, group, tile);
  return bytes + sizeof(CrLevel) * kCrMaxLevels <= kSmemLimit
             ? (long long)bytes
             : 0;
}

// Lets every group size take up to the per-block limit of dynamic shared
// memory on the current device; the wrapper calls it once per device.
extern "C" int cr_solve_init() {
  const int bytes = (int)(kSmemLimit - sizeof(CrLevel) * kCrMaxLevels);
  cudaError_t err = cudaSuccess;
  const void* fns[] = {
      (const void*)cr_solve_kernel<1, 8>, (const void*)cr_solve_kernel<2, 8>,
      (const void*)cr_solve_kernel<4, 8>, (const void*)cr_solve_kernel<8, 8>,
      (const void*)cr_solve_kernel<1, 0>, (const void*)cr_solve_kernel<2, 0>,
      (const void*)cr_solve_kernel<4, 0>, (const void*)cr_solve_kernel<8, 0>};
  for (const void* fn : fns) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches kernel K4 on `stream`: `group` instances per thread block (1, 2,
// 4 or 8), steps of at most `tile` block pairs; `meta` is the host int
// array of cr_meta_array.  Returns the CUDA error code (0 = success).
extern "C" int cr_solve_f32(const float* fac, const float* b, float* x, int B,
                            const int* meta, int group, int tile,
                            void* stream) {
  CrMeta cm;
  if (B <= 0 || !cr_meta_from(meta, &cm) || cm.s % 4 != 0 || tile < 1 ||
      (long long)tile * cm.s > (long long)kPairsPerThread * kThreads ||
      (uintptr_t)fac % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = cr_solve_smem_bytes(cm.nb, cm.s, group, tile);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return (int)launch<1>(fac, b, x, B, cm, tile, smem, st);
    case 2: return (int)launch<2>(fac, b, x, B, cm, tile, smem, st);
    case 4: return (int)launch<4>(fac, b, x, B, cm, tile, smem, st);
    case 8: return (int)launch<8>(fac, b, x, B, cm, tile, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
