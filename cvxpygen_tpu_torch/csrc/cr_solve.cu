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
// takes a group of G consecutive instances (G = 1, 2, 4 or 8, the wrapper's
// rule) and reads the factor once for all of them, so the L2 traffic for the
// factor is B / G times 0.69 MB.  The solve is csrc/cr_group.cuh's (one
// in-place strided CR state per instance, the factor staged by cp.async two
// steps ahead), which kernels K5 and K11 share; b comes in by cp.async with
// the first step's factor blocks, and x goes out, as G-wide vectors of
// adjacent instances.  s = 8 (the charging family's) is compiled as a
// constant, other sizes at run time.  An instance's x does not depend on G,
// and two calls give the same bits.  FP32 FMA, no tensor cores (8 x 8 blocks
// at charging).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cr_group.cuh"

namespace {

using namespace cvxk;

constexpr size_t kSmemLimit = 232448;
constexpr int kStages = 3;  // factor tiles: the one in use, two ahead

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

// n consecutive floats (a multiple of 4, 16-byte aligned) into shared
// memory by cp.async, by the kThreads threads of the block
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n) {
  for (int c = threadIdx.x; c < n / 4; c += kThreads)
    cp_async16(dst + 4 * c, src + 4 * c);
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
  fetch_step(is, lv, cm.root, fac, stages, tile, ss, copy_floats);
  cp_async_commit();
  next_step(is, lv, cm.n_levels, tile);
  fetch_step(is, lv, cm.root, fac, stages + stage_words, tile, ss,
             copy_floats);
  cp_async_commit();
  next_step(is, lv, cm.n_levels, tile);

  Step cs = first_step(cm.n_levels);
  int buf = 0;
  while (cs.phase != kDone) {
    cp_async_wait_one();
    __syncthreads();
    int nxt = buf + 2;
    if (nxt >= kStages) nxt -= kStages;
    fetch_step(is, lv, cm.root, fac, stages + nxt * stage_words, tile, ss,
               copy_floats);
    cp_async_commit();
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
