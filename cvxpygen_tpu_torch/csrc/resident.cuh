// Building blocks of the kernels that keep one instance's matrices resident
// in the shared memory of a team of c thread blocks (K2's resident branch,
// K3): the split of a matrix's rows over the team, a copy of a row slice
// from global into shared memory with cp.async (once per launch or per
// factorization), and the matrix-vector products on the resident rows.
// Every kernel that includes this file launches blocks of kThreads threads.
// Full float32 FMA: no TF32, no fast math.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gemm.cuh"

namespace cvxk {

// the largest team: one instance's rows over at most 8 thread blocks
constexpr int kMaxTeam = 8;

struct Rows {
  int lo, hi;
};

// rows [lo, hi) of d that block `rank` of a team of c holds: ceil(d / c)
// each, the last block the rest
__host__ __device__ inline Rows team_rows(int d, int c, int rank) {
  const int per = (d + c - 1) / c;
  const int lo = per * rank < d ? per * rank : d;
  return Rows{lo, lo + per < d ? lo + per : d};
}

// words a resident slice of `rows` rows of width `n` takes in shared memory:
// the rows, three words of slack for load_slice's alignment, rounded up to
// whole 16-byte lines
__host__ __device__ inline size_t slice_words(int rows, int n) {
  return (((size_t)rows * n + 3) + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(g));
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Start the copy of `count` floats from g (global) into shared memory at
// buf + shift, where shift (0-3) is g's float offset within its 16-byte
// line, so that source and destination share their alignment: 16-byte
// cp.async for the aligned body, 4-byte ones for the ragged head and tail.
// buf is 16-byte aligned with slice_words room.  Returns buf + shift.  The
// caller waits (cp_async_wait_all) and synchronizes before reading.
__device__ __forceinline__ float* load_slice(float* buf, const float* g,
                                             int count) {
  const int shift = (int)(((uintptr_t)g >> 2) & 3);
  float* s = buf + shift;
  const int head = min(count, (4 - shift) & 3);
  const int body = (count - head) & ~3;
  for (int e = threadIdx.x; e < head; e += kThreads) cp_async4(s + e, g + e);
  for (int e = head + 4 * (int)threadIdx.x; e < head + body; e += 4 * kThreads)
    cp_async16(s + e, g + e);
  for (int e = head + body + threadIdx.x; e < count; e += kThreads)
    cp_async4(s + e, g + e);
  return s;
}

// y(i) = epi(i, sum_j W(i, j) x(j)) for i < R: W (R x K, row stride ld) and
// x both in shared memory.  One warp per row, lanes over j (consecutive
// words: no bank conflicts), eight rows per warp at a time so that the
// loads and the shuffle reductions of independent sums overlap (a block
// has only eight warps to hide latency with); epi runs on lane 0.  No
// barrier.
template <typename Epi>
__device__ __forceinline__ void srowdot(const float* W, int ld,
                                        const float* x, int R, int K,
                                        Epi epi) {
  constexpr int kRows = 8, kW = kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i0 = warp; i0 < R; i0 += kRows * kW) {
    float a[kRows];
    const float* w[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a[r] = 0.f;
      const int i = i0 + r * kW;
      w[r] = W + (size_t)(i < R ? i : i0) * ld;
    }
    for (int j = lane; j < K; j += 32) {
      const float xj = x[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = fmaf(w[r][j], xj, a[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = warp_sum(a[r]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (i0 + r * kW < R) epi(i0 + r * kW, a[r]);
    }
  }
}

// out(r, j) = sum_i v(r, i) W(i, j) for j < K, r < NV: the partial v'W over
// the R resident rows of W (row stride ld) in shared memory, v (NV x R,
// row stride ldv) too.  One thread per column (consecutive words: no bank
// conflicts); four running sums per vector (rows i mod 4, the ragged tail
// in the first) keep four loads and multiply-adds in flight, added in a
// fixed order at the end.  No barrier.
template <int NV>
__device__ __forceinline__ void scolsum(const float* W, int ld,
                                        const float* v, int ldv, int R,
                                        int K, float* out, int ldo) {
  for (int j = threadIdx.x; j < K; j += kThreads) {
    float acc[NV][4];
#pragma unroll
    for (int r = 0; r < NV; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
    const float* w = W + j;
    int i = 0;
    for (; i + 4 <= R; i += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float wij = w[(size_t)(i + u) * ld];
#pragma unroll
        for (int r = 0; r < NV; ++r)
          acc[r][u] = fmaf(v[r * ldv + i + u], wij, acc[r][u]);
      }
    }
    for (; i < R; ++i) {
      const float wij = w[(size_t)i * ld];
#pragma unroll
      for (int r = 0; r < NV; ++r)
        acc[r][0] = fmaf(v[r * ldv + i], wij, acc[r][0]);
    }
#pragma unroll
    for (int r = 0; r < NV; ++r)
      out[r * ldo + j] = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A barrier over the c blocks of one team inside a larger cluster (where a
// cluster barrier would also wait for the other teams): an mbarrier in each
// block's shared memory that completes a phase once every block of the
// team has arrived on it.  team_bar_init (every thread) sets it up; a
// cluster barrier must follow before the first team_bar_sync.
__device__ __forceinline__ void team_bar_init(unsigned long long* bar,
                                              int c) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(c)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Every thread of every block of the team calls it the same number of
// times; `phase` is the calling thread's parity, flipped on return.  The
// block's writes (to its own, a peer's or global memory) before the call
// are visible to the team's blocks after it: thread 0 arrives on each
// block's barrier with release semantics at cluster scope once the block
// has passed __syncthreads, and every thread waits on its own barrier with
// acquire semantics.
__device__ __forceinline__ void team_bar_sync(unsigned long long* bar,
                                              unsigned& phase, int base,
                                              int c) {
  __syncthreads();
  const unsigned addr = smem_u32(bar);
  if (threadIdx.x == 0) {
    for (int r = 0; r < c; ++r) {
      unsigned remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote)
                   : "r"(addr), "r"(base + r));
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::
              "r"(remote)
          : "memory");
    }
  }
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
  phase ^= 1u;
}

// sum over the team's blocks, in rank order, of the word `off` of each
// block's shared array `part` (distributed shared memory); `base` is the
// cluster rank of the team's first block
__device__ __forceinline__ float team_sum(const float* part, int off,
                                          int base, int c) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  float acc = 0.f;
  for (int r = 0; r < c; ++r)
    acc += cl.map_shared_rank(const_cast<float*>(part), base + r)[off];
  return acc;
}

// write v to word `off` of the shared array `dst` of every block of the
// team (distributed shared memory)
__device__ __forceinline__ void team_put(float* dst, int off, float v,
                                         int base, int c) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  for (int r = 0; r < c; ++r) cl.map_shared_rank(dst, base + r)[off] = v;
}

}  // namespace cvxk
