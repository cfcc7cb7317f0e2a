// Block cyclic-reduction (CR) solve of one shared block-tridiagonal SPD
// system for one right-hand side, by all threads of a thread block, with
// the right-hand side, the solution and every level's odd blocks in shared
// memory and the packed factor read from global memory (L2).  Used by
// kernels K4 (cr_solve.cu) and K5 (banded_chunk.cu).
//
// The factor layout is ops/banded_grouped.py::pack_cr_levels: per level
// [Dinv_odd (n2), A (n2 - 1), C (n2), L_left (n2 - 1), L_even (n2)], then
// the root inverse, each an s x s row-major block.  It mirrors the
// reference's _cr_solve_inkernel (cvxpygen_tpu/ops/banded_shared_kernel.py):
// the forward sweep halves the block count per level,
//   b'_t = b_2t - A_{t-1} b_{2t-1} - C_t b_{2t+1},
// pushing the odd blocks (zero past the level's block count) on a stack;
// the root block is x = Root b'; the backward sweep recovers each level's
// odd blocks,
//   x_{2t+1} = Dinv_t (b_{2t+1} - L_even_t x_2t - L_left_t' x_{2t+2}),
// and interleaves them with the even ones.  Each level is one or two
// passes over its (block, row) pairs separated by __syncthreads; a thread
// takes one pair at a time and runs its s-long dot products in order.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm.cuh"

namespace cvxk {

constexpr int kCrMaxLevels = 32;

// One level of the packed factor (ops/banded_shared_kernel.py::
// cr_meta_array): its block count, its n2 = ceil(nb_in / 2), the block
// offsets of Dinv_odd, A (and its count), C, L_left (and its count) and
// L_even, and the word offset of its odd blocks on the stack.
struct CrLevel {
  int nb_in, n2, oD, oA, nA, oC, oLl, nLl, oLe, so;
};

struct CrMeta {
  int n_levels, root, nb, s;
  CrLevel lv[kCrMaxLevels];
};

constexpr int kCrHeader = 4;
constexpr int kCrLevelInts = 10;

// Host: the CrMeta of the flat int array cr_meta_array builds; false when
// it has too many levels or a bad block size.
inline bool cr_meta_from(const int* a, CrMeta* cm) {
  cm->n_levels = a[0];
  cm->root = a[1];
  cm->nb = a[2];
  cm->s = a[3];
  if (cm->n_levels < 0 || cm->n_levels > kCrMaxLevels || cm->s <= 0 ||
      cm->nb <= 0)
    return false;
  for (int k = 0; k < cm->n_levels; ++k) {
    const int* p = a + kCrHeader + kCrLevelInts * k;
    cm->lv[k] = CrLevel{p[0], p[1], p[2], p[3], p[4],
                        p[5], p[6], p[7], p[8], p[9]};
  }
  return true;
}

// Host: shared-memory words of one solve: two buffers of the padded block
// count and the stack of every level's odd blocks.
inline size_t cr_smem_words(const CrMeta& cm) {
  size_t stack = 0;
  for (int k = 0; k < cm.n_levels; ++k) stack += (size_t)cm.lv[k].n2 * cm.s;
  return 2 * (size_t)(cm.nb + (cm.nb & 1)) * cm.s + stack;
}

// Copies the level table from the kernel parameter into shared memory with
// constant indices (dynamic indexing would copy the parameter to local
// memory).  The caller synchronizes before use.
__device__ __forceinline__ void cr_load_levels(const CrMeta& cm,
                                               CrLevel* lv) {
#pragma unroll
  for (int k = 0; k < kCrMaxLevels; ++k)
    if (threadIdx.x == k) lv[k] = cm.lv[k];
}

// sum_j w[j] v[j] in j order, with w in global memory (read-only for the
// kernel) and v in shared memory.  When s is a multiple of 4 (every block
// size analyze_banded picks) both rows are 16-byte aligned, and the loads
// go four at a time, all issued before the multiply-adds that use them:
// the kernels are bound by the latency of these L2 reads.
__device__ __forceinline__ float dot_row(const float* __restrict__ w,
                                         const float* v, int s) {
  float acc = 0.f;
  if ((s & 3) == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll 4
    for (int j = 0; j < s / 4; ++j) {
      const float4 a = __ldg(w4 + j), x = v4[j];
      acc = fmaf(a.x, x.x, acc);
      acc = fmaf(a.y, x.y, acc);
      acc = fmaf(a.z, x.z, acc);
      acc = fmaf(a.w, x.w, acc);
    }
    return acc;
  }
  for (int j = 0; j < s; ++j) acc = fmaf(__ldg(w + j), v[j], acc);
  return acc;
}

// x = M^-1 b.  On entry buf0 holds b (nb * s floats); buf1 has room for
// (nb + nb % 2) * s floats too, and `stack` for every level's odd blocks.
// Returns the buffer that holds x in its first nb * s floats.  Starts and
// ends with __syncthreads.
__device__ float* cr_solve_block(const float* __restrict__ fac,
                                 const CrLevel* lv, int n_levels, int root,
                                 int s, float* buf0, float* buf1,
                                 float* stack) {
  const int ss = s * s;
  float* cur = buf0;
  float* nxt = buf1;
  __syncthreads();
  for (int k = 0; k < n_levels; ++k) {
    const CrLevel L = lv[k];
    float* st = stack + L.so;
    for (int o = threadIdx.x; o < L.n2 * s; o += kThreads) {
      const int t = o / s, i = o - t * s;
      const bool has_odd = 2 * t + 1 < L.nb_in;
      const float* odd = cur + (2 * t + 1) * s;
      st[o] = has_odd ? odd[i] : 0.f;
      float acc = cur[2 * t * s + i];
      if (t >= 1 && t - 1 < L.nA)
        acc -= dot_row(fac + (size_t)(L.oA + t - 1) * ss + i * s,
                       cur + (2 * t - 1) * s, s);
      if (has_odd)
        acc -= dot_row(fac + (size_t)(L.oC + t) * ss + i * s, odd, s);
      nxt[o] = acc;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int i = threadIdx.x; i < s; i += kThreads)
    nxt[i] = dot_row(fac + (size_t)root * ss + i * s, cur, s);
  __syncthreads();
  {
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int k = n_levels - 1; k >= 0; --k) {
    const CrLevel L = lv[k];
    float* st = stack + L.so;
    for (int o = threadIdx.x; o < L.n2 * s; o += kThreads) {
      const int t = o / s, i = o - t * s;
      float r = st[o] - dot_row(fac + (size_t)(L.oLe + t) * ss + i * s,
                                cur + t * s, s);
      if (t < L.nLl) {
        // column i of L_left_t against x_{2t+2}
        const float* w = fac + (size_t)(L.oLl + t) * ss + i;
        const float* v = cur + (t + 1) * s;
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < s; ++j) acc = fmaf(__ldg(w + j * s), v[j], acc);
        r -= acc;
      }
      st[o] = r;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < L.n2 * s; o += kThreads) {
      const int t = o / s, i = o - t * s;
      nxt[(2 * t + 1) * s + i] =
          dot_row(fac + (size_t)(L.oD + t) * ss + i * s, st + t * s, s);
      nxt[2 * t * s + i] = cur[t * s + i];
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

}  // namespace cvxk
