// Building blocks shared by the port's CUDA kernels: a row GEMM for a few
// vectors against a matrix in global memory, a row-dot for one vector, and
// warp reductions.  Every kernel that
// includes this file launches blocks of kThreads threads.  Full float32
// FMA throughout: no TF32, no fast math.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace cvxk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatchK = 8;

template <bool RO>
__device__ __forceinline__ float load_w(const float* p) {
  return RO ? __ldg(p) : *p;
}

// Y(r, j) = epi(r, j, sum_k X(r, k) W(k, j)) for r < R, j < N.  X is R x K
// row-major in shared memory, W is K x N row-major in global memory.  RO
// marks W as read-only for the whole kernel (the non-coherent load path).
// The block is latency-bound on the L2 reads of W, so each thread issues
// kBatchK independent loads before it uses them.  Sums run in k order.
template <int R, bool RO, typename Epi>
__device__ __forceinline__ void rowgemm(const float* X, int K,
                                        const float* W, int N, Epi epi) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const float* wp = W + j;
    int k = 0;
    for (; k + kBatchK <= K; k += kBatchK) {
      float w[kBatchK];
#pragma unroll
      for (int u = 0; u < kBatchK; ++u) w[u] = load_w<RO>(wp + (size_t)(k + u) * N);
#pragma unroll
      for (int u = 0; u < kBatchK; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(X[r * K + k + u], w[u], acc[r]);
    }
    for (; k < K; ++k) {
      const float w = load_w<RO>(wp + (size_t)k * N);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(X[r * K + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) epi(r, j, acc[r]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool warp_all(bool v) {
  return __all_sync(0xffffffffu, v);
}

__device__ __forceinline__ bool warp_any(bool v) {
  return __any_sync(0xffffffffu, v);
}

// y(i) = epi(i, sum_j W(i, j) x(j)) for i < N: one warp per row of W (N x K
// row-major in global memory, read-only for the whole kernel) with the
// lanes over j, so each warp's loads are coalesced; x (K) lives in shared
// memory.  epi runs on lane 0 of the row's warp.  No barrier.
template <typename Epi>
__device__ __forceinline__ void rowdot(const float* W, const float* x, int N,
                                       int K, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < N; i += kWarps) {
    const float* w = W + (size_t)i * K;
    float acc = 0.f;
#pragma unroll 8
    for (int j = lane; j < K; j += 32) acc = fmaf(__ldg(w + j), x[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) epi(i, acc);
  }
}

}  // namespace cvxk
