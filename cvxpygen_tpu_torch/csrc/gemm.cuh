// Building blocks shared by the port's CUDA kernels: a row GEMM for a few
// vectors against a matrix in global memory, a 128x128-tiled SIMT GEMM
// for in-kernel matrix products, and warp reductions.  Every kernel that
// includes this file launches blocks of kThreads threads.  Full float32
// FMA throughout: no TF32, no fast math.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace cvxk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;
constexpr int kTileK = 16;
constexpr int kTileLd = kTile + 4;  // sA row stride: float4-aligned
constexpr int kBatchK = 8;
// 4-byte words of shared memory that tile_gemm's two tile buffers take
constexpr int kTileWords = kTileK * kTileLd + kTileK * kTile;

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

// C(i, j) = epi(i, j, sum_k A(i, k) s(k) B(k, j)) for i < R, j < N, with
// A (R x K, row stride lda) and B (K x N, row stride ldb) in global memory
// and s an optional per-k scale in shared memory.  128x128 output tiles and
// 16-deep k tiles; each thread owns an 8x8 sub-tile (rows 4ty + {0..3} and
// 64 + 4ty + {0..3}, columns likewise with tx), read from shared memory as
// float4, and the next k tile is loaded into registers while the current
// one is multiplied.  Ends with __syncthreads.
template <typename Epi>
__device__ void tile_gemm(const float* A, int lda, const float* kscale,
                          const float* Bm, int ldb, int R, int N, int K,
                          float* sA, float* sB, Epi epi) {
  constexpr int kPer = kTile * kTileK / kThreads;  // elements per thread
  constexpr int kHalf = kTile / 2;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int i0 = 0; i0 < R; i0 += kTile) {
    for (int j0 = 0; j0 < N; j0 += kTile) {
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      float ra[kPer], rb[kPer];
      auto load = [&](int k0) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int e = tid + q * kThreads;
          const int ar = e / kTileK, ac = e % kTileK;  // A: row, k
          const int gi = i0 + ar, gk = k0 + ac;
          float v = 0.f;
          if (gi < R && gk < K) {
            v = A[(size_t)gi * lda + gk];
            if (kscale) v *= kscale[gk];
          }
          ra[q] = v;
          const int bc = e % kTile, br = e / kTile;    // B: col, k
          const int gkb = k0 + br, gj = j0 + bc;
          rb[q] = (gkb < K && gj < N) ? Bm[(size_t)gkb * ldb + gj] : 0.f;
        }
      };
      load(0);
      for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int e = tid + q * kThreads;
          sA[(e % kTileK) * kTileLd + e / kTileK] = ra[q];
          sB[(e / kTile) * kTile + e % kTile] = rb[q];
        }
        __syncthreads();
        if (k0 + kTileK < K) load(k0 + kTileK);
#pragma unroll
        for (int k = 0; k < kTileK; ++k) {
          const float* pa = sA + k * kTileLd + 4 * ty;
          const float* pb = sB + k * kTile + 4 * tx;
          const float4 a0 = *reinterpret_cast<const float4*>(pa);
          const float4 a1 = *reinterpret_cast<const float4*>(pa + kHalf);
          const float4 b0 = *reinterpret_cast<const float4*>(pb);
          const float4 b1 = *reinterpret_cast<const float4*>(pb + kHalf);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = i0 + 4 * ty + (a % 4) + (a / 4) * kHalf;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int j = j0 + 4 * tx + (b % 4) + (b / 4) * kHalf;
          if (i < R && j < N) epi(i, j, acc[a][b]);
        }
      }
    }
  }
  __syncthreads();
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
