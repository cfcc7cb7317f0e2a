// A matrix product on the tensor cores for in-kernel factorizations, with
// the three-pass TF32 split that keeps it close to float32:
//   a = a_hi + a_lo, b = b_hi + b_lo, each part rounded to TF32 (to
//   nearest, ties away from zero),
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,
// in float32, on Hopper's warpgroup instruction (wgmma.mma_async m64n112k8,
// both operands read from shared memory).  The dropped a_lo b_lo term is
// 2^-22 of |a| |b|; a plain TF32 product keeps only 2^-11.  The tensor
// cores add into their accumulator without rounding to nearest, an error
// that grows with every k step, so each 16-deep stage sums into a fresh
// accumulator that then joins the running sum in an ordinary rounded
// float32 add (Ootomo and Yokota's correction).  Every kernel that
// includes this file launches blocks of kThreads (256) threads: two
// warpgroups.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "resident.cuh"

namespace cvxk {

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 does for finite x, in two integer
// operations (the conversion instruction's rate is far lower)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void cp_async4_zfill(float* s, const float* g,
                                                bool valid) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
               "l"(g), "r"(valid ? 4 : 0));
}

constexpr int kWgM = 128;  // output tile rows: two warpgroups of 64
constexpr int kWgN = 112;  // output tile columns (one wgmma n112)
constexpr int kWgK = 16;   // k depth of one stage: two wgmma k8 steps
constexpr int kWgStages = 3;  // raw float32 stages in the cp.async ring
// raw stages (words): A as [M][K + 4] or, transposed, [K][M + 8]; B as
// [K][N + 8] (the strides keep the conversion's reads conflict-free)
constexpr int kWgLdA = kWgK + 4;
constexpr int kWgLdAt = kWgM + 8;
constexpr int kWgLdB = kWgN + 8;
constexpr int kWgRawA = kWgM * kWgLdA;  // >= kWgK * kWgLdAt
constexpr int kWgRawB = kWgK * kWgLdB;
// converted operands, TF32 hi and lo parts in wgmma's K-major layout
// without swizzle: core matrices of 8 rows by 4 words (128 bytes), the two
// of one k8 step 128 bytes apart (LBO), successive 8-row groups 256 bytes
// apart (SBO)
constexpr int kWgTileA = kWgM * 8;  // one k8 step of A
constexpr int kWgTileB = kWgN * 8;
constexpr int kWgConv = 2 * 2 * (kWgTileA + kWgTileB);  // hi, lo; 2 steps
// 4-byte words of shared memory that wg_gemm takes: the converted operands
// and the raw ring (the output tile, kWgM x kWgLdC, reuses them)
constexpr int kWgWords = kWgConv + kWgStages * (kWgRawA + kWgRawB);
constexpr int kWgLdC = kWgN + 4;
static_assert(kWgM * kWgLdC <= kWgWords, "the output tile fits the stages");

// word offset of element (r, kk) of a k8 step in the core-matrix layout
__device__ __forceinline__ int wg_off(int r, int kk) {
  return (r >> 3) * 64 + (kk >> 2) * 32 + (r & 7) * 4 + (kk & 3);
}

__device__ __forceinline__ unsigned long long wg_desc(const float* p) {
  const unsigned long long a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((128ull >> 4) << 16) | ((256ull >> 4) << 32);
}

// d (+)= A B on one m64n112k8 step, operands by descriptor; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_tf32(float* d, unsigned long long da,
                                           unsigned long long db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, %56, %57, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void cp_async8_zfill(float* s, const float* g,
                                                bool valid) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(sa),
               "l"(g), "r"(valid ? 8 : 0));
}

// C(i, j) = epi(i, j, sum_k A(i, k) s(k) B(k, j)) for r0 <= i < r1 and
// j < N: A(i, k) at A[i * lda + k] or, when TA, at A[k * lda + i], B
// (K x N) at B[k * ldb + j], both in global memory; s an optional per-k
// scale kscale[k] * kmul (kscale in shared memory).  128 x 112 output
// tiles, warpgroup w taking rows 64 w.. (its wgmma skipped where they lie
// wholly past r1); each 16-deep k stage is copied raw into a three-stage
// cp.async ring (8-byte copies where the strides, bases and K and N are
// even, else 4-byte ones; zero-filled past the edges), then split once per
// element into TF32 hi and lo parts in the core-matrix layout (four k at a
// time), then multiplied in three passes (a_lo b_hi, a_hi b_lo, a_hi b_hi)
// into a fresh accumulator that joins the running float32 sum in a rounded
// add.  k runs in order.  epi runs once per element, consecutive threads on
// consecutive columns (the tile is staged through shared memory).  `sbuf`
// holds kWgWords words, 16-byte aligned.  Not inlined: its registers are
// its own.  Ends with __syncthreads.
template <bool TA, typename Epi>
__device__ __noinline__ void wg_gemm(const float* A, int lda,
                                  const float* kscale, float kmul,
                                  const float* B, int ldb, int r0, int r1,
                                  int N, int K, float* sbuf, Epi epi) {
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  // the converted operands, [hi, lo][step] x kWgTileA then the same for B,
  // then the raw ring
  float* conv = sbuf;
  float* raw = conv + kWgConv;
  const int nk = (K + kWgK - 1) / kWgK;
  const bool even = ((K | N | ldb) & 1) == 0 &&
                    (((unsigned long long)B) & 7) == 0;
  const bool vecA = !TA && even && (lda & 1) == 0 &&
                    (((unsigned long long)A) & 7) == 0;
  for (int i0 = r0; i0 < r1; i0 += kWgM) {
    const bool live = i0 + 64 * wg < r1;  // this warpgroup's rows
    for (int j0 = 0; j0 < N; j0 += kWgN) {
      auto load = [&](int st, int k0) {
        float* sA = raw + st * (kWgRawA + kWgRawB);
        float* sB = sA + kWgRawA;
        if (TA) {
          for (int e = tid; e < kWgM * kWgK; e += kThreads) {
            const int k = e / kWgM, i = e % kWgM;  // coalesced over i
            const bool ok = i0 + i < r1 && k0 + k < K;
            cp_async4_zfill(sA + k * kWgLdAt + i,
                            ok ? A + (size_t)(k0 + k) * lda + i0 + i : A, ok);
          }
        } else if (vecA) {
          for (int e = tid; e < kWgM * kWgK / 2; e += kThreads) {
            const int i = e / (kWgK / 2), k = 2 * (e % (kWgK / 2));
            const bool ok = i0 + i < r1 && k0 + k < K;
            cp_async8_zfill(sA + i * kWgLdA + k,
                            ok ? A + (size_t)(i0 + i) * lda + k0 + k : A, ok);
          }
        } else {
          for (int e = tid; e < kWgM * kWgK; e += kThreads) {
            const int i = e / kWgK, k = e % kWgK;  // coalesced over k
            const bool ok = i0 + i < r1 && k0 + k < K;
            cp_async4_zfill(sA + i * kWgLdA + k,
                            ok ? A + (size_t)(i0 + i) * lda + k0 + k : A, ok);
          }
        }
        if (even) {
          for (int e = tid; e < kWgK * kWgN / 2; e += kThreads) {
            const int k = e / (kWgN / 2), j = 2 * (e % (kWgN / 2));
            const bool ok = k0 + k < K && j0 + j < N;
            cp_async8_zfill(sB + k * kWgLdB + j,
                            ok ? B + (size_t)(k0 + k) * ldb + j0 + j : B, ok);
          }
        } else {
          for (int e = tid; e < kWgK * kWgN; e += kThreads) {
            const int k = e / kWgN, j = e % kWgN;
            const bool ok = k0 + k < K && j0 + j < N;
            cp_async4_zfill(sB + k * kWgLdB + j,
                            ok ? B + (size_t)(k0 + k) * ldb + j0 + j : B, ok);
          }
        }
      };
      // split raw stage kt into the converted operands, four k of one row
      // (16 bytes of a core matrix) per item; consecutive items fill
      // consecutive 16-byte rows of the layout
      auto convert = [&](int kt) {
        const float* sA = raw + (kt % kWgStages) * (kWgRawA + kWgRawB);
        const float* sB = sA + kWgRawA;
        float* cA = conv;
        float* cB = cA + 4 * kWgTileA;
        for (int e = tid; e < 2 * kWgTileA / 4; e += kThreads) {
          const int step = e / (kWgTileA / 4), u = e % (kWgTileA / 4);
          const int r = (u / 16) * 8 + (u % 8), kb = (u % 16) / 8;
          const int k = step * 8 + kb * 4;
          float v[4];
          if (TA) {
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = sA[(k + q) * kWgLdAt + r];
          } else {
            const float4 t =
                *reinterpret_cast<const float4*>(sA + r * kWgLdA + k);
            v[0] = t.x;
            v[1] = t.y;
            v[2] = t.z;
            v[3] = t.w;
          }
          if (kscale) {
            const int kg = kt * kWgK + k;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v[q] *= kg + q < K ? kscale[kg + q] * kmul : 0.f;
          }
          unsigned hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(v[q], hi[q], lo[q]);
          *reinterpret_cast<uint4*>(cA + step * kWgTileA + 4 * u) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(cA + (2 + step) * kWgTileA + 4 * u) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        for (int e = tid; e < 2 * kWgTileB / 4; e += kThreads) {
          const int step = e / (kWgTileB / 4), u = e % (kWgTileB / 4);
          const int nn = (u / 16) * 8 + (u % 8), kb = (u % 16) / 8;
          const int k = step * 8 + kb * 4;
          unsigned hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_tf32(sB[(k + q) * kWgLdB + nn], hi[q], lo[q]);
          *reinterpret_cast<uint4*>(cB + step * kWgTileB + 4 * u) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(cB + (2 + step) * kWgTileB + 4 * u) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      };
      float acc[56], part[56];
#pragma unroll
      for (int v = 0; v < 56; ++v) acc[v] = 0.f;
#pragma unroll
      for (int s = 0; s < kWgStages - 1; ++s) {
        if (s < nk) load(s, s * kWgK);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      for (int kt = 0; kt < nk; ++kt) {
        // raw stage kt has landed once at most kWgStages - 2 groups pend
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kWgStages - 2)
                     : "memory");
        __syncthreads();
        if (kt + kWgStages - 1 < nk)
          load((kt + kWgStages - 1) % kWgStages,
               (kt + kWgStages - 1) * kWgK);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        convert(kt);
        __syncthreads();
        if (live) {
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          const float* aw = conv + wg * 64 * 8;  // the warpgroup's 64 rows
          const float* bw = conv + 4 * kWgTileA;
#pragma unroll
          for (int step = 0; step < 2; ++step) {
            const unsigned long long ah = wg_desc(aw + step * kWgTileA);
            const unsigned long long al = wg_desc(aw + (2 + step) * kWgTileA);
            const unsigned long long bh = wg_desc(bw + step * kWgTileB);
            const unsigned long long bl = wg_desc(bw + (2 + step) * kWgTileB);
            wgmma_tf32(part, al, bh, step);
            wgmma_tf32(part, ah, bl, 1);
            wgmma_tf32(part, ah, bh, 1);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
          for (int v = 0; v < 56; ++v) acc[v] += part[v];
        }
      }
      // the tile through shared memory (free now), so that epi runs with
      // consecutive threads on consecutive columns: coalesced accesses
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      float* tile = sbuf;  // kWgM x kWgLdC
      if (live) {
#pragma unroll
        for (int v = 0; v < 56; ++v) {
          const int i = 64 * wg + 16 * warp + g + ((v & 2) ? 8 : 0);
          const int j = 8 * (v / 4) + 2 * tg + (v & 1);
          tile[i * kWgLdC + j] = acc[v];
        }
      }
      __syncthreads();
      const int rows = min(kWgM, r1 - i0), cols = min(kWgN, N - j0);
      for (int e = tid; e < rows * kWgN; e += kThreads) {
        const int i = e / kWgN, j = e % kWgN;
        if (j < cols) epi(i0 + i, j0 + j, tile[i * kWgLdC + j]);
      }
      __syncthreads();
    }
  }
}

}  // namespace cvxk
