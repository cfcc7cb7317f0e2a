// Kernel K7: the explicit inverse Kinv = L'^-1 D^-1 L^-1 of a factored batch
// (kernel K6's L, d and panel inverses), by two panel sweeps on the identity.
//
// Replaces cvxpygen_tpu/ops/ldl_kernel.py::_inverse_kernel (wrapper
// ldl_inverse_pallas), the Pallas TPU kernel that the conic IPM's 'ldl' KKT
// mode runs after every factorization so that each KKT solve is one batched
// product, and computes the same function: Kinv (B, N, N) from the layouts
// of csrc/ldl.cuh.  Its plain torch version is ldl_inverse_plain in
// cvxpygen_tpu_torch/ops/ldl_kernel.py, which also builds and binds this
// file (nvcc for sm_90a, ctypes) and picks the tile width (inverse_plan).
//
// What bounds it.  At the entropy family's shape (N = 161, Np = 176,
// B = 1024, float32) the function must read L's lower triangle, d and the
// panel inverses (59 MB) and write Kinv (106 MB): 0.049 ms at 3.35 TB/s.
// An inverse from an LDL^T needs 2 N^3 / 3 = 2.8 MFLOP per instance
// (2.8 GFLOP, 0.043 ms at the FP32 peak), so it is bytes-bound.
//
// Design.  The columns of Kinv are independent: one block of 256 threads
// takes one instance and one tile of W consecutive columns (W = 16 or 32,
// the wrapper's plan), and keeps the tile's (Np, W) right-hand block R
// through the forward sweep, the diagonal scaling and the backward sweep:
// in shared memory where it fits (Np <= 1296 at W = 32), else in a device
// scratch of Np rows per block that the wrapper allocates.
// - Exact zeros skipped.  L^-1 e_j is zero above row j, so the forward
//   sweep of a tile whose first column is j0 starts at panel j0 / p: every
//   skipped term is an exact 0 * v, and each dot keeps its order over the
//   panel index, so the result is the same to the bit.
// - Register tiles.  Each thread owns 4 rows x 4 columns of a panel update
//   (R[rows] -= L21 Z_k forward, R[rows] -= L_k' X_k backward) and applies
//   every value it loads from shared memory to four outputs.
// - Staged panels.  A step (one panel of one sweep) reads its panel inverse
//   and its block of L (forward: L21 below the panel; backward: the panel's
//   rows left of it) from a two-stage ring in shared memory, filled by
//   16-byte cp.async one chunk ahead, so L makes one trip through L2 per
//   block.  A stage holds at most kChunk rows (forward) or columns
//   (backward) of the block, so its size does not grow with Np: a long
//   block is applied chunk by chunk.
// - Symmetry.  Kinv is symmetric, so the backward sweep stops at the tile's
//   first panel and updates only the rows at or below it: the tile holds
//   the lower triangle of its columns (and the whole diagonal block), and
//   its rows below the tile are written again, transposed, into the upper
//   triangle.  The upper triangle is the transpose of the lower one; the
//   lower triangle is the parent design's to the bit.  About 2 Np^3 / 3
//   FLOP per instance, against 2 (Np^3 + p Np^2) for both sweeps in full.
// - Order.  Every dot product runs from zero in the order of the panel
//   index by fmaf, and each update subtracts it once, as ldl_inverse_plain's
//   products do; the division by d stays a division.  FP32 on the SIMT
//   cores, no atomics: two calls give the same bits, neither the chunks
//   nor the scratch changes a value, and the tile width changes none of
//   the lower triangle.
// The panel is 16, or N itself below 16 (one panel, no update), as K6's
// factor gives it.
#include <stdint.h>

#include "ldl.cuh"

namespace {

using namespace cvxldl;

constexpr int kLS = kMaxPanel + 4;  // row stride of a staged L21 block
constexpr int kChunk = 256;         // rows (columns) of L in one stage

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(g));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows (forward: of L21) or columns (backward) of L in a chunk: at most
// kChunk, and Np - p where that is fewer.
__host__ __device__ inline int chunk_len(int Np, int p) {
  return Np - p < kChunk ? Np - p : kChunk;
}

// Words of one stage: the panel inverse, then one chunk of L (forward:
// kLS-wide rows; backward: p rows of chunk_len, fewer words), rounded to
// whole 16-byte lines.
__host__ __device__ inline int stage_words(int Np, int p) {
  const int w = p * p + (Np > p ? chunk_len(Np, p) * kLS : 0);
  return (w + 3) & ~3;
}

// Dynamic shared memory of one block: R (Np rows of W + 4) when it is
// resident, Z (16 x W) and two stages.
inline size_t smem_bytes(int Np, int p, int W, bool resident) {
  return 4 * ((resident ? (size_t)Np * (W + 4) : 0) + (size_t)kMaxPanel * W +
              2 * (size_t)stage_words(Np, p));
}

// The rows of L that step s applies: forward, the L21 rows below panel k
// (none at the last panel); backward, the columns lo .. o - 1.
__device__ __forceinline__ int step_rows(int s, int nf, int k0, int nbp,
                                         int Np, int p, int lo) {
  if (s < nf) {
    const int k = k0 + s;
    return k + 1 < nbp ? Np - (k + 1) * p : 0;
  }
  return (nbp - 1 - (s - nf)) * p - lo;
}

// The copies of chunk c of step s (forward panel k0 + s, then backward
// panels from the last down) into `stage`, committed as one group: the
// panel inverse with the first chunk, then the chunk's rows of L21 at row
// stride kLS (forward) or the panel's 16 rows over the chunk's columns at
// row stride `bs` (backward).
__device__ void fetch(int s, int c, int nf, int k0, int nbp, int Np, int p,
                      int lo, int bs, const float* __restrict__ Lb,
                      const float* __restrict__ Vb, float* stage) {
  const bool fwd = s < nf;
  const int k = fwd ? k0 + s : nbp - 1 - (s - nf);
  const int o = k * p;
  if (c == 0) {
    const float* v = Vb + (size_t)o * p;
    if (p == kMaxPanel) {
      for (int e = threadIdx.x; e < kMaxPanel * kMaxPanel / 4; e += kThreads)
        cp_async16(stage + 4 * e, v + 4 * e);
    } else {
      for (int e = threadIdx.x; e < p * p; e += kThreads)
        cp_async4(stage + e, v + e);
    }
  }
  float* sl = stage + p * p;
  const int n = step_rows(s, nf, k0, nbp, Np, p, lo) - c * kChunk;
  // p == 16 whenever there is more than one panel
  if (fwd && n > 0) {
    // L21: rows o + 16 + c kChunk .., columns o .. o + 15
    const int rows = min(n, kChunk), r0 = o + kMaxPanel + c * kChunk;
    for (int e = threadIdx.x; e < rows * 4; e += kThreads) {
      const int r = e >> 2, q = e & 3;
      cp_async16(sl + r * kLS + 4 * q, Lb + (size_t)(r0 + r) * Np + o + 4 * q);
    }
  } else if (!fwd && n > 0) {
    // the panel's rows o .. o + 15, columns lo + c kChunk ..
    const int w4 = min(n, kChunk) / 4, c0 = lo + c * kChunk;
    for (int e = threadIdx.x; e < kMaxPanel * w4; e += kThreads) {
      const int i = e / w4, q = e - i * w4;
      cp_async16(sl + i * bs + 4 * q, Lb + (size_t)(o + i) * Np + c0 + 4 * q);
    }
  }
  cp_async_commit();
}

// sZ = V R_k (fwd) or V' R_k (backward) for the panel inverse V (p x p, in
// shared memory) and the panel's rows R_k (row stride W + 4): each thread
// takes ZW = W / 16 adjacent columns of one row, every dot in j order from
// zero.  P is the panel when it is 16 (the loop unrolled), else 0.
template <int W, int P>
__device__ __forceinline__ void panel_product(bool fwd, const float* sV,
                                              const float* Rk, float* sZ,
                                              int p_run = P) {
  constexpr int ZW = W / 16, RS = W + 4;
  const int p = P ? P : p_run;
  for (int e = threadIdx.x; e < p * (W / ZW); e += kThreads) {
    const int i = e / (W / ZW), cc = ZW * (e - i * (W / ZW));
    float a[ZW];
#pragma unroll
    for (int u = 0; u < ZW; ++u) a[u] = 0.f;
#pragma unroll
    for (int j = 0; j < (P ? P : p); ++j) {
      const float v = fwd ? sV[i * p + j] : sV[j * p + i];
#pragma unroll
      for (int u = 0; u < ZW; ++u) a[u] = fmaf(v, Rk[j * RS + cc + u], a[u]);
    }
#pragma unroll
    for (int u = 0; u < ZW; ++u) sZ[i * W + cc + u] = a[u];
  }
}

// Resident: R in shared memory (a compile-time fact, so that its loads and
// stores are shared-memory ones), else in the block's rows of `scratch`.
template <int W, bool Resident>
__global__ void __launch_bounds__(kThreads, 4)
    ldl_inverse_kernel(const float* __restrict__ L,
                       const float* __restrict__ d,
                       const float* __restrict__ Linv, int N, int Np, int p,
                       int ntiles, float* __restrict__ scratch,
                       float* __restrict__ Kinv) {
  constexpr int RS = W + 4;        // row stride of R
  constexpr int CG = W / 4;        // column groups of four
  constexpr int RG = kThreads / CG;  // row groups per pass
  extern __shared__ __align__(16) float smem[];
  // R (Np, RS), and Z_k or X_k (16, W)
  float* R = Resident ? smem : scratch + (size_t)blockIdx.x * Np * RS;
  float* sZ = Resident ? smem + (size_t)Np * RS : smem;
  float* stages = sZ + kMaxPanel * W;
  const int sw = stage_words(Np, p);
  const int bs = Np > p ? chunk_len(Np, p) : 0;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x / ntiles;
  const int j0 = (blockIdx.x - (int)b * ntiles) * W;
  const int nbp = Np / p;
  // forward steps: panels k0 .. nbp - 1; then backward: nbp - 1 .. k0,
  // over the rows from lo
  const int k0 = j0 / p, lo = k0 * p;
  const int nf = nbp - k0, nsteps = 2 * nf;
  const float* Lb = L + b * (size_t)Np * Np;
  const float* db = d + b * (size_t)Np;
  const float* Vb = Linv + b * (size_t)Np * p;
  const int cg = tid % CG, rg = tid / CG, c0 = 4 * cg;

  fetch(0, 0, nf, k0, nbp, Np, p, lo, bs, Lb, Vb, stages);
  for (int e = tid; e < (Np - lo) * W; e += kThreads) {
    const int r = lo + e / W, c = e % W;
    R[r * RS + c] = (r == j0 + c) ? 1.0f : 0.0f;
  }
  // one pass per chunk c of step s, the next chunk's copies in flight
  int s = 0, c = 0;
  for (int u = 0; s < nsteps; ++u) {
    cp_async_wait_all();
    __syncthreads();
    const int n = step_rows(s, nf, k0, nbp, Np, p, lo) - c * kChunk;
    int sn = s, cn = c + 1;
    if (n <= kChunk) {
      sn = s + 1;
      cn = 0;
    }
    if (sn < nsteps)
      fetch(sn, cn, nf, k0, nbp, Np, p, lo, bs, Lb, Vb,
            stages + ((u + 1) & 1) * sw);
    const float* sV = stages + (u & 1) * sw;
    const float* sL = sV + p * p;
    const bool fwd = s < nf;
    const int k = fwd ? k0 + s : nbp - 1 - (s - nf);
    const int o = k * p;
    if (c == 0) {
      if (s == nf) {
        // the diagonal between the sweeps: W = Z / d
        for (int e = tid; e < (Np - lo) * W; e += kThreads) {
          const int r = lo + e / W, cc = e % W;
          R[r * RS + cc] /= db[r];
        }
        __syncthreads();
      }
      // Z_k = Linv_k R_k (forward) or X_k = Linv_k' R_k (backward), into
      // sZ; each of the 256 threads takes ZW adjacent columns of one row
      if (p == kMaxPanel)
        panel_product<W, kMaxPanel>(fwd, sV, R + o * RS, sZ);
      else
        panel_product<W, 0>(fwd, sV, R + o * RS, sZ, p);
      __syncthreads();
      for (int e = tid; e < p * CG; e += kThreads) {
        const int i = e / CG, cc = 4 * (e - i * CG);
        *reinterpret_cast<float4*>(R + (o + i) * RS + cc) =
            *reinterpret_cast<const float4*>(sZ + i * W + cc);
      }
    }
    const int nr = min(n, kChunk);
    if (fwd && nr > 0) {
      // R[o + 16 + c kChunk + r] -= L21[r] Z_k.  A warp takes WR row groups
      // over 4 WR adjacent rows (16 or 32: whole warps on the 16-row
      // blocks), thread g of it rows g, g + WR, g + 2 WR, g + 3 WR, so that
      // its lanes read neighbouring L21 rows (kLS words apart: no bank
      // conflict)
      constexpr int WR = 32 / CG;
      float* Rc = R + (size_t)(o + kMaxPanel + c * kChunk) * RS;
      const int wrow = (tid / 32) * 4 * WR + (tid % 32) / CG;
      for (int pb = 0; pb < nr; pb += 4 * RG) {
        const int r0 = pb + wrow;
        if (r0 >= nr) break;
        float acc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[q][v] = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxPanel; j += 4) {
          float4 l4[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            l4[q] = *reinterpret_cast<const float4*>(
                sL + min(r0 + q * WR, nr - 1) * kLS + j);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 z =
                *reinterpret_cast<const float4*>(sZ + (j + jj) * W + c0);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float lv = jj == 0   ? l4[q].x
                               : jj == 1 ? l4[q].y
                               : jj == 2 ? l4[q].z
                                         : l4[q].w;
              acc[q][0] = fmaf(lv, z.x, acc[q][0]);
              acc[q][1] = fmaf(lv, z.y, acc[q][1]);
              acc[q][2] = fmaf(lv, z.z, acc[q][2]);
              acc[q][3] = fmaf(lv, z.w, acc[q][3]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + q * WR;
          if (r >= nr) continue;
          float4* rp = reinterpret_cast<float4*>(Rc + r * RS + c0);
          float4 rv = *rp;
          rv.x -= acc[q][0];
          rv.y -= acc[q][1];
          rv.z -= acc[q][2];
          rv.w -= acc[q][3];
          *rp = rv;
        }
      }
    } else if (!fwd && nr > 0) {
      // R[lo + c kChunk + r] -= L[o .. o + 15][lo + c kChunk + r]' X_k; a
      // thread's four adjacent rows (one 16-byte load of L per panel row)
      float* Rc = R + (size_t)(lo + c * kChunk) * RS;
      for (int r0 = 4 * rg; r0 < nr; r0 += 4 * RG) {
        float acc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[q][v] = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPanel; ++i) {
          const float4 l = *reinterpret_cast<const float4*>(sL + i * bs + r0);
          const float4 x = *reinterpret_cast<const float4*>(sZ + i * W + c0);
          const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q][0] = fmaf(lv[q], x.x, acc[q][0]);
            acc[q][1] = fmaf(lv[q], x.y, acc[q][1]);
            acc[q][2] = fmaf(lv[q], x.z, acc[q][2]);
            acc[q][3] = fmaf(lv[q], x.w, acc[q][3]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4* rp = reinterpret_cast<float4*>(Rc + (r0 + q) * RS + c0);
          float4 rv = *rp;
          rv.x -= acc[q][0];
          rv.y -= acc[q][1];
          rv.z -= acc[q][2];
          rv.w -= acc[q][3];
          *rp = rv;
        }
      }
    }
    s = sn;
    c = cn;
  }
  __syncthreads();
  // the lower triangle of the tile's columns (and its diagonal block) ...
  float* Kb = Kinv + b * (size_t)N * N;
  const int wn = min(W, N - j0);
  for (int e = tid; e < (N - lo) * W; e += kThreads) {
    const int r = lo + e / W, cc = e % W;
    if (cc < wn) Kb[(size_t)r * N + j0 + cc] = R[r * RS + cc];
  }
  // ... and, transposed, the upper triangle right of the diagonal block
  const int r1 = j0 + W, nu = N - r1;
  if (nu > 0)
    for (int e = tid; e < wn * nu; e += kThreads) {
      const int cc = e / nu, r = r1 + (e - cc * nu);
      Kb[(size_t)(j0 + cc) * N + r] = R[r * RS + cc];
    }
}

template <int W, bool Resident>
cudaError_t launch(const float* L, const float* d, const float* Linv, int B,
                   int N, int Np, int p, float* scratch, float* Kinv,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(Np, p, W, Resident);
  cudaError_t err = cudaFuncSetAttribute(
      ldl_inverse_kernel<W, Resident>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (N + W - 1) / W;
  ldl_inverse_kernel<W, Resident>
      <<<(unsigned)((long long)B * ntiles), kThreads, smem, stream>>>(
          L, d, Linv, N, Np, p, ntiles, scratch, Kinv);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block at tile width `width` with R resident
// (`resident` != 0) or in the device scratch (ops/ldl_kernel.py::
// inverse_plan mirrors it), or 0 when it does not fit.
extern "C" long long ldl_inverse_smem_bytes(int Np, int p, int width,
                                            int resident) {
  const size_t bytes = smem_bytes(Np, p, width, resident != 0);
  return bytes <= kSmemLimit ? (long long)bytes : 0;
}

// Launches kernel K7 once on `stream`: L (B, Np, Np), d (B, Np), Linv
// (B, Np, p) -> Kinv (B, N, N), tiles of `width` columns (16 or 32);
// B * ceil(N / width) < 2^31 thread blocks.  `scratch` is null when R is
// resident in shared memory, else B * ceil(N / width) * Np * (width + 4)
// floats.  The panel is 16 or, with one panel, N.  Returns the CUDA error
// code (0 = success).
extern "C" int ldl_inverse_f32(const float* L, const float* d,
                               const float* Linv, int B, int N, int Np, int p,
                               int width, float* scratch, float* Kinv,
                               void* stream) {
  if (!dims_ok(B, N, Np, p) || (p != kMaxPanel && Np != p) ||
      (width != 16 && width != 32) ||
      (long long)B * ((N + width - 1) / width) > 0x7fffffffLL ||
      (p == kMaxPanel && ((uintptr_t)L % 16 || (uintptr_t)Linv % 16 ||
                          (uintptr_t)scratch % 16)) ||
      ldl_inverse_smem_bytes(Np, p, width, scratch == nullptr) == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch)
    return width == 16
               ? (int)launch<16, false>(L, d, Linv, B, N, Np, p, scratch,
                                        Kinv, st)
               : (int)launch<32, false>(L, d, Linv, B, N, Np, p, scratch,
                                        Kinv, st);
  return width == 16
             ? (int)launch<16, true>(L, d, Linv, B, N, Np, p, nullptr, Kinv,
                                     st)
             : (int)launch<32, true>(L, d, Linv, B, N, Np, p, nullptr, Kinv,
                                     st);
}
