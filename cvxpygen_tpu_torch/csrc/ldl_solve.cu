// Kernel K8: x = K^-1 b for a factored batch (kernel K6's L, d and panel
// inverses): the forward sweep, the diagonal and the backward sweep.
//
// Replaces cvxpygen_tpu/ops/ldl_kernel.py::_solve_kernel (wrapper
// ldl_solve_pallas), the Pallas TPU kernel that the conic IPM's 'ldl' KKT
// mode runs for every KKT solve when IPMSettings.ldl_inverse is False, and
// computes the same function: b (B, N) -> x (B, N) in the layouts of
// csrc/ldl.cuh.  Its plain torch version is ldl_solve_plain in
// cvxpygen_tpu_torch/ops/ldl_kernel.py, which also builds and binds this
// file (nvcc for sm_90a, ctypes) and picks the layout (solve_plan).
//
// What bounds it.  Bytes: the function reads the strictly lower triangle
// of L, d and the panel inverses once (59 MB at the entropy family's
// N = 161, B = 1024: 0.018 ms at 3.35 TB/s) for 2 N^2 FLOP per instance.
//
// Design: one block per instance, one thread per row of the padded system
// (rows t, t + blockDim, ... when Np is larger than the block), the
// right-hand side being reduced and the forward solution in shared memory.
// - Panel steps.  Forward step k: each thread below the panel subtracts
//   its row of L21 times z_k from its r; then the warp whose threads own
//   panel k + 1's rows, which have just taken their last update, computes
//   z_{k+1} = Linv_{k+1} r_{k+1} (lane pairs take a row of the panel
//   inverse, half of its columns each, and meet by a shuffle) into shared
//   memory.  Backward step k: each thread left of the panel subtracts its
//   column of the panel's rows of L times x_k from its w, and the owner of
//   panel k - 1 computes x_{k-1} = Linv_{k-1}' w_{k-1}.  So each step has
//   one block barrier (two where a panel's rows lie in two warps, p not
//   dividing 32), after which every thread reads the next product.
// - Layouts (solve_plan).  Resident, at p = 16 up to Np = 320: the
//   strictly lower triangle of L as column strips (strip j: the rows below
//   panel j, columns 16 j .. 16 j + 16), the panel inverses and d in shared
//   memory.  One thread copies them in before the forward sweep, in panel
//   order, each panel counted in by its own mbarrier, so step k waits only
//   for its strip: the strips as 16 x 16 boxes of a tensor map over L (the
//   Tensor Memory Accelerator; its 64-byte swizzle puts a row's 16-byte
//   chunks at chunk ^ ((row >> 1) & 3), so that a warp's row reads and
//   column reads spread over the banks), the panel inverses and d as bulk
//   copies.  L is read from device memory once; the backward sweep reads
//   the strips again from shared memory (62 KB of L at Np = 176, three
//   blocks per SM).  Streamed, otherwise: L, the panel inverses and d read
//   from device memory where they are used, L in both sweeps (a row's 16
//   contiguous floats forward, the columns of a panel's rows, contiguous
//   across threads, backward); only r and z in shared memory (up to Np of
//   about 29,000, as in the first design).
// - Order.  Each product sums in j order from zero by fmaf, in two halves
//   of the panel added at the end; the subtractions and the division are
//   separate operations, as in the plain version (no product is
//   contracted into them).  Another order than the plain version's, so
//   x differs from it by float32 roundoff; two calls give the same bits.
#include <cuda.h>
#include <stddef.h>
#include <stdint.h>

#include "ldl.cuh"

namespace {

using namespace cvxldl;

// panels of the resident layout (one mbarrier each)
constexpr int kMaxPanels = 32;

__host__ __device__ inline size_t round4(size_t w) {
  return (w + 3) & ~(size_t)3;
}

// the strip rows before strip j: sum over i < j of Np - (i + 1) p
__host__ __device__ inline int strip_row0(int j, int Np, int p) {
  return j * Np - p * (j * (j + 1) / 2);
}

// words of slack that let the resident layout start its strips on a
// 1024-byte line (the tensor copies' swizzle is one of address bits)
constexpr int kAlignWords = 256;

// Dynamic shared-memory words of a block (ops/ldl_kernel.py::
// solve_smem_bytes mirrors it): resident, the alignment slack, the strips,
// the panel inverses and d; then r and z.
__host__ __device__ inline size_t smem_words(int Np, int p, bool resident) {
  const size_t staged =
      resident ? kAlignWords + round4((size_t)p * strip_row0(Np / p, Np, p)) +
                     round4((size_t)Np * p) + round4(Np)
               : 0;
  return staged + 2 * round4(Np);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One box of the tensor map `map` (a 16 x 16 tile of L, swizzled in
// 64-byte rows) at (column c, row r, instance b) into `dst`, and one bulk
// copy of `bytes` contiguous bytes, each completing on mbarrier `bar`.
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map,
                                            int c, int r, int b,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(c), "r"(r), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
}

// The position of column c in a strip's local row rl: the row's 16-byte
// chunks swizzled by row, chunk ^ ((rl >> 1) & 3), which is the tensor
// copies' 64-byte swizzle on a 1024-byte aligned strip.
__device__ __forceinline__ int strip_col(int rl, int c) {
  return ((((c >> 2) ^ (rl >> 1)) & 3) << 2) | (c & 3);
}

// The panel product of a warp: lane pair (2 i, 2 i + 1) takes row i of the
// p x p matrix M (row-major, or its transpose when T) against v, columns
// [0, p / 2) and [p / 2, p) in order, and lane 2 i writes their sum to
// out[i].
template <int P, bool T>
__device__ __forceinline__ void panel_product(const float* M, const float* v,
                                              int p, float* out) {
  const int lane = threadIdx.x & 31, i = lane >> 1, h = lane & 1;
  const int hp = (p + 1) / 2;
  float part = 0.f;
  if constexpr (P == 16 && !T) {
    const float4* m4 = reinterpret_cast<const float4*>(M + i * 16 + 8 * h);
    const float4* v4 = reinterpret_cast<const float4*>(v + 8 * h);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 a = m4[q], b = v4[q];
      part = fmaf(a.x, b.x, part);
      part = fmaf(a.y, b.y, part);
      part = fmaf(a.z, b.z, part);
      part = fmaf(a.w, b.w, part);
    }
  } else if (i < p) {
    const int j1 = min(p, (h + 1) * hp);
    for (int j = h * hp; j < j1; ++j)
      part = fmaf(T ? M[j * p + i] : M[i * p + j], v[j], part);
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  if (h == 0 && i < p) out[i] = part;
}

// A panel product from shared memory (zeros past p).
template <int P>
__device__ __forceinline__ void load_panel(const float* src, int p,
                                           float (&v)[kMaxPanel]) {
  if constexpr (P == 16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(src)[q];
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxPanel; ++j) v[j] = j < p ? src[j] : 0.f;
  }
}

__device__ __forceinline__ float pick(const float (&v)[kMaxPanel], int j) {
  float out = v[0];
#pragma unroll
  for (int q = 1; q < kMaxPanel; ++q)
    if (q == j) out = v[q];
  return out;
}

// One block per instance.  RES: the resident layout (p = 16), staged by
// the tensor map `map` of L.
template <int P, bool RES>
__global__ void __launch_bounds__(kThreads)
    ldl_solve_kernel(const float* __restrict__ L, const float* __restrict__ d,
                     const float* __restrict__ Linv,
                     const float* __restrict__ rhs, int N, int Np, int p_run,
                     const __grid_constant__ CUtensorMap map,
                     float* __restrict__ x) {
  static_assert(!RES || P == 16, "the resident layout takes 16-wide panels");
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long bars[kMaxPanels];
  const int p = P ? P : p_run, nbp = Np / p;
  const int tid = threadIdx.x, NT = blockDim.x;
  const size_t b = blockIdx.x;
  const float* Lb = L + b * (size_t)Np * Np;
  const float* Vg = Linv + b * (size_t)Np * p;
  const float* dg = d + b * (size_t)Np;
  // resident: the strips (from a 1024-byte line), the panel inverses and d
  float* S =
      smem + ((kAlignWords - (smem_u32(smem) >> 2)) & (kAlignWords - 1));
  float* Vs = S + round4((size_t)p * strip_row0(nbp, Np, p));
  float* Ds = Vs + round4((size_t)Np * p);
  float* R = RES ? smem + smem_words(Np, p, true) - 2 * round4(Np)
                 : smem;                    // r in the forward sweep, then w
  float* Z = R + round4(Np);                // the forward solution z
  const float* V = RES ? Vs : Vg;
  const float* D = RES ? Ds : dg;

  if (RES && tid == 0) {
    // per panel, the byte count on its mbarrier, then the boxes of its
    // strip, its panel inverse and, with the last, d
    for (int k = 0; k < nbp; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bars[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < nbp; ++j) {
      const int boxes = nbp - 1 - j;
      const int bytes = 4 * (boxes * 256 + 256 + (j == nbp - 1 ? Np : 0));
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(&bars[j])),
          "r"(bytes)
          : "memory");
      float* Sj = S + (size_t)strip_row0(j, Np, p) * p;
      for (int m = 0; m < boxes; ++m)
        tensor_copy(Sj + m * 256, &map, 16 * j, 16 * (j + 1 + m), (int)b,
                    &bars[j]);
      bulk_copy(Vs + j * 256, Vg + (size_t)j * 256, 1024, &bars[j]);
      if (j == nbp - 1) bulk_copy(Ds, dg, 4 * Np, &bars[j]);
    }
  }
  for (int i = tid; i < Np; i += NT)
    R[i] = i < N ? __ldg(rhs + b * (size_t)N + i) : 0.f;
  __syncthreads();

  // the panel products, one warp each, by step parity: z_k forward, x_k
  // backward
  __shared__ __align__(16) float PK[2][kMaxPanel];
  const int warp = tid >> 5, hp = (p + 1) / 2;
  // a panel's rows may lie in two warps (p does not divide 32)
  const bool split = 32 % p != 0;

  // forward: L z = b.  Step k: each row below the panel subtracts its row
  // of the strip times z_k; the warp that owns panel k + 1's rows then
  // computes z_{k+1} from them.
  if (RES) bar_wait(&bars[0]);
  if (warp == 0) panel_product<P, false>(V, R, p, PK[0]);
  __syncthreads();
  for (int k = 0; k < nbp; ++k) {
    const int o = k * p;
    float zk[kMaxPanel];
    load_panel<P>(PK[k & 1], p, zk);
    for (int row = tid; row < Np; row += NT) {
      if (row >= o + p) {
        // the row's dot with z_k in two halves of the panel
        float a0 = 0.f, a1 = 0.f;
        if (RES) {
          const int rl = row - o - p;
          const float* Sr = S + (size_t)(strip_row0(k, Np, p) + rl) * p;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 w =
                *reinterpret_cast<const float4*>(Sr + strip_col(rl, 4 * q));
            float& a = q < 2 ? a0 : a1;
            a = fmaf(w.x, zk[4 * q], a);
            a = fmaf(w.y, zk[4 * q + 1], a);
            a = fmaf(w.z, zk[4 * q + 2], a);
            a = fmaf(w.w, zk[4 * q + 3], a);
          }
        } else {
          const float* Lr = Lb + (size_t)row * Np + o;
          if constexpr (P == 16) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 w = __ldg(reinterpret_cast<const float4*>(Lr) + q);
              float& a = q < 2 ? a0 : a1;
              a = fmaf(w.x, zk[4 * q], a);
              a = fmaf(w.y, zk[4 * q + 1], a);
              a = fmaf(w.z, zk[4 * q + 2], a);
              a = fmaf(w.w, zk[4 * q + 3], a);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kMaxPanel; ++j)
              if (j < p) {
                if (j < hp)
                  a0 = fmaf(__ldg(Lr + j), zk[j], a0);
                else
                  a1 = fmaf(__ldg(Lr + j), zk[j], a1);
              }
          }
        }
        R[row] = R[row] - (a0 + a1);
      } else if (row >= o) {
        Z[row] = pick(zk, row - o);
      }
    }
    if (k + 1 < nbp) {
      if (split) __syncthreads();
      if (RES) bar_wait(&bars[k + 1]);
      if (warp == ((o + p) % NT) / 32) {
        __syncwarp();
        panel_product<P, false>(V + (o + p) * p, R + o + p, p,
                                PK[(k + 1) & 1]);
      }
    }
    __syncthreads();
  }
  // the diagonal, then x of the last panel by the warp that owns its rows
  for (int row = tid; row < Np; row += NT) R[row] = Z[row] / D[row];
  {
    const int o = (nbp - 1) * p;
    if (split) __syncthreads();
    if (warp == (o % NT) / 32) {
      __syncwarp();
      panel_product<P, true>(V + o * p, R + o, p, PK[(nbp - 1) & 1]);
    }
  }
  __syncthreads();
  // backward: L' x = w.  Step k: each column left of the panel subtracts
  // the panel's rows of it times x_k; the warp that owns panel k - 1's rows
  // then computes x_{k-1} from them.
  for (int k = nbp - 1; k >= 0; --k) {
    const int o = k * p;
    float xk[kMaxPanel];
    load_panel<P>(PK[k & 1], p, xk);
    for (int row = tid; row < o + p; row += NT) {
      if (row < o) {
        float a0 = 0.f, a1 = 0.f;
        if (RES) {
          // column row of the panel's rows: strip j = row / p, local rows
          // from o - (j + 1) p
          const int j = row / p, c = row - j * p;
          const int rl0 = o - (j + 1) * p;
          const float* Sj = S + (size_t)(strip_row0(j, Np, p) + rl0) * p;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const float w = Sj[i * 16 + strip_col(rl0 + i, c)];
            if (i < 8)
              a0 = fmaf(w, xk[i], a0);
            else
              a1 = fmaf(w, xk[i], a1);
          }
        } else {
          const float* Lc = Lb + (size_t)o * Np + row;
#pragma unroll
          for (int i = 0; i < kMaxPanel; ++i)
            if (i < p) {
              const float w = __ldg(Lc + (size_t)i * Np);
              if (i < hp)
                a0 = fmaf(w, xk[i], a0);
              else
                a1 = fmaf(w, xk[i], a1);
            }
        }
        R[row] = R[row] - (a0 + a1);
      } else if (row < N) {
        x[b * (size_t)N + row] = pick(xk, row - o);
      }
    }
    if (k > 0) {
      if (split) __syncthreads();
      if (warp == ((o - p) % NT) / 32) {
        __syncwarp();
        panel_product<P, true>(V + (o - p) * p, R + o - p, p,
                               PK[(k - 1) & 1]);
      }
    }
    __syncthreads();
  }
}

template <int P, bool RES>
cudaError_t launch(const float* L, const float* d, const float* Linv,
                   const float* b, int B, int N, int Np, int p,
                   const CUtensorMap& map, float* x, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ldl_solve_kernel<P, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = (Np + 31) / 32 * 32;
  const int threads = rows < kThreads ? rows : kThreads;
  ldl_solve_kernel<P, RES><<<B, threads, smem, stream>>>(L, d, Linv, b, N,
                                                         Np, p, map, x);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that this
// library needs no link to libcuda, or null.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)f;
  }
  return fn;
}

}  // namespace

// Dynamic shared memory of one K8 block in a layout (ops/ldl_kernel.py::
// solve_smem_bytes mirrors it), or 0 when it does not fit beside the
// block's static shared memory (or the resident layout is asked for another
// panel than 16).
extern "C" long long ldl_solve_smem_bytes(int Np, int p, int resident) {
  if (resident && (p != 16 || Np / p > kMaxPanels)) return 0;
  const size_t bytes = 4 * smem_words(Np, p, resident != 0);
  return bytes + 8 * kMaxPanels <= kSmemLimit ? (long long)bytes : 0;
}

// Launches kernel K8 on `stream`: L (B, Np, Np), d (B, Np), Linv (B, Np, p),
// b (B, N) -> x (B, N), in the resident layout (resident = 1; p = 16) or
// the streamed one; at p = 16, L, d and Linv 16-byte aligned.  Returns the
// CUDA error code (0 = success).
extern "C" int ldl_solve_f32(const float* L, const float* d, const float* Linv,
                             const float* b, int B, int N, int Np, int p,
                             int resident, float* x, void* stream) {
  if (!dims_ok(B, N, Np, p)) return (int)cudaErrorInvalidValue;
  const long long smem = ldl_solve_smem_bytes(Np, p, resident);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap map{};
  if (p != 16)
    return (int)launch<0, false>(L, d, Linv, b, B, N, Np, p, map, x,
                                 (size_t)smem, st);
  if ((uintptr_t)L % 16 || (uintptr_t)d % 16 || (uintptr_t)Linv % 16)
    return (int)cudaErrorInvalidValue;
  if (!resident)
    return (int)launch<16, false>(L, d, Linv, b, B, N, Np, p, map, x,
                                  (size_t)smem, st);
  // the tensor map of the strips' boxes: 16 x 16 tiles of L (B, Np, Np),
  // 64-byte rows swizzled
  EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)Np, (cuuint64_t)Np, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)Np * 4, (cuuint64_t)Np * Np * 4};
  const cuuint32_t box[3] = {16, 16, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)L, dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return (int)launch<16, true>(L, d, Linv, b, B, N, Np, p, map, x,
                               (size_t)smem, st);
}
