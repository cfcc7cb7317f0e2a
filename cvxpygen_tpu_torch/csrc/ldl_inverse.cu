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
// - Shared code.  The sweep is csrc/ldl_tiles.cuh::inverse_tile, with L
//   read through an accessor: here the staged one (StagedL on K6's
//   row-major L); the fused kernel (csrc/ldl_kinv.cu) runs the same sweep
//   on the factor it keeps in shared memory.  Kinv leaves as 16-byte
//   stores wherever a row's aligned quad lies inside the tile's run.
// The panel is 16, or N itself below 16 (one panel, no update), as K6's
// factor gives it.
#include "ldl_tiles.cuh"

namespace {

using namespace cvxldl;

// Resident: R in shared memory (a compile-time fact, so that its loads and
// stores are shared-memory ones), else in the block's rows of `scratch`.
template <int W, bool Resident>
__global__ void __launch_bounds__(kThreads, 4)
    ldl_inverse_kernel(const float* __restrict__ L,
                       const float* __restrict__ d,
                       const float* __restrict__ Linv, int N, int Np, int p,
                       int ntiles, float* __restrict__ scratch,
                       float* __restrict__ Kinv) {
  constexpr int RS = W + 4;  // row stride of R
  extern __shared__ __align__(16) float smem[];
  // R (Np, RS), and Z_k or X_k (16, W), then the stages
  float* R = Resident ? smem : scratch + (size_t)blockIdx.x * Np * RS;
  float* sZ = Resident ? smem + (size_t)Np * RS : smem;
  const size_t b = blockIdx.x / ntiles;
  const int j0 = (blockIdx.x - (int)b * ntiles) * W;
  const StagedL<RowMajorL> acc{
      RowMajorL{L + b * (size_t)Np * Np, Linv + b * (size_t)Np * p,
                d + b * (size_t)Np, Np},
      sZ + kMaxPanel * W, stage_words(Np, p), Np > p ? chunk_len(Np, p) : 0};
  inverse_tile<W>(acc, R, sZ, N, Np, p, j0,
                           Kinv + b * (size_t)N * N);
}

template <int W, bool Resident>
cudaError_t launch(const float* L, const float* d, const float* Linv, int B,
                   int N, int Np, int p, float* scratch, float* Kinv,
                   cudaStream_t stream) {
  const size_t smem = sweep_smem_bytes(Np, p, W, Resident);
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
  const size_t bytes = sweep_smem_bytes(Np, p, width, resident != 0);
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
