// The fused factor + explicit inverse of kernels K9 and K10: the inverse of
// the pivot-regularized quasidefinite KKT matrix in one launch.
//
// Replaces two Pallas TPU kernels of cvxpygen_tpu/ops/ldl_kernel.py that
// compute the same function, K (B, N, N) -> Kinv (B, N, N) of the
// pivot-regularized K padded internally to Np = nbp * p with an identity
// tail: _factor_inverse_kernel (K9, wrapper ldl_factor_inverse_pallas, the
// conic IPM's 'ldl' KKT mode under CPG_LDL_FUSED=1 and both levels of its
// two-level route) and _factor_inverse_bm_kernel (K10, wrapper
// ldl_kinv_pallas, under CPG_LDL_BM_FUSED=1).  The two differ on the TPU
// only in layout: K9 interleaves instances on the vector lanes, K10 keeps
// them batch-major.  Their wrappers, ldl_factor_inverse_kernel and
// ldl_kinv_kernel in cvxpygen_tpu_torch/ops/ldl_kernel.py, both launch this
// kernel (plain versions ldl_factor_inverse_plain and ldl_kinv_plain there;
// the module builds and binds this file, nvcc for sm_90a, ctypes, and
// mirrors its layout rule in kinv_layout).
//
// What bounds it.  At the entropy family's shape (N = 161, Np = 176,
// B = 1024, float32) the function must read K's lower triangle (53 MB) and
// write Kinv (106 MB): 0.048 ms at 3.35 TB/s.  It needs N^3 FLOP per
// instance (N^3 / 3 for the factor, 2 N^3 / 3 for the inverse; 4.3 GFLOP
// in all, 0.064 ms at the FP32 peak).  So operations bound it, narrowly.
//
// Design.  One block of 256 threads per instance runs kernel K6's
// factorization and then kernel K7's sweeps, from their shared device code
// (csrc/ldl_tiles.cuh) and in their order, so Kinv is bitwise that of K7 on
// K6's factor, both triangles.
// - Resident layout (Np <= 272; two blocks per SM at Np = 176).  The block
//   factors the lower triangle's 16 x 16 tiles in shared memory as K6
//   does, but keeps the panel inverses and pivots beside them instead of
//   writing L, d and Linv to device memory.  It then builds its instance's
//   column tiles of Kinv one after the other, K7's tile of W = 32 columns
//   (16 for N <= 16) in shared memory beside the factor: the forward sweep
//   from the tile's first panel, the diagonal, the backward sweep back to
//   it, the lower triangle computed and the upper one mirrored, L21 read
//   straight from the tiles.  L never leaves the SM: what fusing saves is
//   K6's store of L (127 MB at B = 1024) and K7's staging of it through L2.
// - Scratch layout (larger Np).  The tiles, the panel inverses, the
//   pivots and R, the tile's right-hand block, go to a device scratch
//   (K6's path above Np = 320) and the sweeps stage L from there by
//   cp.async, as K7 does.  Every N has a launch.
#include "ldl_tiles.cuh"

namespace {

using namespace cvxldl;

// the layouts: 0 the factor resident in shared memory; 1 the factor and R
// in the device scratch
constexpr int kResident = 0;
constexpr int kScratch = 1;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Dynamic shared memory of one block in `layout` (the static PanelOut pair
// comes on top): resident, the tiles, R, the panel inverses, the pivots
// and Z; else K7's block with R in the scratch.
size_t smem_bytes(int Np, int p, int W, int layout) {
  if (layout == kScratch) return sweep_smem_bytes(Np, p, W, false);
  return 4 * ((size_t)n_tiles(Np / p) * kTileWords + (size_t)Np * (W + 4) +
              round4(Np * p) + round4(Np) + (size_t)kMaxPanel * W);
}

// Floats of one instance's device scratch: the tiles, the panel inverses,
// the pivots and R, each part a multiple of 4.
__host__ __device__ inline long long scratch_words(int Np, int p, int W,
                                                   int layout) {
  if (layout == kResident) return 0;
  return (long long)n_tiles(Np / p) * kTileWords + round4(Np * p) +
         round4(Np) + (long long)Np * (W + 4);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    kinv_resident_kernel(const float* __restrict__ K, int N, int Np, int p,
                         const float* __restrict__ signs, float delta,
                         float* __restrict__ Kinv) {
  constexpr int RS = W + 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) PanelOut po[2];
  const size_t b = blockIdx.x;
  // the tiles, R (Np x RS), the panel inverses (Np x p), the pivots, Z
  // (16 x W), each part from a 16-byte line
  float* A = smem;
  float* R = A + (size_t)n_tiles(Np / p) * kTileWords;
  float* V = R + (size_t)Np * RS;
  float* dd = V + round4(Np * p);
  float* sZ = dd + round4(Np);
  factor_tiles(A, K + b * (size_t)N * N, N, Np, p, signs, delta, po, V, dd);
  const ResidentL acc{A, V, dd};
  float* Kb = Kinv + b * (size_t)N * N;
  for (int j0 = 0; j0 < N; j0 += W) {
    if (j0) __syncthreads();  // the last tile's R has been stored
    inverse_tile<W>(acc, R, sZ, N, Np, p, j0, Kb);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    kinv_scratch_kernel(const float* __restrict__ K, int N, int Np, int p,
                        const float* __restrict__ signs, float delta,
                        float* scratch, float* __restrict__ Kinv) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) PanelOut po[2];
  const size_t b = blockIdx.x;
  // the instance's tiles, panel inverses, pivots and R; Z and the stages
  // in shared memory
  float* A = scratch + b * (size_t)scratch_words(Np, p, W, kScratch);
  float* V = A + (size_t)n_tiles(Np / p) * kTileWords;
  float* dd = V + round4(Np * p);
  float* R = dd + round4(Np);
  float* sZ = smem;
  factor_tiles(A, K + b * (size_t)N * N, N, Np, p, signs, delta, po, V, dd);
  // the factor's stores reach L2, where cp.async.cg reads them
  __threadfence();
  __syncthreads();
  const StagedL<TiledL> acc{
      TiledL{A, V, dd}, sZ + kMaxPanel * W, stage_words(Np, p),
      Np > p ? chunk_len(Np, p) : 0};
  float* Kb = Kinv + b * (size_t)N * N;
  for (int j0 = 0; j0 < N; j0 += W) {
    if (j0) __syncthreads();  // R stored, the stages read
    inverse_tile<W>(acc, R, sZ, N, Np, p, j0, Kb);
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // the carveout that lets two blocks share an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int W>
cudaError_t launch(const float* K, int B, int N, int Np, int p,
                   const float* signs, float delta, float* Kinv,
                   float* scratch, int layout, cudaStream_t st) {
  const size_t smem = smem_bytes(Np, p, W, layout);
  cudaError_t err;
  if (layout == kResident) {
    err = allow_smem(kinv_resident_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    kinv_resident_kernel<W>
        <<<B, kThreads, smem, st>>>(K, N, Np, p, signs, delta, Kinv);
  } else {
    err = allow_smem(kinv_scratch_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    kinv_scratch_kernel<W><<<B, kThreads, smem, st>>>(
        K, N, Np, p, signs, delta, scratch, Kinv);
  }
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block at tile width `width` (16 or 32) in
// `layout` (0: the factor resident; 1: the factor and R in the device
// scratch), or 0 when the block's shared memory (with its static PanelOut
// pair) exceeds the per-block limit.  ops/ldl_kernel.py::kinv_layout
// mirrors it.
extern "C" long long ldl_kinv_smem_bytes(int Np, int p, int width,
                                         int layout) {
  if (layout != kResident && layout != kScratch) return 0;
  const size_t bytes = smem_bytes(Np, p, width, layout);
  return bytes + 2 * sizeof(PanelOut) <= kSmemLimit ? (long long)bytes : 0;
}

// Floats of one instance's device scratch in `layout` (0 for layout 0).
extern "C" long long ldl_kinv_scratch_words(int Np, int p, int width,
                                            int layout) {
  return scratch_words(Np, p, width, layout);
}

// Launches the fused kernel on `stream`: K (B, N, N); signs (Np,) +-1;
// Kinv (B, N, N) out; tiles of `width` columns (16 or 32); `scratch` null in
// layout 0, else B * ldl_kinv_scratch_words floats, 16-byte aligned.  The
// panel is 16 or, with one panel, N.  Returns the CUDA error code (0 =
// success).
extern "C" int ldl_kinv_f32(const float* K, int B, int N, int Np, int p,
                            const float* signs, float delta, int width,
                            int layout, float* scratch, float* Kinv,
                            void* stream) {
  if (!dims_ok(B, N, Np, p) || (p != kMaxPanel && Np != p) ||
      (width != 16 && width != 32) ||
      ldl_kinv_smem_bytes(Np, p, width, layout) == 0 ||
      (layout == kResident) != (scratch == nullptr) ||
      (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return width == 16
             ? (int)launch<16>(K, B, N, Np, p, signs, delta, Kinv, scratch,
                               layout, st)
             : (int)launch<32>(K, B, N, Np, p, signs, delta, Kinv, scratch,
                               layout, st);
}
