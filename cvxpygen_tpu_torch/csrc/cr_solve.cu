// Kernel K4: x = M^-1 b for one shared block-tridiagonal SPD M, given its
// packed cyclic-reduction factor, for B right-hand sides.
//
// Replaces cvxpygen_tpu/ops/banded_shared_kernel.py::_cr_solve_only_kernel
// (the Pallas TPU kernel; wrapper cr_solve_pallas) and computes the same
// function in the same layout: b and x are (nb, s, B), one instance per
// column.  Its plain torch version is cr_solve_plain in
// cvxpygen_tpu_torch/ops/banded_shared_kernel.py, which also builds and
// binds this file (nvcc for sm_90a, ctypes).  The shared-KKT banded solve
// loop for nb > 96 (solvers/admm_banded_shared.py::_impl_crk) launches it
// once per ADMM iteration.
//
// What bounds it.  At the charging T=1440 shape (nb=541, s=8, 2711 packed
// blocks, B=256) the kernel must read b and write x, 2 * 4328 * 256 floats
// (8.9 MB), and read the 0.69 MB factor once: about 3 us at 3.35 TB/s.  Its
// 2 * 64 * 2711 FLOP per instance (89 MFLOP in all) take about 1.3 us at
// the FP32 peak.  So it is bytes-bound, and at that size the launch and
// the level-by-level barriers of a simple design dominate.
//
// Design (a first version that is right before it is fast): one block of
// 256 threads per instance.  The instance's right-hand side, the CR stack
// and the solution live in shared memory (2 * 542 * 8 + 546 * 8 floats,
// 52 KB at charging), so four blocks fit an SM and B=256 is one wave.
// Threads take the (block, row) pairs of a level (csrc/cr.cuh); the factor
// comes from L2, where every instance's block reads it (0.69 MB per
// instance, L2 traffic rather than HBM traffic), four floats per load.  The
// column of one instance is strided by B in (nb, s, B): each block reads
// and writes its column with stride-B accesses, whose 32-byte sectors the
// neighbouring instances' blocks share in L2.
#include <cuda_runtime.h>
#include <stddef.h>

#include "cr.cuh"

namespace {

using namespace cvxk;

constexpr size_t kSmemLimit = 232448;

__global__ void __launch_bounds__(kThreads)
    cr_solve_kernel(const float* __restrict__ fac, const float* __restrict__ b,
                    float* __restrict__ x, int B, const CrMeta cm) {
  extern __shared__ __align__(16) float smem[];
  __shared__ CrLevel lv[kCrMaxLevels];
  const int nbs = cm.nb * cm.s;
  const int nbp = (cm.nb + (cm.nb & 1)) * cm.s;
  float* buf0 = smem;
  float* buf1 = buf0 + nbp;
  float* stack = buf1 + nbp;
  cr_load_levels(cm, lv);
  const size_t j = blockIdx.x;
  for (int e = threadIdx.x; e < nbs; e += kThreads)
    buf0[e] = b[(size_t)e * B + j];
  const float* xs = cr_solve_block(fac, lv, cm.n_levels, cm.root, cm.s, buf0,
                                   buf1, stack);
  for (int e = threadIdx.x; e < nbs; e += kThreads)
    x[(size_t)e * B + j] = xs[e];
}

}  // namespace

// Launches kernel K4 on `stream`; `meta` is the host int array of
// cr_meta_array.  Returns the CUDA error code (0 = success).
extern "C" int cr_solve_f32(const float* fac, const float* b, float* x, int B,
                            const int* meta, void* stream) {
  CrMeta cm;
  if (B <= 0 || !cr_meta_from(meta, &cm)) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * cr_smem_words(cm);
  if (smem > kSmemLimit - sizeof(CrLevel) * kCrMaxLevels)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cr_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cr_solve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(fac, b, x, B,
                                                               cm);
  return (int)cudaGetLastError();
}
