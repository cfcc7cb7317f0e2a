// The packed factor of block cyclic reduction (CR) for one shared
// block-tridiagonal SPD system, as the kernels that solve with it read it:
// its level table.  The solve itself, for a group of instances per thread
// block, is csrc/cr_group.cuh's (kernels K4, K5 and K11).
//
// The factor layout is ops/banded_grouped.py::pack_cr_levels: per level
// [Dinv_odd (n2), A (n2 - 1), C (n2), L_left (n2 - 1), L_even (n2)], then
// the root inverse, each an s x s row-major block.  It mirrors the
// reference's _cr_solve_inkernel (cvxpygen_tpu/ops/banded_shared_kernel.py):
// the forward sweep halves the block count per level,
//   b'_t = b_2t - A_{t-1} b_{2t-1} - C_t b_{2t+1}
// (the odd blocks zero past the level's block count); the root block is
// x = Root b'; the backward sweep recovers each level's odd blocks,
//   x_{2t+1} = Dinv_t (b_{2t+1} - L_even_t x_2t - L_left_t' x_{2t+2}),
// and interleaves them with the even ones.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm.cuh"

namespace cvxk {

constexpr int kCrMaxLevels = 32;

// One level of the packed factor (ops/banded_shared_kernel.py::
// cr_meta_array): its block count, its n2 = ceil(nb_in / 2), the block
// offsets of Dinv_odd, A (and its count), C, L_left (and its count) and
// L_even.
struct CrLevel {
  int nb_in, n2, oD, oA, nA, oC, oLl, nLl, oLe;
};

struct CrMeta {
  int n_levels, root, nb, s;
  CrLevel lv[kCrMaxLevels];
};

constexpr int kCrHeader = 4;
constexpr int kCrLevelInts = 9;

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
                        p[5], p[6], p[7], p[8]};
  }
  return true;
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

}  // namespace cvxk
