// Kernel K9: the explicit inverse of the pivot-regularized quasidefinite
// KKT matrix, factor and inverse in one launch, with the instances
// interleaved so that one instruction stream covers several of them.
//
// Replaces cvxpygen_tpu/ops/ldl_kernel.py::_factor_inverse_kernel (wrapper
// ldl_factor_inverse_pallas, lane-block rule pick_fi_block), the Pallas TPU
// kernel that the conic IPM's 'ldl' KKT mode runs once per iteration under
// CPG_LDL_FUSED=1 (also for both levels of the two-level route), and
// computes the same function: K (B, N, N) -> Kinv (B, N, N) of the
// pivot-regularized K.  The wrapper, ldl_factor_inverse_kernel in
// cvxpygen_tpu_torch/ops/ldl_kernel.py, hands it the reference's layout:
// K padded to Np = nbp * p with an identity tail and transposed to
// T (Np, Np, B), instances on the fastest axis; it receives Kinv as
// (N, N, B) and transposes it back.  Its plain torch version is
// ldl_factor_inverse_plain in the same module, which also builds and binds
// this file (nvcc for sm_90a, ctypes).
//
// What bounds it.  At the entropy family's shape (N = 161, Np = 176,
// B = 1024, float32) the function must read K's lower triangle (53 MB) and
// write Kinv (106 MB): 0.048 ms at 3.35 TB/s; its N^3 FLOP per instance
// take 0.064 ms at the FP32 peak.  So operations bound it, narrowly.
//
// Design (a first version that is right before it is fast).  A block of
// 512 threads takes G consecutive instances (G = 8: one 32-byte sector of
// T per matrix entry), thread t serving instance t % G, so every load of
// T[i][j][b0 : b0 + G] is one coalesced sector and the warps of the block
// split the rows of each step.  At B = 1024 that is 128 blocks, one wave on
// the card's 132 SMs (32-instance groups would give 32 blocks).  One
// instance's trailing matrix (124 KB at Np = 176) times G does not fit in
// shared memory, so it lives in T, in device memory and L2, and only the
// current panel is staged in shared memory:
//   phase 1, per panel: the p x p diagonal block (p rank-1 steps between
//   barriers); L11's inverse by forward substitution, one thread per
//   (column, instance), written to the scratch V (Np, p, B); L21 = A21 Minv,
//   one thread per (row, instance), to shared memory and in place of A21 in
//   T; the trailing update of T's lower triangle (the matrix stays
//   symmetric, so the reference's full square is not needed) with L21 read
//   from shared memory, four entries per thread in flight;
//   phase 2: the inverse in strips of W columns (W = 32 fits beside the
//   buffers at Np = 176; evened out, six strips of 27 at N = 161), each
//   strip (Np, W, G) in shared memory through kernel K7's forward, diagonal
//   and backward panel sweeps, L read from T once per strip and row, the
//   panel inverses staged from V, and the strip written to Kinv.
// Shared memory: about 196 KB at Np = 176 and G = 8, one block per SM.
// The wrapper's `group` caps G (chip_smoke.py phase 12 times 8, 4 and 2:
// smaller groups give more blocks per SM but read T in partial sectors);
// wider Np takes fewer instances per block when G = 8 does not fit.
#include "ldl.cuh"

namespace {

using namespace cvxldl;

constexpr int kFiThreads = 512;
constexpr int kMaxStripFi = 32;
// trailing-update entries per thread whose loads are in flight together
constexpr int kBatch = 4;

struct FiDims {
  int B, N, Np, p, G, W, S;  // S: row stride of the shared L21 buffer
};

__global__ void __launch_bounds__(kFiThreads)
    ldl_fi_kernel(float* __restrict__ T, const float* __restrict__ signs,
                  float delta, const FiDims dm, float* __restrict__ V,
                  float* __restrict__ KinvT) {
  extern __shared__ __align__(16) float smem[];
  const int B = dm.B, N = dm.N, Np = dm.Np, p = dm.p, G = dm.G, W = dm.W,
            S = dm.S;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const size_t ld = (size_t)B;
  float* sd = smem;             // (Np, G) pivots
  float* sP = sd + Np * G;      // (p, p, G) diagonal block, then L11
  float* sV = sP + p * p * G;   // (p, p, G) panel inverse
  float* sM = sV + p * p * G;   // (p, p, G) Minv = (D1 L11')^-1
  float* big = sM + p * p * G;  // phase 1: L21 (rest, S); phase 2: R, Z
  // T (and V) entry (r, c) of instance b0 + l
  auto tix = [&](int r, int c, int l) {
    return ((size_t)r * Np + c) * ld + b0 + l;
  };
  const int nbp = Np / p;

  // ---- phase 1: the factor, panel by panel ------------------------------
  for (int k = 0; k < nbp; ++k) {
    const int o = k * p;
    const int rest = Np - o - p;
    for (int e = tid; e < p * p * G; e += kFiThreads) {
      const int l = e % G, rc = e / G, r = rc / p, c = rc - r * p;
      sP[e] = (c <= r && b0 + l < B) ? T[tix(o + r, o + c, l)] : 0.0f;
    }
    // unblocked LDL of the diagonal block, in place: step j reads column j
    // and writes only columns > j
    for (int j = 0; j < p; ++j) {
      __syncthreads();
      const float sj = signs[o + j];
      for (int e = tid; e < p * p * G; e += kFiThreads) {
        const int l = e % G, rc = e / G, r = rc / p, c = rc - r * p;
        if (c > j && c <= r) {
          const float v = sj * sP[(j * p + j) * G + l];
          const float dj = sj * ((v < delta) ? delta : v);  // NaN stays NaN
          const float cr = sP[(r * p + j) * G + l] / dj;
          const float cc = sP[(c * p + j) * G + l] / dj;
          sP[e] -= dj * cr * cc;
        }
      }
      if (tid < G) {
        const float v = sj * sP[(j * p + j) * G + tid];
        sd[(o + j) * G + tid] = sj * ((v < delta) ? delta : v);
      }
    }
    __syncthreads();
    // L11 below the diagonal: column c divided by its pivot
    for (int e = tid; e < p * p * G; e += kFiThreads) {
      const int l = e % G, rc = e / G, r = rc / p, c = rc - r * p;
      if (r > c) sP[e] = sP[e] / sd[(o + c) * G + l];
    }
    __syncthreads();
    // its inverse by forward substitution, one thread per (column,
    // instance): X[i][c] = e_i[c] - sum_{j<i} L11[i][j] X[j][c]
    if (tid < p * G) {
      const int l = tid % G, c = tid / G;
      for (int i = 0; i < p; ++i) {
        float acc = (i == c) ? 1.0f : 0.0f;
        for (int j = 0; j < i; ++j)
          acc -= sP[(i * p + j) * G + l] * sV[(j * p + c) * G + l];
        sV[(i * p + c) * G + l] = acc;
      }
    }
    __syncthreads();
    // the panel inverse to V; Minv[i][c] = Linv[c][i] / d[c]
    for (int e = tid; e < p * p * G; e += kFiThreads) {
      const int l = e % G, ic = e / G, i = ic / p, c = ic - i * p;
      if (b0 + l < B) V[((size_t)(o + i) * p + c) * ld + b0 + l] = sV[e];
      sM[e] = sV[(c * p + i) * G + l] / sd[(o + c) * G + l];
    }
    __syncthreads();
    if (rest == 0) break;
    // L21 = A21 Minv, one thread per (row, instance): to shared memory and
    // in place of A21 in T (phase 2 reads it there)
    float* sL = big;
    for (int t = tid; t < rest * G; t += kFiThreads) {
      const int l = t % G, r = t / G;
      float* out = sL + (size_t)r * S + l;
      if (b0 + l >= B) {
        for (int c = 0; c < p; ++c) out[c * G] = 0.0f;
        continue;
      }
      float a[kMaxPanel];
#pragma unroll
      for (int j = 0; j < kMaxPanel; ++j)
        if (j < p) a[j] = T[tix(o + p + r, o + j, l)];
      for (int c = 0; c < p; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxPanel; ++j)
          if (j < p) acc += a[j] * sM[(j * p + c) * G + l];
        out[c * G] = acc;
        T[tix(o + p + r, o + c, l)] = acc;
      }
    }
    __syncthreads();
    // trailing update of the lower triangle: A22 -= (L21 D1) L21'
    const int tot = rest * rest * G;
    const float* dk = sd + o * G;
    for (int base = tid; base < tot; base += kBatch * kFiThreads) {
      size_t ix[kBatch];
      float tv[kBatch];
      int rr[kBatch], cc[kBatch], ll[kBatch];
      bool on[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kFiThreads;
        const int l = e % G, rc = e / G, r = rc / rest, c = rc - r * rest;
        on[u] = e < tot && c <= r && b0 + l < B;
        rr[u] = r;
        cc[u] = c;
        ll[u] = l;
        ix[u] = tix(o + p + r, o + p + c, l);
        tv[u] = on[u] ? T[ix[u]] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!on[u]) continue;
        const float* lr = sL + (size_t)rr[u] * S + ll[u];
        const float* lc = sL + (size_t)cc[u] * S + ll[u];
        const float* dl = dk + ll[u];
        float acc = 0.0f;
        for (int j = 0; j < p; ++j)
          acc += (lr[j * G] * dl[j * G]) * lc[j * G];
        T[ix[u]] = tv[u] - acc;
      }
    }
    __syncthreads();
  }

  // ---- phase 2: the inverse, W columns at a time -------------------------
  float* R = big;                      // (Np, W, G)
  float* Z = big + (size_t)Np * W * G;  // (p, W, G)
  for (int j0 = 0; j0 < N; j0 += W) {
    const int w = min(W, N - j0);
    __syncthreads();
    for (int e = tid; e < Np * W * G; e += kFiThreads) {
      const int rc = e / G, r = rc / W, c = rc - r * W;
      R[e] = (c < w && r == j0 + c) ? 1.0f : 0.0f;
    }
    // forward: L Z = I.  Z_k = Linv_k R_k; R[below] -= L21 Z_k (the rows
    // above the panel of j0 stay zero)
    for (int k = j0 / p; k < nbp; ++k) {
      const int o = k * p;
      const int rest = Np - o - p;
      __syncthreads();
      for (int e = tid; e < p * p * G; e += kFiThreads) {
        const int l = e % G, ic = e / G, i = ic / p, c = ic - i * p;
        sV[e] = (b0 + l < B) ? V[((size_t)(o + i) * p + c) * ld + b0 + l]
                             : 0.0f;
      }
      __syncthreads();
      for (int e = tid; e < p * W * G; e += kFiThreads) {
        const int l = e % G, ic = e / G, i = ic / W, c = ic - i * W;
        float acc = 0.0f;
        for (int j = 0; j < p; ++j)
          acc += sV[(i * p + j) * G + l] * R[((o + j) * W + c) * G + l];
        Z[e] = acc;
      }
      __syncthreads();
      for (int e = tid; e < p * W * G; e += kFiThreads)
        R[(size_t)o * W * G + e] = Z[e];
      for (int t = tid; t < rest * G; t += kFiThreads) {
        const int l = t % G, r = t / G;
        if (b0 + l >= B) continue;
        float a[kMaxPanel];
#pragma unroll
        for (int j = 0; j < kMaxPanel; ++j)
          if (j < p) a[j] = T[tix(o + p + r, o + j, l)];
        float* row = R + (size_t)(o + p + r) * W * G + l;
        for (int c = 0; c < W; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < kMaxPanel; ++j)
            if (j < p) acc += a[j] * Z[(j * W + c) * G + l];
          row[c * G] -= acc;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < Np * W * G; e += kFiThreads) {
      const int l = e % G, r = e / G / W;
      R[e] /= sd[r * G + l];
    }
    // backward: L' X = W.  X_k = Linv_k' R_k; R[above] -= L[k rows, above]'
    // X_k, with L[o + i][r] the entry (o + i, r) of T
    for (int k = nbp - 1; k >= 0; --k) {
      const int o = k * p;
      __syncthreads();
      for (int e = tid; e < p * p * G; e += kFiThreads) {
        const int l = e % G, ic = e / G, i = ic / p, c = ic - i * p;
        sV[e] = (b0 + l < B) ? V[((size_t)(o + i) * p + c) * ld + b0 + l]
                             : 0.0f;
      }
      __syncthreads();
      for (int e = tid; e < p * W * G; e += kFiThreads) {
        const int l = e % G, ic = e / G, i = ic / W, c = ic - i * W;
        float acc = 0.0f;
        for (int j = 0; j < p; ++j)
          acc += sV[(j * p + i) * G + l] * R[((o + j) * W + c) * G + l];
        Z[e] = acc;
      }
      __syncthreads();
      for (int e = tid; e < p * W * G; e += kFiThreads)
        R[(size_t)o * W * G + e] = Z[e];
      for (int t = tid; t < o * G; t += kFiThreads) {
        const int l = t % G, r = t / G;
        if (b0 + l >= B) continue;
        float a[kMaxPanel];
#pragma unroll
        for (int i = 0; i < kMaxPanel; ++i)
          if (i < p) a[i] = T[tix(o + i, r, l)];
        float* row = R + (size_t)r * W * G + l;
        for (int c = 0; c < W; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < kMaxPanel; ++i)
            if (i < p) acc += a[i] * Z[(i * W + c) * G + l];
          row[c * G] -= acc;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < N * W * G; e += kFiThreads) {
      const int l = e % G, rc = e / G, r = rc / W, c = rc - r * W;
      if (c < w && b0 + l < B)
        KinvT[((size_t)r * N + j0 + c) * ld + b0 + l] = R[e];
    }
  }
}

// The instances per block G (max_group, a power of two up to 8, else the
// most below it whose buffers fit) and the strip width W (at most
// kMaxStripFi, evened out over the strips that N needs), with the dynamic
// shared memory they take.  False when no G fits.
bool plan(int N, int Np, int p, int max_group, FiDims* dm, size_t* smem) {
  if (max_group < 1 || max_group > 8 || (max_group & (max_group - 1)))
    return false;
  for (int G = max_group; G >= 1; G /= 2) {
    const long long fixed = (long long)Np * G + 3LL * p * p * G;
    const long long S = (long long)p * G + G;  // keeps the L21 rows'
                                               // banks apart
    const long long l21 = (long long)(Np - p) * S;
    const long long avail = (long long)kSmemLimit / 4 - fixed;
    long long W = avail / ((long long)(Np + p) * G);
    if (W > kMaxStripFi) W = kMaxStripFi;
    if (W < 1 || l21 > avail) continue;
    const long long strips = (N + W - 1) / W;
    W = (N + strips - 1) / strips;
    const long long strip = (long long)(Np + p) * W * G;
    *dm = FiDims{0, N, Np, p, G, (int)W, (int)S};
    *smem = 4 * (size_t)(fixed + (l21 > strip ? l21 : strip));
    return true;
  }
  return false;
}

}  // namespace

// Instances per block (G) that kernel K9 takes at this shape with at most
// max_group, 0 when it cannot run.
extern "C" int ldl_fi_group(int N, int Np, int p, int max_group) {
  FiDims dm;
  size_t smem;
  return plan(N, Np, p, max_group, &dm, &smem) ? dm.G : 0;
}

// Launches kernel K9 on `stream`.  T (Np, Np, B): the padded K transposed,
// overwritten (the trailing matrix, then L); signs (Np,) +-1; V (Np, p, B)
// scratch for the panel inverses; KinvT (N, N, B) out; at most max_group
// instances per block.  Returns the CUDA error code (0 = success).
extern "C" int ldl_factor_inverse_f32(float* T, int B, int N, int Np, int p,
                                      const float* signs, float delta,
                                      float* V, float* KinvT, int max_group,
                                      void* stream) {
  FiDims dm;
  size_t smem;
  if (!dims_ok(B, N, Np, p) || !plan(N, Np, p, max_group, &dm, &smem))
    return (int)cudaErrorInvalidValue;
  dm.B = B;
  cudaError_t err = cudaFuncSetAttribute(
      ldl_fi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + dm.G - 1) / dm.G;
  ldl_fi_kernel<<<grid, kFiThreads, smem, (cudaStream_t)stream>>>(
      T, signs, delta, dm, V, KinvT);
  return (int)cudaGetLastError();
}
