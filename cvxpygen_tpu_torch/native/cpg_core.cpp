// Native host runtime: parametric canonicalization + dense ADMM QP solver.
//
// Role parity with the reference's generated embedded C (cpg_workspace.c /
// cpg_solve.c + vendored OSQP, see SURVEY.md L7): a
// dependency-free C++ core exposing a C API so a compiled problem family can
// be embedded in host applications (serving front-ends, embedded control)
// without Python or a TPU.  The TPU path (JAX) remains the scale path; this
// is the reference-float64 single-instance path.
//
// Algorithm: OSQP-style ADMM (Ruiz equilibration, per-row rho with
// equality scaling, dense LDL^T-free normal equations M = P + sigma I +
// A' diag(rho) A factored by dense Cholesky, residual-based termination)
// -- mirrors cvxpygen_tpu/solvers/admm.py.  With cones set
// (cpg_native_set_cones), the z-update projects SOC blocks onto the
// shifted cone (conic ADMM, SCS role -- mirrors solvers/conic_admm.py;
// the reference's embedded SCS C covers exactly zero/nonneg/SOC,
// reference cvxpygen/solvers/scs.py:130-135) and the Ruiz row scales are
// block-uniform on SOC rows (cone invariance).
//
// Canonicalization: theta-affine maps stored CSR; canonical tensors are
// dense row-major.  API: cpg_native_init / set_theta / update_theta /
// solve / getters / free.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct CsrMap {
  // rows = flattened tensor entries; cols = p+1 (theta_t)
  std::vector<int64_t> indptr;
  std::vector<int64_t> indices;
  std::vector<double> data;
  int64_t n_rows = 0;

  void apply(const double* theta_t, double* out) const {
    for (int64_t r = 0; r < n_rows; ++r) {
      double acc = 0.0;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k) {
        acc += data[k] * theta_t[indices[k]];
      }
      out[r] = acc;
    }
  }
};

struct Workspace {
  int64_t n = 0, m = 0, p = 0, n_eq = 0;
  CsrMap mapP, mapq, mapd, mapA, mapb;
  std::vector<double> theta_t;  // p + 1, last = 1
  // canonical data (dense, row-major)
  std::vector<double> P, q, A, b, l, u;
  double d_off = 0.0;
  std::vector<double> d_quad;  // (p+1)^2 or empty
  // solution
  std::vector<double> x, z, y;
  double obj = 0.0;
  int32_t iters = 0;
  int32_t status = 0;  // 1 = solved
  double pri_res = 0.0, dua_res = 0.0;
  // settings
  double rho = 0.1, rho_eq_scale = 1e3, sigma = 1e-6, alpha = 1.6;
  double eps_abs = 1e-3, eps_rel = 1e-3;
  int32_t max_iter = 4000, check_interval = 25, scaling = 10;
  bool warm_start = false;
  // cone layout (rows: n_eq zero | n_nonneg | SOC blocks | exp triples
  // | pow triples); empty = box QP.  Mirrors ops/cones.ConeLayout (PSD
  // stays Python/JAX-only: its projection needs an eigendecomposition,
  // which this dependency-free core deliberately excludes -- same
  // boundary the reference draws by embedding SCS (zero/nonneg/SOC
  // only, reference scs.py:130-135) and leaving PSD to Clarabel).
  int64_t n_nonneg = 0;
  std::vector<int64_t> socs;
  int64_t n_exp = 0;
  std::vector<double> pow_alphas;
  bool conic = false;
  // ---- sparse/banded mode (long-horizon families; reference sparse
  // CSC workspaces, utils.py:87-181) ----
  // P/A stay COO with FIXED sparsity (indices from codegen); only the
  // values are re-canonicalized per theta.  The KKT normal matrix
  // M = P + sigma I + A' rho A is factored as a BANDED Cholesky under a
  // codegen-time fill-reducing permutation (RCM), mirroring the TPU
  // banded engine's layout (solvers/admm_banded.py).
  bool sparse_mode = false;
  std::vector<int64_t> P_ii, P_jj, A_ii, A_jj;
  std::vector<double> Pval, Aval;
  std::vector<int64_t> perm;   // permuted index of each variable (pos)
  int64_t band_bw = -1;        // lower bandwidth of permuted M
};

const double kInf = 1e30;

void load_csr(CsrMap* mp, int64_t n_rows, const int64_t* indptr,
              const int64_t* indices, const double* data) {
  mp->n_rows = n_rows;
  mp->indptr.assign(indptr, indptr + n_rows + 1);
  int64_t nnz = indptr[n_rows];
  mp->indices.assign(indices, indices + nnz);
  mp->data.assign(data, data + nnz);
}

// dense Cholesky (lower), in place on SPD M (n x n row-major)
bool cholesky(std::vector<double>& M, int64_t n) {
  for (int64_t j = 0; j < n; ++j) {
    double diag = M[j * n + j];
    for (int64_t k = 0; k < j; ++k) diag -= M[j * n + k] * M[j * n + k];
    if (diag <= 0.0) return false;
    diag = std::sqrt(diag);
    M[j * n + j] = diag;
    for (int64_t i = j + 1; i < n; ++i) {
      double v = M[i * n + j];
      for (int64_t k = 0; k < j; ++k) v -= M[i * n + k] * M[j * n + k];
      M[i * n + j] = v / diag;
    }
  }
  return true;
}

void chol_solve(const std::vector<double>& L, int64_t n, double* x) {
  for (int64_t i = 0; i < n; ++i) {          // L v = x
    double v = x[i];
    for (int64_t k = 0; k < i; ++k) v -= L[i * n + k] * x[k];
    x[i] = v / L[i * n + i];
  }
  for (int64_t i = n - 1; i >= 0; --i) {     // L' x = v
    double v = x[i];
    for (int64_t k = i + 1; k < n; ++k) v -= L[k * n + i] * x[k];
    x[i] = v / L[i * n + i];
  }
}

double inf_norm(const double* v, int64_t n) {
  double out = 0.0;
  for (int64_t i = 0; i < n; ++i) out = std::max(out, std::fabs(v[i]));
  return out;
}

// exponential-cone projection (port of ops/cones.py _proj_exp_block:
// Friberg's univariate root h(alpha) with fixed-count bisection).
void proj_exp3(double v[3]) {
  double nrm = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  if (nrm < 1e-30) nrm = 1e-30;
  double r = v[0] / nrm, s = v[1] / nrm, t = v[2] / nrm;
  const double tol = 1e-7;
  auto safe_exp = [](double x) {
    return std::exp(std::min(std::max(x, -60.0), 60.0));
  };
  bool in_K = (s > 0 && s * safe_exp(r / s) <= t + tol) ||
              (std::fabs(s) <= tol && r <= tol && t >= -tol);
  if (in_K) return;
  double u1 = -r, u2 = -s, u3 = -t;
  bool in_polar = (u1 < 0 && -u1 * safe_exp(u2 / u1) <= 2.718281828459045 * u3 + tol) ||
                  (std::fabs(u1) <= tol && u2 >= -tol && u3 >= -tol);
  if (in_polar) { v[0] = v[1] = v[2] = 0.0; return; }
  double face[3] = {std::min(r, 0.0), 0.0, std::max(t, 0.0)};
  if (r <= 0 && s <= 0) {
    v[0] = face[0] * nrm; v[1] = 0.0; v[2] = face[2] * nrm; return;
  }
  const double AMAX = 30.0;
  double lo = -AMAX, hi = AMAX;
  if (r > 0) lo = std::max(lo, 1.0 - s / r);
  if (r < 0) hi = std::min(hi, 1.0 - s / r);
  if (s > 0) hi = std::min(hi, r / s);
  if (s < 0) lo = std::max(lo, r / s);
  lo = std::min(std::max(lo, -AMAX), AMAX);
  hi = std::min(std::max(hi, -AMAX), AMAX);
  double epsw = 1e-6 * (hi - lo);
  lo += epsw; hi -= epsw;
  auto h_of = [&](double a, double* x2o, double* eao) {
    double den = a * a - a + 1.0;
    double x2 = (r * (a - 1.0) + s) / den;
    double g = (r - a * s) / den;
    double ea = safe_exp(a);
    if (x2o) *x2o = x2;
    if (eao) *eao = ea;
    return x2 * ea - g / ea - t;
  };
  double h_lo = h_of(lo, nullptr, nullptr);
  double a = lo, b2 = hi;
  for (int i = 0; i < 64; ++i) {
    double mid = 0.5 * (a + b2);
    double hm = h_of(mid, nullptr, nullptr);
    bool left = ((hm >= 0) != (h_lo >= 0));
    if (left) b2 = mid; else a = mid;
  }
  double alpha = 0.5 * (a + b2), x2, ea;
  h_of(alpha, &x2, &ea);
  x2 = std::max(x2, 0.0);
  double root[3] = {alpha * x2, x2, x2 * ea};
  double d_root = 0.0, d_face = 0.0;
  double wv[3] = {r, s, t};
  for (int i = 0; i < 3; ++i) {
    d_root += (root[i] - wv[i]) * (root[i] - wv[i]);
    d_face += (face[i] - wv[i]) * (face[i] - wv[i]);
  }
  const double* best = (b2 - a <= 0 || d_face < d_root) ? face : root;
  for (int i = 0; i < 3; ++i) v[i] = best[i] * nrm;
}

// 3D power-cone projection (port of ops/cones.py _proj_pow_block, Hien
// 2015 parametrization with fixed-count bisection on Phi(r)).
void proj_pow3(double v[3], double a) {
  double r0 = v[0], s0 = v[1], t0 = v[2];
  double at = std::fabs(t0);
  const double tol = 1e-9;
  auto powa = [&](double x, double y) {
    double xs = std::max(x, 0.0), ys = std::max(y, 0.0);
    return std::pow(xs, a) * std::pow(ys, 1.0 - a);
  };
  if (r0 >= -tol && s0 >= -tol && powa(r0, s0) >= at - tol) return;
  if (r0 <= tol && s0 <= tol &&
      powa(-r0 / a, -s0 / (1.0 - a)) >= at - tol) {
    v[0] = v[1] = v[2] = 0.0; return;
  }
  if (at <= tol) {
    v[0] = std::max(r0, 0.0); v[1] = std::max(s0, 0.0); v[2] = 0.0;
    return;
  }
  auto xi = [&](double vi, double ai, double rr) {
    return 0.5 * (vi + std::sqrt(vi * vi + 4.0 * ai * rr * (at - rr)));
  };
  double lo = 1e-12 * std::max(at, 1.0), hi = at * (1.0 - 1e-7);
  for (int i = 0; i < 60; ++i) {
    double mid = 0.5 * (lo + hi);
    double phi = powa(xi(r0, a, mid), xi(s0, 1.0 - a, mid)) - mid;
    if (phi >= 0) lo = mid; else hi = mid;
  }
  double rr = 0.5 * (lo + hi);
  v[0] = xi(r0, a, rr);
  v[1] = xi(s0, 1.0 - a, rr);
  v[2] = (t0 >= 0 ? rr : -rr);
}

// dense LU with partial pivoting (row-major, in place); piv[i] = row
// swapped into position i.  Returns false on exact singularity.
bool lu_factor(std::vector<double>& K, std::vector<int64_t>& piv,
               int64_t N) {
  piv.assign(N, 0);
  for (int64_t j = 0; j < N; ++j) {
    int64_t pr = j;
    double pv = std::fabs(K[j * N + j]);
    for (int64_t i = j + 1; i < N; ++i) {
      double v = std::fabs(K[i * N + j]);
      if (v > pv) { pv = v; pr = i; }
    }
    if (pv == 0.0) return false;
    piv[j] = pr;
    if (pr != j)
      for (int64_t k = 0; k < N; ++k)
        std::swap(K[j * N + k], K[pr * N + k]);
    double dj = K[j * N + j];
    for (int64_t i = j + 1; i < N; ++i) {
      double f = K[i * N + j] / dj;
      K[i * N + j] = f;
      if (f == 0.0) continue;
      for (int64_t k = j + 1; k < N; ++k) K[i * N + k] -= f * K[j * N + k];
    }
  }
  return true;
}

void lu_solve(const std::vector<double>& K,
              const std::vector<int64_t>& piv, int64_t N, double* b) {
  for (int64_t j = 0; j < N; ++j)
    if (piv[j] != j) std::swap(b[j], b[piv[j]]);
  for (int64_t i = 1; i < N; ++i) {
    double v = b[i];
    for (int64_t k = 0; k < i; ++k) v -= K[i * N + k] * b[k];
    b[i] = v;
  }
  for (int64_t i = N - 1; i >= 0; --i) {
    double v = b[i];
    for (int64_t k = i + 1; k < N; ++k) v -= K[i * N + k] * b[k];
    b[i] = v / K[i * N + i];
  }
}

// Implicit differentiation of the box-QP solution map at the last solve
// (embedded counterpart of autodiff/qp_diff.py; fulfils the role of the
// reference's generated cpg_gradient C, templates/
// cpg_osqp_grad_compute.c.jinja2:432-529 -- same structure: active-set
// detection from the dual/slack, one regularized reduced-KKT solve,
// iterative refinement against the unregularized KKT, assembly of
// dP/dq/dA/db and the chain through the canonicalization maps'
// TRANSPOSE back to theta.  The reference maintains a sparse LDL with
// rank-1 updates; here the KKT is dense (the embedded core is dense
// throughout) and factored by LU with partial pivoting.)
//
// Derivation (box QP, rows l <= Ax <= u, active rows A_a x = c_a):
//   K = [[P, A_a'], [A_a, 0]],  K [rx; ry] = [gx; gy_a]
//   dL/dq = -rx ; dL/db = -ry_a ; dL/dP = -(rx x' + x rx')/2
//   dL/dA_a = -(y_a rx' + ry x')
// gx is the caller's seed dL/dx; gobj folds a dL/dobj seed through
// dobj/dx = Px + q plus the explicit dP/dq/dd terms.
int32_t gradient(Workspace* w, const double* gx_in, const double* gy_in,
                 double gobj, double* dtheta) {
  if (w->conic) return -1;  // box-QP families only (reference: OSQP-only)
  if (w->sparse_mode) return -4;  // dense-mode families only (the dense
                                  // reduced KKT would be (n+m)^2 here;
                                  // use the JAX banded vjp at this scale)
  const int64_t n = w->n, m = w->m, N = n + m;
  if ((int64_t)w->x.size() != n || (int64_t)w->y.size() != m) return -2;
  const double ACT_EPS = 1e-7, REG = 1e-6;
  const double* x = w->x.data();
  const double* y = w->y.data();
  const double* z = w->z.data();

  std::vector<double> gx(n, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    double px = 0.0;
    for (int64_t j = 0; j < n; ++j) px += w->P[i * n + j] * x[j];
    gx[i] = (gx_in ? gx_in[i] : 0.0) + gobj * (px + w->q[i]);
  }

  std::vector<uint8_t> act(m);
  for (int64_t k = 0; k < m; ++k) {
    bool aL = (y[k] < -ACT_EPS) || std::fabs(z[k] - w->l[k]) < ACT_EPS;
    bool aU = (y[k] > ACT_EPS) || std::fabs(z[k] - w->u[k]) < ACT_EPS;
    act[k] = (aL || aU) ? 1 : 0;
  }

  // reduced KKT with static regularization; inactive rows decouple via
  // the -1/REG diagonal (their masked rows/cols are zero)
  std::vector<double> K(N * N, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) K[i * N + j] = w->P[i * n + j];
    K[i * N + i] += REG;
  }
  for (int64_t k = 0; k < m; ++k) {
    if (act[k]) {
      for (int64_t j = 0; j < n; ++j) {
        double a = w->A[k * n + j];
        K[j * N + (n + k)] = a;
        K[(n + k) * N + j] = a;
      }
      K[(n + k) * N + (n + k)] = -REG;
    } else {
      K[(n + k) * N + (n + k)] = -1.0 / REG;
    }
  }
  std::vector<double> rhs(N, 0.0);
  for (int64_t i = 0; i < n; ++i) rhs[i] = gx[i];
  for (int64_t k = 0; k < m; ++k)
    rhs[n + k] = (gy_in && act[k]) ? gy_in[k] : 0.0;

  std::vector<double> F(K);
  std::vector<int64_t> piv;
  if (!lu_factor(F, piv, N)) return -3;
  std::vector<double> sol(rhs);
  lu_solve(F, piv, N, sol.data());
  // 3 refinement sweeps against the UNREGULARIZED KKT (parity with
  // qp_diff.py / the reference's cpg_grad refinement loop)
  std::vector<double> r(N), cor(N);
  for (int32_t sweep = 0; sweep < 3; ++sweep) {
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0.0;
      for (int64_t j = 0; j < n; ++j) acc += w->P[i * n + j] * sol[j];
      for (int64_t k = 0; k < m; ++k)
        if (act[k]) acc += w->A[k * n + i] * sol[n + k];
      r[i] = rhs[i] - acc;
    }
    for (int64_t k = 0; k < m; ++k) {
      double acc = 0.0;
      if (act[k]) {
        for (int64_t j = 0; j < n; ++j) acc += w->A[k * n + j] * sol[j];
      } else {
        acc = -sol[n + k] / REG;
      }
      r[n + k] = rhs[n + k] - acc;
    }
    cor = r;
    lu_solve(F, piv, N, cor.data());
    for (int64_t i = 0; i < N; ++i) sol[i] += cor[i];
  }
  const double* rx = sol.data();
  std::vector<double> ry(m, 0.0);
  for (int64_t k = 0; k < m; ++k) ry[k] = act[k] ? sol[n + k] : 0.0;

  // assemble dvals in the stacked dense-map row layout
  // [P (n*n) | q (n) | d (1) | A (m*n) | b (m)] and chain through each
  // CSR map's TRANSPOSE into theta_t
  int64_t p1 = w->p + 1;
  std::vector<double> dtt(p1, 0.0);
  auto chainT = [&](const CsrMap& mp, const double* dv) {
    for (int64_t rr = 0; rr < mp.n_rows; ++rr) {
      double v = dv[rr];
      if (v == 0.0) continue;
      for (int64_t k = mp.indptr[rr]; k < mp.indptr[rr + 1]; ++k)
        dtt[mp.indices[k]] += mp.data[k] * v;
    }
  };
  std::vector<double> dP(n * n), dqv(n), dA(m * n), db(m);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < n; ++j)
      dP[i * n + j] = -0.5 * (rx[i] * x[j] + x[i] * rx[j])
                      + gobj * 0.5 * x[i] * x[j];
  for (int64_t i = 0; i < n; ++i) dqv[i] = -rx[i] + gobj * x[i];
  for (int64_t k = 0; k < m; ++k)
    for (int64_t j = 0; j < n; ++j)
      dA[k * n + j] = -(y[k] * rx[j] + ry[k] * x[j]);
  for (int64_t k = 0; k < m; ++k) db[k] = -ry[k];
  double dd = gobj;
  chainT(w->mapP, dP.data());
  chainT(w->mapq, dqv.data());
  chainT(w->mapd, &dd);
  chainT(w->mapA, dA.data());
  chainT(w->mapb, db.data());
  if (!w->d_quad.empty() && gobj != 0.0) {
    const double* tt = w->theta_t.data();
    for (int64_t i = 0; i < p1; ++i) {
      double acc = 0.0;
      for (int64_t j = 0; j < p1; ++j)
        acc += (w->d_quad[i * p1 + j] + w->d_quad[j * p1 + i]) * tt[j];
      dtt[i] += gobj * acc;
    }
  }
  for (int64_t i = 0; i < w->p; ++i) dtheta[i] = dtt[i];
  return 0;
}

// banded Cholesky, lower band stored row-major: Mb[i*(bw+1)+d] = M[i,i-d]
// for d = 0..bw.  In place; O(n bw^2).
bool band_cholesky(std::vector<double>& Mb, int64_t n, int64_t bw) {
  const int64_t W = bw + 1;
  for (int64_t j = 0; j < n; ++j) {
    double diag = Mb[j * W];
    for (int64_t k = std::max<int64_t>(0, j - bw); k < j; ++k) {
      double l = Mb[j * W + (j - k)];
      diag -= l * l;
    }
    if (diag <= 0.0) return false;
    diag = std::sqrt(diag);
    Mb[j * W] = diag;
    int64_t iend = std::min(n - 1, j + bw);
    for (int64_t i = j + 1; i <= iend; ++i) {
      double v = Mb[i * W + (i - j)];
      for (int64_t k = std::max<int64_t>(0, i - bw); k < j; ++k)
        v -= Mb[i * W + (i - k)] * Mb[j * W + (j - k)];
      Mb[i * W + (i - j)] = v / diag;
    }
  }
  return true;
}

void band_solve(const std::vector<double>& Mb, int64_t n, int64_t bw,
                double* x) {
  const int64_t W = bw + 1;
  for (int64_t i = 0; i < n; ++i) {
    double v = x[i];
    for (int64_t k = std::max<int64_t>(0, i - bw); k < i; ++k)
      v -= Mb[i * W + (i - k)] * x[k];
    x[i] = v / Mb[i * W];
  }
  for (int64_t i = n - 1; i >= 0; --i) {
    double v = x[i];
    int64_t kend = std::min(n - 1, i + bw);
    for (int64_t k = i + 1; k <= kend; ++k)
      v -= Mb[k * W + (k - i)] * x[k];
    x[i] = v / Mb[i * W];
  }
}

// Sparse/banded box-QP solve (long-horizon families: charging T=1440).
// P/A are COO with canonicalized values; M = P + sigma I + A' rho A is
// assembled directly into the BANDED storage under the codegen-time RCM
// permutation and factored in O(n bw^2) -- the role of the reference's
// sparse QDLDL workspace (utils.py:87-181) with a banded layout instead
// of general sparse (the TPU banded engine showed these families have
// tiny RCM bandwidth; charging T=1440 measures bw = 4).
void solve_sparse(Workspace* w) {
  const int64_t n = w->n, m = w->m;
  const int64_t nnzP = (int64_t)w->Pval.size();
  const int64_t nnzA = (int64_t)w->Aval.size();
  if (w->conic) { w->status = -5; return; }  // box-QP only

  // CSR structure for A (counting sort by row; indices are fixed)
  std::vector<int64_t> arp(m + 1, 0), acol(nnzA);
  std::vector<double> aval(nnzA);
  {
    for (int64_t e = 0; e < nnzA; ++e) arp[w->A_ii[e] + 1]++;
    for (int64_t k = 0; k < m; ++k) arp[k + 1] += arp[k];
    std::vector<int64_t> cur(arp.begin(), arp.end() - 1);
    for (int64_t e = 0; e < nnzA; ++e) {
      int64_t p2 = cur[w->A_ii[e]]++;
      acol[p2] = w->A_jj[e];
      aval[p2] = w->Aval[e];
    }
  }
  std::vector<double> pv(w->Pval), qs(w->q), ls(m), us(m);
  std::vector<double> D(n, 1.0), E(m, 1.0);
  double c = 1.0;
  // ---- Ruiz equilibration on the sparse data (OSQP alg. 2) ----
  std::vector<double> colm(n), rowm(m);
  for (int32_t it = 0; it < w->scaling; ++it) {
    std::fill(colm.begin(), colm.end(), 0.0);
    for (int64_t e = 0; e < nnzP; ++e)
      colm[w->P_jj[e]] = std::max(colm[w->P_jj[e]], std::fabs(pv[e]));
    for (int64_t e = 0; e < nnzA; ++e)
      colm[acol[e]] = std::max(colm[acol[e]], std::fabs(aval[e]));
    std::vector<double> dx(n);
    for (int64_t j = 0; j < n; ++j) {
      double v = colm[j] > 1e-12 ? 1.0 / std::sqrt(colm[j]) : 1.0;
      dx[j] = std::min(std::max(v, 1e-4), 1e4);
    }
    for (int64_t e = 0; e < nnzP; ++e)
      pv[e] *= dx[w->P_ii[e]] * dx[w->P_jj[e]];
    for (int64_t e = 0; e < nnzA; ++e) aval[e] *= dx[acol[e]];
    for (int64_t j = 0; j < n; ++j) { qs[j] *= dx[j]; D[j] *= dx[j]; }
    std::fill(rowm.begin(), rowm.end(), 0.0);
    for (int64_t k = 0; k < m; ++k)
      for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
        rowm[k] = std::max(rowm[k], std::fabs(aval[a]));
    for (int64_t k = 0; k < m; ++k) {
      double v = rowm[k] > 1e-12 ? 1.0 / std::sqrt(rowm[k]) : 1.0;
      v = std::min(std::max(v, 1e-4), 1e4);
      for (int64_t a = arp[k]; a < arp[k + 1]; ++a) aval[a] *= v;
      E[k] *= v;
    }
    std::fill(colm.begin(), colm.end(), 0.0);
    for (int64_t e = 0; e < nnzP; ++e)
      colm[w->P_jj[e]] = std::max(colm[w->P_jj[e]], std::fabs(pv[e]));
    double col = 0.0;
    for (int64_t j = 0; j < n; ++j) col += colm[j];
    col /= std::max<int64_t>(n, 1);
    if (col < 1e-12) col = 1.0;
    double qn = inf_norm(qs.data(), n);
    if (qn < 1e-12) qn = 1.0;
    double g = 1.0 / std::max(col, qn);
    g = std::min(std::max(g, 1e-4), 1e4);
    for (auto& v : pv) v *= g;
    for (auto& v : qs) v *= g;
    c *= g;
  }
  for (int64_t k = 0; k < m; ++k) {
    ls[k] = std::max(-kInf, E[k] * w->l[k]);
    us[k] = std::min(kInf, E[k] * w->u[k]);
  }
  std::vector<double> rho(m);
  for (int64_t k = 0; k < m; ++k)
    rho[k] = (k < w->n_eq) ? w->rho * w->rho_eq_scale : w->rho;

  // ---- permuted banded M assembly ----
  std::vector<int64_t> pos(n);
  if ((int64_t)w->perm.size() == n) {
    for (int64_t k = 0; k < n; ++k) pos[w->perm[k]] = k;  // invert
  } else {
    for (int64_t k = 0; k < n; ++k) pos[k] = k;
  }
  int64_t bw = w->band_bw;
  if (bw < 0) {  // auto-detect from the pattern
    bw = 0;
    for (int64_t e = 0; e < nnzP; ++e)
      { int64_t d2 = pos[w->P_ii[e]] - pos[w->P_jj[e]];
        bw = std::max(bw, d2 < 0 ? -d2 : d2); }
    for (int64_t k = 0; k < m; ++k)
      for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
        for (int64_t b = arp[k]; b < arp[k + 1]; ++b)
          { int64_t d2 = pos[acol[a]] - pos[acol[b]];
            bw = std::max(bw, d2 < 0 ? -d2 : d2); }
  }
  const int64_t W = bw + 1;
  std::vector<double> Mb(n * W, 0.0);
  auto add_sym = [&](int64_t i, int64_t j, double v) {
    int64_t pi = pos[i], pj = pos[j];
    if (pi == pj) { Mb[pi * W] += v; return; }
    int64_t hi = pi > pj ? pi : pj, lo = pi > pj ? pj : pi;
    Mb[hi * W + (hi - lo)] += 0.5 * v;  // each unordered pair arrives
                                        // twice (symmetric COO / ordered
                                        // A-row pairs)
  };
  for (int64_t i = 0; i < n; ++i) Mb[pos[i] * W] += w->sigma;
  for (int64_t e = 0; e < nnzP; ++e)
    add_sym(w->P_ii[e], w->P_jj[e], pv[e]);
  for (int64_t k = 0; k < m; ++k)
    for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
      for (int64_t b = arp[k]; b < arp[k + 1]; ++b)
        add_sym(acol[a], acol[b], rho[k] * aval[a] * aval[b]);
  if (!band_cholesky(Mb, n, bw)) { w->status = -1; return; }

  // ---- iterate (box rows only) ----
  std::vector<double> x(n, 0.0), z(m, 0.0), y(m, 0.0);
  if (w->warm_start && (int64_t)w->x.size() == n) {
    for (int64_t i = 0; i < n; ++i) x[i] = w->x[i] / D[i];
    for (int64_t k = 0; k < m; ++k) {
      double acc = 0.0;
      for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
        acc += aval[a] * x[acol[a]];
      z[k] = acc;
      y[k] = c * w->y[k] / E[k];
    }
  }
  std::vector<double> rhs(n), tb(n), xt(n), zt(m);
  std::vector<double> x_prev(x), y_prev(y);   // previous-check state for
                                              // the infeasibility deltas
  int32_t it = 0;
  bool solved = false;
  int32_t cert = 0;
  for (it = 0; it < w->max_iter; ++it) {
    for (int64_t j = 0; j < n; ++j) rhs[j] = w->sigma * x[j] - qs[j];
    for (int64_t k = 0; k < m; ++k) {
      double s = rho[k] * z[k] - y[k];
      if (s == 0.0) continue;
      for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
        rhs[acol[a]] += aval[a] * s;
    }
    for (int64_t j = 0; j < n; ++j) tb[pos[j]] = rhs[j];
    band_solve(Mb, n, bw, tb.data());
    for (int64_t j = 0; j < n; ++j) xt[j] = tb[pos[j]];
    for (int64_t k = 0; k < m; ++k) {
      double acc = 0.0;
      for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
        acc += aval[a] * xt[acol[a]];
      zt[k] = acc;
    }
    for (int64_t j = 0; j < n; ++j)
      x[j] = w->alpha * xt[j] + (1.0 - w->alpha) * x[j];
    for (int64_t k = 0; k < m; ++k) {
      double wk = w->alpha * zt[k] + (1.0 - w->alpha) * z[k] + y[k] / rho[k];
      double zk = std::min(std::max(wk, ls[k]), us[k]);
      y[k] = rho[k] * (wk - zk);
      z[k] = zk;
    }
    if ((it + 1) % w->check_interval == 0) {
      double rp = 0.0, rp_den = 0.0, rd = 0.0, rd_den = 0.0;
      for (int64_t k = 0; k < m; ++k) {
        double ax = 0.0;
        for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
          ax += aval[a] * x[acol[a]];
        rp = std::max(rp, std::fabs((ax - z[k]) / E[k]));
        rp_den = std::max(rp_den, std::max(std::fabs(ax / E[k]),
                                           std::fabs(z[k] / E[k])));
      }
      std::vector<double> px(n, 0.0), aty(n, 0.0);
      for (int64_t e = 0; e < nnzP; ++e)
        px[w->P_ii[e]] += pv[e] * x[w->P_jj[e]];
      for (int64_t k = 0; k < m; ++k)
        for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
          aty[acol[a]] += aval[a] * y[k];
      for (int64_t j = 0; j < n; ++j) {
        rd = std::max(rd, std::fabs((px[j] + qs[j] + aty[j]) / D[j]) / c);
        rd_den = std::max(
            rd_den, std::max({std::fabs(px[j] / D[j]),
                              std::fabs(aty[j] / D[j]),
                              std::fabs(qs[j] / D[j])}) / c);
      }
      w->pri_res = rp;
      w->dua_res = rd;
      if (rp <= w->eps_abs + w->eps_rel * rp_den &&
          rd <= w->eps_abs + w->eps_rel * rd_den) {
        solved = true;
        ++it;
        break;
      }
      // OSQP section 3.4 infeasibility certificates on the check-to-
      // check deltas (mirrors the full kernel / solvers/admm.py)
      {
        const double eps_inf = 1e-4, tol0 = 1e-12;
        double dy_n = 0.0, dx_n = 0.0;
        for (int64_t k = 0; k < m; ++k)
          dy_n = std::max(dy_n,
                          std::fabs(E[k] * (y[k] - y_prev[k])) / c);
        for (int64_t j = 0; j < n; ++j)
          dx_n = std::max(dx_n, std::fabs(D[j] * (x[j] - x_prev[j])));
        if (dy_n > 1e-10) {
          std::vector<double> atdy(n, 0.0);
          double sup = 0.0;
          bool open_dir = false;
          for (int64_t k = 0; k < m; ++k) {
            double dyk = y[k] - y_prev[k];
            for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
              atdy[acol[a]] += aval[a] * dyk;
            double edy = E[k] * dyk;
            bool u_open = w->u[k] >= kInf * 0.5;
            bool l_open = w->l[k] <= -kInf * 0.5;
            sup += ((u_open ? 0.0 : w->u[k]) * std::max(edy, 0.0)
                    + (l_open ? 0.0 : w->l[k]) * std::min(edy, 0.0)) / c;
            if ((dyk > tol0 && u_open) || (dyk < -tol0 && l_open))
              open_dir = true;
          }
          double c1 = 0.0;
          for (int64_t j = 0; j < n; ++j)
            c1 = std::max(c1, std::fabs(atdy[j] / D[j]) / c);
          if (c1 <= eps_inf * dy_n && sup <= -eps_inf * dy_n &&
              !open_dir) {
            cert = -3;
            ++it;
            break;
          }
        }
        if (dx_n > 1e-10) {
          std::vector<double> pdx(n, 0.0);
          double qdx = 0.0;
          for (int64_t e = 0; e < nnzP; ++e)
            pdx[w->P_ii[e]] += pv[e] * (x[w->P_jj[e]] - x_prev[w->P_jj[e]]);
          double c1 = 0.0;
          for (int64_t j = 0; j < n; ++j) {
            c1 = std::max(c1, std::fabs(pdx[j] / D[j]) / c);
            qdx += qs[j] * (x[j] - x_prev[j]);
          }
          bool rows_ok = true;
          for (int64_t k = 0; k < m && rows_ok; ++k) {
            double adx = 0.0;
            for (int64_t a = arp[k]; a < arp[k + 1]; ++a)
              adx += aval[a] * (x[acol[a]] - x_prev[acol[a]]);
            adx /= E[k];
            if (!(w->u[k] >= kInf * 0.5 || adx <= eps_inf * dx_n))
              rows_ok = false;
            if (!(w->l[k] <= -kInf * 0.5 || adx >= -eps_inf * dx_n))
              rows_ok = false;
          }
          if (c1 <= eps_inf * dx_n && qdx / c <= -eps_inf * dx_n &&
              rows_ok) {
            cert = -4;
            ++it;
            break;
          }
        }
        x_prev = x;
        y_prev = y;
      }
    }
  }
  // unscale + objective
  w->x.assign(n, 0.0);
  w->z.assign(m, 0.0);
  w->y.assign(m, 0.0);
  std::vector<double> px(n, 0.0);
  for (int64_t e = 0; e < nnzP; ++e)
    px[w->P_ii[e]] += pv[e] * x[w->P_jj[e]];
  double obj_s = 0.0;
  for (int64_t i = 0; i < n; ++i) obj_s += 0.5 * x[i] * px[i] + qs[i] * x[i];
  w->obj = obj_s / c;
  for (int64_t i = 0; i < n; ++i) w->x[i] = D[i] * x[i];
  for (int64_t k = 0; k < m; ++k) {
    w->z[k] = z[k] / E[k];
    w->y[k] = E[k] * y[k] / c;
  }
  w->iters = it;
  w->status = solved ? 1 : cert;
  if (cert == -3) w->obj = kInf;
  if (cert == -4) w->obj = -kInf;
}

void canonicalize(Workspace* w) {
  const double* tt = w->theta_t.data();
  if (w->sparse_mode) {
    w->mapP.apply(tt, w->Pval.data());
  } else {
    if ((int64_t)w->P.size() != w->n * w->n) w->P.assign(w->n * w->n, 0.0);
    w->mapP.apply(tt, w->P.data());
  }
  w->mapq.apply(tt, w->q.data());
  double dd = 0.0;
  w->mapd.apply(tt, &dd);
  if (!w->d_quad.empty()) {
    int64_t p1 = w->p + 1;
    for (int64_t i = 0; i < p1; ++i) {
      double row = 0.0;
      for (int64_t j = 0; j < p1; ++j) row += w->d_quad[i * p1 + j] * tt[j];
      dd += tt[i] * row;
    }
  }
  w->d_off = dd;
  if (w->sparse_mode) {
    w->mapA.apply(tt, w->Aval.data());
  } else {
    if ((int64_t)w->A.size() != w->m * w->n) w->A.assign(w->m * w->n, 0.0);
    w->mapA.apply(tt, w->A.data());
  }
  w->mapb.apply(tt, w->b.data());
  for (int64_t r = 0; r < w->m; ++r) {
    w->l[r] = -w->b[r];
    w->u[r] = (r < w->n_eq) ? -w->b[r] : kInf;
  }
}

void solve(Workspace* w) {
  const int64_t n = w->n, m = w->m;
  // ---- Ruiz equilibration (OSQP alg. 2) ----
  std::vector<double> Ps(w->P), qs(w->q), As(w->A), ls(w->l), us(w->u);
  std::vector<double> D(n, 1.0), E(m, 1.0);
  double c = 1.0;
  for (int32_t it = 0; it < w->scaling; ++it) {
    for (int64_t j = 0; j < n; ++j) {
      double nx = 0.0;
      for (int64_t i = 0; i < n; ++i) nx = std::max(nx, std::fabs(Ps[i * n + j]));
      for (int64_t k = 0; k < m; ++k) nx = std::max(nx, std::fabs(As[k * n + j]));
      double dx = nx > 1e-12 ? 1.0 / std::sqrt(nx) : 1.0;
      dx = std::min(std::max(dx, 1e-4), 1e4);
      for (int64_t i = 0; i < n; ++i) { Ps[i * n + j] *= dx; Ps[j * n + i] *= dx; }
      for (int64_t k = 0; k < m; ++k) As[k * n + j] *= dx;
      qs[j] *= dx;
      D[j] *= dx;
    }
    std::vector<double> dcv(m);
    for (int64_t k = 0; k < m; ++k) {
      double nc = 0.0;
      for (int64_t j = 0; j < n; ++j) nc = std::max(nc, std::fabs(As[k * n + j]));
      double dc = nc > 1e-12 ? 1.0 / std::sqrt(nc) : 1.0;
      dcv[k] = std::min(std::max(dc, 1e-4), 1e4);
    }
    if (w->conic) {
      // block-uniform row scale within each SOC block (cone invariance):
      // geometric mean, mirroring solvers/conic_admm.py Ruiz
      int64_t off = w->n_eq + w->n_nonneg;
      std::vector<int64_t> blocks(w->socs);
      for (int64_t e = 0; e < w->n_exp; ++e) blocks.push_back(3);
      for (size_t pi = 0; pi < w->pow_alphas.size(); ++pi)
        blocks.push_back(3);
      for (int64_t d : blocks) {
        double lg = 0.0;
        for (int64_t i = 0; i < d; ++i) lg += std::log(dcv[off + i]);
        double g = std::exp(lg / (double)d);
        for (int64_t i = 0; i < d; ++i) dcv[off + i] = g;
        off += d;
      }
    }
    for (int64_t k = 0; k < m; ++k) {
      for (int64_t j = 0; j < n; ++j) As[k * n + j] *= dcv[k];
      E[k] *= dcv[k];
    }
    double col = 0.0;
    for (int64_t j = 0; j < n; ++j) {
      double cn = 0.0;
      for (int64_t i = 0; i < n; ++i) cn = std::max(cn, std::fabs(Ps[i * n + j]));
      col += cn;
    }
    col /= std::max<int64_t>(n, 1);
    if (col < 1e-12) col = 1.0;
    double qn = inf_norm(qs.data(), n);
    if (qn < 1e-12) qn = 1.0;
    double g = 1.0 / std::max(col, qn);
    g = std::min(std::max(g, 1e-4), 1e4);
    for (auto& v : Ps) v *= g;
    for (auto& v : qs) v *= g;
    c *= g;
  }
  for (int64_t k = 0; k < m; ++k) {
    ls[k] = std::max(-kInf, E[k] * w->l[k]);
    us[k] = std::min(kInf, E[k] * w->u[k]);
  }

  std::vector<double> rho(m);
  for (int64_t k = 0; k < m; ++k)
    rho[k] = (k < w->n_eq) ? w->rho * w->rho_eq_scale : w->rho;

  // ---- factor M = P + sigma I + A' diag(rho) A ----
  std::vector<double> M(n * n, 0.0);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < n; ++j) M[i * n + j] = Ps[i * n + j];
  for (int64_t i = 0; i < n; ++i) M[i * n + i] += w->sigma;
  for (int64_t k = 0; k < m; ++k)
    for (int64_t i = 0; i < n; ++i) {
      double aki = As[k * n + i] * rho[k];
      if (aki == 0.0) continue;
      for (int64_t j = 0; j < n; ++j) M[i * n + j] += aki * As[k * n + j];
    }
  if (!cholesky(M, n)) { w->status = -1; return; }

  // ---- iterate ----
  std::vector<double> x(n, 0.0), z(m, 0.0), y(m, 0.0);
  if (w->warm_start && (int64_t)w->x.size() == n) {
    for (int64_t i = 0; i < n; ++i) x[i] = w->x[i] / D[i];
    for (int64_t k = 0; k < m; ++k) {
      double acc = 0.0;
      for (int64_t j = 0; j < n; ++j) acc += As[k * n + j] * x[j];
      z[k] = acc;
      y[k] = c * w->y[k] / E[k];
    }
  }
  std::vector<double> rhs(n), xt(n), zt(m), wv(m);
  std::vector<double> x_prev(x), y_prev(y);   // previous-check state for
                                              // the infeasibility deltas
  int32_t it = 0;
  bool solved = false;
  int32_t cert = 0;
  for (it = 0; it < w->max_iter; ++it) {
    for (int64_t j = 0; j < n; ++j) rhs[j] = w->sigma * x[j] - qs[j];
    for (int64_t k = 0; k < m; ++k) {
      double s = rho[k] * z[k] - y[k];
      if (s == 0.0) continue;
      for (int64_t j = 0; j < n; ++j) rhs[j] += As[k * n + j] * s;
    }
    std::memcpy(xt.data(), rhs.data(), n * sizeof(double));
    chol_solve(M, n, xt.data());
    for (int64_t k = 0; k < m; ++k) {
      double acc = 0.0;
      for (int64_t j = 0; j < n; ++j) acc += As[k * n + j] * xt[j];
      zt[k] = acc;
    }
    for (int64_t j = 0; j < n; ++j)
      x[j] = w->alpha * xt[j] + (1.0 - w->alpha) * x[j];
    // box rows: zero rows (l = u) and nonneg rows (u = +inf); with a
    // conic layout the SOC blocks follow with a real cone projection
    const int64_t box_rows = w->conic ? (w->n_eq + w->n_nonneg) : m;
    for (int64_t k = 0; k < box_rows; ++k) {
      double wk = w->alpha * zt[k] + (1.0 - w->alpha) * z[k] + y[k] / rho[k];
      double zk = std::min(std::max(wk, ls[k]), us[k]);
      y[k] = rho[k] * (wk - zk);
      z[k] = zk;
    }
    if (w->conic) {
      // z_blk = proj_SOC(w_blk + bs_blk) - bs_blk  (scaled b: bs = E b)
      int64_t off = box_rows;
      for (int64_t d : w->socs) {
        double t = 0.0, nr = 0.0;
        for (int64_t i = 0; i < d; ++i) {
          int64_t k = off + i;
          wv[k] = w->alpha * zt[k] + (1.0 - w->alpha) * z[k] + y[k] / rho[k];
          double v = wv[k] + E[k] * w->b[k];
          if (i == 0) t = v; else nr += v * v;
        }
        nr = std::sqrt(nr);
        double scale0, scale1;
        if (nr <= t) { scale0 = 0.0; scale1 = 1.0; }       // inside: keep v
        else if (nr <= -t) { scale0 = 0.0; scale1 = 0.0; } // polar: 0
        else { scale0 = (t + nr) / 2.0; scale1 = scale0 / nr; }
        for (int64_t i = 0; i < d; ++i) {
          int64_t k = off + i;
          double v = wv[k] + E[k] * w->b[k];
          double pv = (nr <= t) ? v : (i == 0 ? scale0 : scale1 * v);
          double zk = pv - E[k] * w->b[k];
          y[k] = rho[k] * (wv[k] - zk);
          z[k] = zk;
        }
        off += d;
      }
      // exp triples then pow triples: z_blk = proj(w_blk + bs) - bs
      int64_t n_extra = w->n_exp + (int64_t)w->pow_alphas.size();
      for (int64_t blk = 0; blk < n_extra; ++blk) {
        double vv[3];
        for (int64_t i = 0; i < 3; ++i) {
          int64_t k = off + i;
          wv[k] = w->alpha * zt[k] + (1.0 - w->alpha) * z[k] + y[k] / rho[k];
          vv[i] = wv[k] + E[k] * w->b[k];
        }
        if (blk < w->n_exp) proj_exp3(vv);
        else proj_pow3(vv, w->pow_alphas[blk - w->n_exp]);
        for (int64_t i = 0; i < 3; ++i) {
          int64_t k = off + i;
          double zk = vv[i] - E[k] * w->b[k];
          y[k] = rho[k] * (wv[k] - zk);
          z[k] = zk;
        }
        off += 3;
      }
    }
    if ((it + 1) % w->check_interval == 0) {
      double rp = 0.0, rp_den = 0.0, rd = 0.0, rd_den = 0.0;
      for (int64_t k = 0; k < m; ++k) {
        double ax = 0.0;
        for (int64_t j = 0; j < n; ++j) ax += As[k * n + j] * x[j];
        rp = std::max(rp, std::fabs((ax - z[k]) / E[k]));
        rp_den = std::max(rp_den, std::max(std::fabs(ax / E[k]),
                                           std::fabs(z[k] / E[k])));
      }
      for (int64_t j = 0; j < n; ++j) {
        double px = 0.0, aty = 0.0;
        for (int64_t i = 0; i < n; ++i) px += Ps[j * n + i] * x[i];
        for (int64_t k = 0; k < m; ++k) aty += As[k * n + j] * y[k];
        rd = std::max(rd, std::fabs((px + qs[j] + aty) / D[j]) / c);
        rd_den = std::max(rd_den,
                          std::max({std::fabs(px / D[j]), std::fabs(aty / D[j]),
                                    std::fabs(qs[j] / D[j])}) / c);
      }
      w->pri_res = rp;
      w->dua_res = rd;
      if (rp <= w->eps_abs + w->eps_rel * rp_den &&
          rd <= w->eps_abs + w->eps_rel * rd_den) {
        solved = true;
        ++it;
        break;
      }
      // OSQP section 3.4 infeasibility certificates on the check-to-
      // check deltas (box-QP families; the conic layout uses the JAX
      // conic engine's certificates)
      if (!w->conic) {
        const double eps_inf = 1e-4, tol0 = 1e-12;
        double dy_n = 0.0, dx_n = 0.0;
        for (int64_t k = 0; k < m; ++k)
          dy_n = std::max(dy_n,
                          std::fabs(E[k] * (y[k] - y_prev[k])) / c);
        for (int64_t j = 0; j < n; ++j)
          dx_n = std::max(dx_n, std::fabs(D[j] * (x[j] - x_prev[j])));
        if (dy_n > 1e-10) {
          double sup = 0.0, c1 = 0.0;
          bool open_dir = false;
          for (int64_t j = 0; j < n; ++j) {
            double atdy = 0.0;
            for (int64_t k = 0; k < m; ++k)
              atdy += As[k * n + j] * (y[k] - y_prev[k]);
            c1 = std::max(c1, std::fabs(atdy / D[j]) / c);
          }
          for (int64_t k = 0; k < m; ++k) {
            double dyk = y[k] - y_prev[k];
            double edy = E[k] * dyk;
            bool u_open = w->u[k] >= kInf * 0.5;
            bool l_open = w->l[k] <= -kInf * 0.5;
            sup += ((u_open ? 0.0 : w->u[k]) * std::max(edy, 0.0)
                    + (l_open ? 0.0 : w->l[k]) * std::min(edy, 0.0)) / c;
            if ((dyk > tol0 && u_open) || (dyk < -tol0 && l_open))
              open_dir = true;
          }
          if (c1 <= eps_inf * dy_n && sup <= -eps_inf * dy_n &&
              !open_dir) {
            cert = -3;
            ++it;
            break;
          }
        }
        if (dx_n > 1e-10) {
          double c1 = 0.0, qdx = 0.0;
          for (int64_t j = 0; j < n; ++j) {
            double pdx = 0.0;
            for (int64_t i2 = 0; i2 < n; ++i2)
              pdx += Ps[j * n + i2] * (x[i2] - x_prev[i2]);
            c1 = std::max(c1, std::fabs(pdx / D[j]) / c);
            qdx += qs[j] * (x[j] - x_prev[j]);
          }
          bool rows_ok = true;
          for (int64_t k = 0; k < m && rows_ok; ++k) {
            double adx = 0.0;
            for (int64_t j = 0; j < n; ++j)
              adx += As[k * n + j] * (x[j] - x_prev[j]);
            adx /= E[k];
            if (!(w->u[k] >= kInf * 0.5 || adx <= eps_inf * dx_n))
              rows_ok = false;
            if (!(w->l[k] <= -kInf * 0.5 || adx >= -eps_inf * dx_n))
              rows_ok = false;
          }
          if (c1 <= eps_inf * dx_n && qdx / c <= -eps_inf * dx_n &&
              rows_ok) {
            cert = -4;
            ++it;
            break;
          }
        }
        x_prev = x;
        y_prev = y;
      }
    }
  }
  // unscale + objective
  w->x.assign(n, 0.0);
  w->z.assign(m, 0.0);
  w->y.assign(m, 0.0);
  double obj_s = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double px = 0.0;
    for (int64_t j = 0; j < n; ++j) px += Ps[i * n + j] * x[j];
    obj_s += 0.5 * x[i] * px + qs[i] * x[i];
  }
  w->obj = obj_s / c;
  for (int64_t i = 0; i < n; ++i) w->x[i] = D[i] * x[i];
  for (int64_t k = 0; k < m; ++k) {
    w->z[k] = z[k] / E[k];
    w->y[k] = E[k] * y[k] / c;
  }
  w->iters = it;
  w->status = solved ? 1 : cert;
  if (cert == -3) w->obj = kInf;
  if (cert == -4) w->obj = -kInf;
}

}  // namespace

extern "C" {

void* cpg_native_init(int64_t n, int64_t m, int64_t p, int64_t n_eq) {
  auto* w = new Workspace();
  w->n = n; w->m = m; w->p = p; w->n_eq = n_eq;
  w->theta_t.assign(p + 1, 0.0);
  w->theta_t[p] = 1.0;
  // dense P/A allocated lazily in canonicalize (sparse-mode families
  // never materialize them)
  w->q.assign(n, 0.0);
  w->b.assign(m, 0.0);
  w->l.assign(m, 0.0);
  w->u.assign(m, 0.0);
  return w;
}

void cpg_native_set_map(void* h, int32_t which, int64_t n_rows,
                        const int64_t* indptr, const int64_t* indices,
                        const double* data) {
  auto* w = static_cast<Workspace*>(h);
  CsrMap* mp = nullptr;
  switch (which) {
    case 0: mp = &w->mapP; break;
    case 1: mp = &w->mapq; break;
    case 2: mp = &w->mapd; break;
    case 3: mp = &w->mapA; break;
    case 4: mp = &w->mapb; break;
  }
  if (mp) load_csr(mp, n_rows, indptr, indices, data);
}

void cpg_native_set_cones(void* h, int64_t n_nonneg, int64_t n_soc,
                          const int64_t* soc_dims) {
  auto* w = static_cast<Workspace*>(h);
  w->n_nonneg = n_nonneg;
  w->socs.assign(soc_dims, soc_dims + n_soc);
  w->conic = true;
}

void cpg_native_set_cones_ext(void* h, int64_t n_exp, int64_t n_pow,
                              const double* pow_alphas) {
  auto* w = static_cast<Workspace*>(h);
  w->n_exp = n_exp;
  w->pow_alphas.assign(pow_alphas, pow_alphas + n_pow);
  w->conic = true;
}

void cpg_native_set_dquad(void* h, const double* dq) {
  auto* w = static_cast<Workspace*>(h);
  int64_t p1 = w->p + 1;
  w->d_quad.assign(dq, dq + p1 * p1);
}

void cpg_native_set_theta(void* h, const double* theta) {
  auto* w = static_cast<Workspace*>(h);
  std::memcpy(w->theta_t.data(), theta, w->p * sizeof(double));
}

void cpg_native_update_theta(void* h, int64_t idx, double val) {
  static_cast<Workspace*>(h)->theta_t[idx] = val;
}

void cpg_native_set_setting(void* h, int32_t which, double val) {
  auto* w = static_cast<Workspace*>(h);
  switch (which) {
    case 0: w->rho = val; break;
    case 1: w->sigma = val; break;
    case 2: w->alpha = val; break;
    case 3: w->eps_abs = val; break;
    case 4: w->eps_rel = val; break;
    case 5: w->max_iter = (int32_t)val; break;
    case 6: w->warm_start = val != 0.0; break;
    case 7: w->rho_eq_scale = val; break;
  }
}

void cpg_native_solve(void* h) {
  auto* w = static_cast<Workspace*>(h);
  canonicalize(w);
  if (w->sparse_mode) solve_sparse(w);
  else solve(w);
}

// Switch P (which = 0) or A (which = 3) to sparse COO storage with the
// given FIXED indices; the matching map must then have nnz rows (the raw
// codegen map, no dense expansion).  Enables the banded solve path.
void cpg_native_set_scatter(void* h, int32_t which, int64_t nnz,
                            const int64_t* ii, const int64_t* jj) {
  auto* w = static_cast<Workspace*>(h);
  if (which == 0) {
    w->P_ii.assign(ii, ii + nnz);
    w->P_jj.assign(jj, jj + nnz);
    w->Pval.assign(nnz, 0.0);
    w->P.clear();
    w->P.shrink_to_fit();
  } else if (which == 3) {
    w->A_ii.assign(ii, ii + nnz);
    w->A_jj.assign(jj, jj + nnz);
    w->Aval.assign(nnz, 0.0);
    w->A.clear();
    w->A.shrink_to_fit();
  }
  w->sparse_mode = true;
}

// Codegen-time fill-reducing permutation (RCM): perm[k] = original index
// of the k-th permuted variable (scipy convention); bw = lower bandwidth
// of the permuted M pattern, or -1 to auto-detect at solve time.
void cpg_native_set_perm(void* h, const int64_t* perm, int64_t bw) {
  auto* w = static_cast<Workspace*>(h);
  w->perm.assign(perm, perm + w->n);
  w->band_bw = bw;
}

double cpg_native_obj(void* h) {
  auto* w = static_cast<Workspace*>(h);
  return w->obj + w->d_off;
}

int32_t cpg_native_status(void* h) { return static_cast<Workspace*>(h)->status; }
int32_t cpg_native_iters(void* h) { return static_cast<Workspace*>(h)->iters; }
double cpg_native_pri_res(void* h) { return static_cast<Workspace*>(h)->pri_res; }
double cpg_native_dua_res(void* h) { return static_cast<Workspace*>(h)->dua_res; }

void cpg_native_get_x(void* h, double* out) {
  auto* w = static_cast<Workspace*>(h);
  std::memcpy(out, w->x.data(), w->n * sizeof(double));
}

void cpg_native_get_y(void* h, double* out) {
  auto* w = static_cast<Workspace*>(h);
  std::memcpy(out, w->y.data(), w->m * sizeof(double));
}

// VJP from a solution-space seed to USER-PARAMETER space: gx (len n,
// nullable) is dL/dx, gy (len m, nullable) is dL/dy on ACTIVE rows,
// gobj folds a dL/dobjective seed.  Writes dL/dtheta (len p).  Returns
// 0 ok; -1 conic family (unsupported, reference gradient is OSQP-only);
// -2 no prior solve; -3 singular reduced KKT.
int32_t cpg_native_gradient(void* h, const double* gx, const double* gy,
                            double gobj, double* dtheta) {
  return gradient(static_cast<Workspace*>(h), gx, gy, gobj, dtheta);
}

void cpg_native_free(void* h) { delete static_cast<Workspace*>(h); }

}  // extern "C"
