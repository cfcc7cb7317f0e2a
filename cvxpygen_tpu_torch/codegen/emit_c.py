"""Standalone C artifact emission (reference cpg_example.c role).

The reference's generated directory contains a self-contained C project
buildable without Python (reference templates/cpg_example.c.jinja2:16-88 +
CMakeLists.txt.jinja2).  Parity here: ``write_c_artifact`` emits under
``<code_dir>/c/``

- ``cpg_core.cpp``  the dependency-free C++ solver core (copied from
  cvxpygen_tpu_torch/native/cpg_core.cpp -- same code the ctypes runtime
  uses, and the JAX package's core, one header comment line apart);
- ``cpg_core.h``    extern "C" prototypes;
- ``cpg_data.c``    this family's canonicalization maps as CSR arrays +
  ``cpg_setup()`` wiring them into a workspace (the reference's
  cpg_workspace.c role, utils.py:470-882);
- ``cpg_example.c`` a main(): set parameters, solve, print (reference
  cpg_example.c.jinja2);
- ``Makefile``      `make` builds ./cpg_example with only a C++ compiler.

QP-form families only (the embedded core is the ADMM QP solver); conic
families are skipped with a README note, mirroring how the reference's
embedded story is per-solver.
"""
from __future__ import annotations

import os
import shutil

import numpy as np


def _fmt_dbl(arr):
    return ',\n  '.join(', '.join(f'{v:.17g}' for v in arr[i:i + 4])
                        for i in range(0, len(arr), 4)) or '0'


def _fmt_i64(arr):
    return ',\n  '.join(', '.join(str(int(v)) for v in arr[i:i + 10])
                        for i in range(0, len(arr), 10)) or '0'


def _csr_decl(name, M):
    M = M.tocsr()
    return (
        f'static const int64_t {name}_indptr[] = {{\n'
        f'  {_fmt_i64(M.indptr)}\n}};\n'
        f'static const int64_t {name}_indices[] = {{\n'
        f'  {_fmt_i64(M.indices)}\n}};\n'
        f'static const double {name}_data[] = {{\n'
        f'  {_fmt_dbl(M.data)}\n}};\n'
        f'static const int64_t {name}_rows = {M.shape[0]};\n')


_HEADER = '''#ifndef CPG_CORE_H
#define CPG_CORE_H
#include <stdint.h>
#ifdef __cplusplus
extern "C" {
#endif
void* cpg_native_init(int64_t n, int64_t m, int64_t p, int64_t n_eq);
void cpg_native_set_cones(void* h, int64_t n_nonneg, int64_t n_soc,
                          const int64_t* soc_dims);
void cpg_native_set_cones_ext(void* h, int64_t n_exp, int64_t n_pow,
                              const double* pow_alphas);
void cpg_native_set_map(void* h, int32_t which, int64_t n_rows,
                        const int64_t* indptr, const int64_t* indices,
                        const double* data);
/* sparse/banded mode (long-horizon families): P/A as COO with fixed
 * indices; the matching map then has nnz rows (no dense expansion) */
void cpg_native_set_scatter(void* h, int32_t which, int64_t nnz,
                            const int64_t* ii, const int64_t* jj);
void cpg_native_set_perm(void* h, const int64_t* perm, int64_t bw);
void cpg_native_set_dquad(void* h, const double* dq);
void cpg_native_set_theta(void* h, const double* theta);
void cpg_native_update_theta(void* h, int64_t idx, double val);
void cpg_native_set_setting(void* h, int32_t which, double val);
void cpg_native_solve(void* h);
double cpg_native_obj(void* h);
int32_t cpg_native_status(void* h);
int32_t cpg_native_iters(void* h);
double cpg_native_pri_res(void* h);
double cpg_native_dua_res(void* h);
void cpg_native_get_x(void* h, double* out);
void cpg_native_get_y(void* h, double* out);
/* VJP at the last solve: seeds dL/dx (len n, nullable), dL/dy (len m,
 * nullable, active rows), dL/dobj scalar -> dL/dtheta (len p).
 * Returns 0 ok, -1 conic family (unsupported), -2 no prior solve,
 * -3 singular reduced KKT. */
int32_t cpg_native_gradient(void* h, const double* gx, const double* gy,
                            double gobj, double* dtheta);
void cpg_native_free(void* h);
/* emitted by cpg_data.c for this family */
void* cpg_setup(void);
extern const int64_t cpg_n, cpg_m, cpg_p;
extern const double cpg_theta_default[];
#ifdef __cplusplus
}
#endif
#endif
'''

_EXAMPLE = '''/* Standalone example for this generated family (reference
 * cpg_example.c.jinja2:16-88 role): update the first parameter entry
 * through its named update function, solve, print solution head +
 * stats.  Build: `make`. */
#include <stdio.h>
#include <stdlib.h>
#include "cpg_core.h"
#include "cpg_family.h"

int main(void) {
  void* h = cpg_setup();
  /* named per-parameter update (reference cpg_update_<param>,
   * utils.py:909-926) */
  cpg_native_set_theta(h, cpg_theta_default);
%UPDATE_LINE%
  cpg_native_solve(h);
  double* x = (double*)malloc(sizeof(double) * (size_t)cpg_n);
  cpg_native_get_x(h, x);
  printf("status = %d, iters = %d, obj = %.9g\\n",
         cpg_native_status(h), cpg_native_iters(h), cpg_native_obj(h));
  printf("pri_res = %.3e, dua_res = %.3e\\n",
         cpg_native_pri_res(h), cpg_native_dua_res(h));
  for (int64_t i = 0; i < (cpg_n < 8 ? cpg_n : 8); ++i)
    printf("x[%ld] = %.9g\\n", (long)i, x[i]);
%GRADIENT_BLOCK%
  free(x);
  cpg_native_free(h);
  return 0;
}
'''

_MAKEFILE = '''CXX ?= g++
CXXFLAGS ?= -O3 -std=c++17
cpg_example: cpg_core.cpp cpg_data.c cpg_example.c cpg_core.h
\t$(CXX) $(CXXFLAGS) -x c++ cpg_core.cpp cpg_data.c cpg_example.c -o $@
clean:
\trm -f cpg_example
'''


def write_c_artifact(code_dir, fam, theta_default=None):
    """Emit the standalone C project for a QP / SOC / exp / pow family
    (the conic core mirrors the reference's embedded conic C coverage:
    SCS for zero/nonneg/SOC -- reference scs.py:130-135,137-164 -- plus
    exp/pow projections, the cones the reference reaches through
    Clarabel, clarabel.py:133-155).  PSD stays out: its
    projection needs an eigendecomposition, which the dependency-free
    core deliberately excludes (the reference keeps PSD on the vendored
    Clarabel/LAPACK stack for the same reason).  Returns the c/
    directory path, or None for PSD families."""
    if getattr(fam, 'psd_dims', ()):
        return None
    # small families emit dense-expanded P/A maps (n^2 + m*n rows x p+1,
    # matvec-friendly and gradient-capable); above the threshold the
    # artifact switches to SPARSE emission -- raw COO maps + a
    # codegen-time RCM permutation driving the core's banded Cholesky
    # (reference sparse CSC workspaces at any size, utils.py:87-181,
    # 279-294).  Conic families above the
    # threshold are still skipped (the sparse core is box-QP only).
    dense_entries = (fam.n * fam.n + fam.m * fam.n) * fam.p1
    sparse_mode = dense_entries > 5e7
    n_exp = int(getattr(fam, 'n_exp', 0))
    pows = list(getattr(fam, 'pow_alphas', ()) or ())
    if sparse_mode and (fam.soc_dims or n_exp or pows):
        import warnings
        warnings.warn(
            f'no C artifact: conic family too large for dense emission '
            f'({dense_entries:.2g} dense map entries) and the sparse/'
            'banded embedded core covers box-QP families only')
        return None
    import scipy.sparse as spa

    from ..runtime.torch_family import _expand_rows

    cdir = os.path.join(code_dir, 'c')
    os.makedirs(cdir, exist_ok=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copy(os.path.join(here, 'native', 'cpg_core.cpp'),
                os.path.join(cdir, 'cpg_core.cpp'))
    with open(os.path.join(cdir, 'cpg_core.h'), 'w') as f:
        f.write(_HEADER)

    n, m = fam.n, fam.m
    if sparse_mode:
        Pfull = fam.P_map.tocsr()
        Afull = fam.A_map.tocsr()
    else:
        Pfull = spa.csr_matrix(_expand_rows(fam.P_map, fam.P_idx, n * n, n))
        Afull = spa.csr_matrix(_expand_rows(fam.A_map, fam.A_idx, m * n, n))
    theta = (np.zeros(fam.p) if theta_default is None
             else np.asarray(theta_default, dtype=float))

    parts = ['/* Family data (reference cpg_workspace.c role): theta-affine'
             ' canonicalization maps in CSR. */\n#include "cpg_core.h"\n'
             '#include "cpg_family.h"\n'   # extern "C" update prototypes
             '#include <stddef.h>\n']
    for name, M in (('P', Pfull), ('q', fam.q_map), ('d', fam.d_map),
                    ('A', Afull), ('b', fam.b_map)):
        parts.append(_csr_decl(f'cpg_map_{name}', M))
    if fam.d_quad is not None:
        dq = np.asarray(fam.d_quad.toarray(), dtype=float).ravel()
        parts.append('static const double cpg_dquad[] = {\n  '
                     + _fmt_dbl(dq) + '\n};\n')
    parts.append(
        f'const int64_t cpg_n = {n}, cpg_m = {m}, cpg_p = {fam.p};\n'
        f'const double cpg_theta_default[] = {{\n  {_fmt_dbl(theta)}\n}};\n'
        'void* cpg_setup(void) {\n'
        f'  void* h = cpg_native_init({n}, {m}, {fam.p}, {fam.n_zero});\n')
    for i, name in enumerate(('P', 'q', 'd', 'A', 'b')):
        parts.append(
            f'  cpg_native_set_map(h, {i}, cpg_map_{name}_rows, '
            f'cpg_map_{name}_indptr, cpg_map_{name}_indices, '
            f'cpg_map_{name}_data);\n')
    if sparse_mode:
        Pi, Pj = fam.P_idx
        Ai, Aj = fam.A_idx
        # codegen-time RCM analysis of the M = P + A'A pattern; the core
        # factors the banded Cholesky under this permutation
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        Pp = spa.coo_matrix((np.ones(len(Pi)), (Pi, Pj)), shape=(n, n))
        Ap = spa.coo_matrix((np.ones(len(Ai)), (Ai, Aj)), shape=(m, n))
        Mpat = (Pp + Pp.T + Ap.T @ Ap + spa.eye(n)).tocsr()
        perm = np.asarray(reverse_cuthill_mckee(Mpat, symmetric_mode=True),
                          dtype=np.int64)
        Mp = Mpat[perm][:, perm].tocoo()
        bw = int(np.max(np.abs(Mp.row - Mp.col))) if Mp.nnz else 0
        for tag, ii, jj in (('P', Pi, Pj), ('A', Ai, Aj)):
            parts.append(
                f'  static const int64_t cpg_{tag}_ii[] = {{\n  '
                + _fmt_i64(ii) + '\n  };\n'
                f'  static const int64_t cpg_{tag}_jj[] = {{\n  '
                + _fmt_i64(jj) + '\n  };\n'
                f'  cpg_native_set_scatter(h, {0 if tag == "P" else 3}, '
                f'{len(ii)}, cpg_{tag}_ii, cpg_{tag}_jj);\n')
        parts.append(
            '  static const int64_t cpg_rcm_perm[] = {\n  '
            + _fmt_i64(perm) + '\n  };\n'
            f'  cpg_native_set_perm(h, cpg_rcm_perm, {bw});\n')
    if fam.d_quad is not None:
        parts.append('  cpg_native_set_dquad(h, cpg_dquad);\n')
    n_exp = int(getattr(fam, 'n_exp', 0))
    pows = list(getattr(fam, 'pow_alphas', ()) or ())
    if fam.soc_dims or n_exp or pows:
        parts.append(
            'static const int64_t cpg_soc_dims[] = {\n  '
            + _fmt_i64(list(fam.soc_dims)) + '\n};\n'
            f'  cpg_native_set_cones(h, {fam.n_nonneg}, '
            f'{len(fam.soc_dims)}, cpg_soc_dims);\n')
    if n_exp or pows:
        parts.append(
            'static const double cpg_pow_alphas[] = {\n  '
            + _fmt_dbl(pows) + '\n};\n'
            f'  cpg_native_set_cones_ext(h, {n_exp}, {len(pows)}, '
            'cpg_pow_alphas);\n')
    parts.append('  cpg_native_set_theta(h, cpg_theta_default);\n'
                 '  return h;\n}\n')
    # per-user-parameter update functions (reference cpg_update_<name>,
    # utils.py:909-926): idx is the flat (Fortran) index within the
    # parameter, mirroring the reference's flattening convention
    for pi in fam.param_info:
        parts.append(
            f'void cpg_update_{pi.name}(void* h, int64_t idx, '
            'double val) {\n'
            f'  cpg_native_update_theta(h, {pi.offset} + idx, val);\n'
            '}\n')
    with open(os.path.join(cdir, 'cpg_data.c'), 'w') as f:
        f.write(''.join(parts))
    # family header: named update prototypes for user code
    fh = ['#ifndef CPG_FAMILY_H\n#define CPG_FAMILY_H\n'
          '#include "cpg_core.h"\n#ifdef __cplusplus\nextern "C" {\n'
          '#endif\n']
    for pi in fam.param_info:
        fh.append(f'void cpg_update_{pi.name}(void* h, int64_t idx, '
                  'double val);\n')
    # user-variable offsets/sizes in x: where to place gradient seeds
    # (reference cpg_update_d<var> role, writer.py:222-230) and read
    # solutions from cpg_native_get_x
    for vi in fam.user_vars:
        tag = vi.name.upper()
        fh.append(f'#define CPG_VAR_{tag}_OFFSET {vi.offset}\n'
                  f'#define CPG_VAR_{tag}_SIZE {vi.size}\n')
    fh.append('#ifdef __cplusplus\n}\n#endif\n#endif\n')
    with open(os.path.join(cdir, 'cpg_family.h'), 'w') as f:
        f.write(''.join(fh))
    if fam.param_info:
        first = fam.param_info[0]
        upd = (f'  cpg_update_{first.name}(h, 0, '
               f'cpg_theta_default[{first.offset}]);')
    else:
        upd = '  /* parameter-free family */'
    is_conic = bool(fam.soc_dims or n_exp or pows)
    if is_conic:
        grad_block = ('  /* conic family: the embedded gradient covers '
                      'box-QP families only */')
    else:
        grad_block = (
            '  { /* objective gradient w.r.t. theta '
            '(cpg_native_gradient) */\n'
            '    double* dth = (double*)malloc(sizeof(double) * '
            '(size_t)(cpg_p > 0 ? cpg_p : 1));\n'
            '    if (cpg_native_gradient(h, NULL, NULL, 1.0, dth) == 0)\n'
            '      for (int64_t i = 0; i < (cpg_p < 4 ? cpg_p : 4); ++i)\n'
            '        printf("dobj/dtheta[%ld] = %.9g\\n", (long)i, '
            'dth[i]);\n'
            '    free(dth);\n'
            '  }')
    with open(os.path.join(cdir, 'cpg_example.c'), 'w') as f:
        f.write(_EXAMPLE.replace('%UPDATE_LINE%', upd)
                .replace('%GRADIENT_BLOCK%', grad_block))
    with open(os.path.join(cdir, 'Makefile'), 'w') as f:
        f.write(_MAKEFILE)
    return cdir


_EXPLICIT_MAIN = '''/* Standalone explicit-QP evaluator (reference pdaqp
 * lookup-table C role, pdaqp.py:201-219): clip theta to the parameter
 * box, find the region whose halfplane tests all hold (flat min-slack
 * argmax over regions -- the table is the same one the TPU evaluator
 * uses), apply the region's affine feedback.  Build: `make`. */
#include <stdio.h>
#include <string.h>

static double cpg_theta[CPG_P];

/* named per-parameter updates with explicit-mode bound clipping
 * (reference cpg_update_<param> with clip, utils.py:909-926) */
static void cpg_update_raw(int k, double val) {
  if (val < cpg_lb_full[k]) val = cpg_lb_full[k];
  if (val > cpg_ub_full[k]) val = cpg_ub_full[k];
  cpg_theta[k] = val;
}
%UPDATE_FNS%
int main(void) {
  memcpy(cpg_theta, cpg_theta_default, sizeof cpg_theta);
%UPDATE_CALL%
  double tt[CPG_PR + 1];
  for (int j = 0; j < CPG_PR; ++j) {
    double v = cpg_theta[cpg_th_sel[j]];
    if (v < cpg_th_lb[j]) v = cpg_th_lb[j];
    if (v > cpg_th_ub[j]) v = cpg_th_ub[j];
    tt[j] = v;
  }
  tt[CPG_PR] = 1.0;
  int best_r = 0;
  double best_slack = -1e300;
  for (int r = 0; r < CPG_R; ++r) {
    double mslack = 1e300;
    for (int t = 0; t < CPG_T; ++t) {
      double acc = 0.0;
      for (int j = 0; j <= CPG_PR; ++j)
        acc += cpg_TEST[(r * CPG_T + t) * (CPG_PR + 1) + j] * tt[j];
      if (acc < mslack) mslack = acc;
    }
    if (mslack > best_slack) { best_slack = mslack; best_r = r; }
  }
  printf("region = %d, slack = %.6g\\n", best_r, best_slack);
  for (int i = 0; i < CPG_NSTORE; ++i) {
    double acc = 0.0;
    for (int j = 0; j <= CPG_PR; ++j)
      acc += cpg_FB[(best_r * CPG_NSTORE + i) * (CPG_PR + 1) + j] * tt[j];
    printf("x[%d] = %.9g\\n", (int)cpg_store_idx[i], acc);
  }
  /* explicit gradient (reference pdaqp gradient-patch role): inside a
   * region the solution is affine in theta, so the region's feedback
   * row IS the exact Jacobian dx_i/dtheta_j -- print it for the first
   * stored variable (reduced-theta coordinates cpg_th_sel[j]) */
  if (CPG_NSTORE > 0) {
    for (int j = 0; j < CPG_PR; ++j)
      printf("dx[%d]/dtheta[%d] = %.9g\\n", (int)cpg_store_idx[0],
             (int)cpg_th_sel[j],
             cpg_FB[(best_r * CPG_NSTORE + 0) * (CPG_PR + 1) + j]);
  }
  return 0;
}
'''

_EXPLICIT_MAKEFILE = '''CC ?= cc
CFLAGS ?= -O2
cpg_example: cpg_explicit.c
\t$(CC) $(CFLAGS) cpg_explicit.c -o $@
clean:
\trm -f cpg_example
'''


def write_c_artifact_explicit(code_dir, fam, data, theta_default=None):
    """Emit the standalone C lookup-table evaluator for an explicit
    family (reference pdaqp.h/c role): the region tests + feedbacks as C
    arrays and a `main` doing clip -> region search -> affine feedback.
    Returns the c/ directory path."""
    cdir = os.path.join(code_dir, 'c')
    os.makedirs(cdir, exist_ok=True)
    R, t_max, pr1 = data.TEST.shape
    n_store = data.FB.shape[1]
    theta = (np.zeros(fam.p) if theta_default is None
             else np.asarray(theta_default, dtype=float))
    # flat-theta bound arrays for the clipped per-param updates: the box
    # applies to the th_sel-selected entries, everything else is open
    lb_full = np.full(max(fam.p, 1), -1e30)
    ub_full = np.full(max(fam.p, 1), 1e30)
    sel = np.asarray(data.th_sel, dtype=int)
    lb_full[sel] = np.asarray(data.th_lb, dtype=float)
    ub_full[sel] = np.asarray(data.th_ub, dtype=float)
    upd_fns = []
    upd_call = '  /* parameter-free family */'
    for pi in fam.param_info:
        upd_fns.append(
            f'static void cpg_update_{pi.name}(int idx, double val) '
            f'{{ cpg_update_raw({pi.offset} + idx, val); }}\n')
    if fam.param_info:
        p0 = fam.param_info[0]
        upd_call = (f'  cpg_update_{p0.name}(0, '
                    f'cpg_theta_default[{p0.offset}]);')
    parts = [
        '/* Explicit lookup table (reference pdaqp C role): region tests'
        ' (padded rows\n * always satisfied) and per-region affine'
        ' feedbacks, float literals from the\n * stored table. */\n',
        f'#define CPG_R {R}\n#define CPG_T {t_max}\n'
        f'#define CPG_PR {pr1 - 1}\n#define CPG_NSTORE {n_store}\n'
        f'#define CPG_P {max(fam.p, 1)}\n',
        'static const double cpg_lb_full[] = {\n  '
        + _fmt_dbl(lb_full) + '\n};\n',
        'static const double cpg_ub_full[] = {\n  '
        + _fmt_dbl(ub_full) + '\n};\n',
        'static const double cpg_TEST[] = {\n  '
        + _fmt_dbl(np.asarray(data.TEST, dtype=float).ravel()) + '\n};\n',
        'static const double cpg_FB[] = {\n  '
        + _fmt_dbl(np.asarray(data.FB, dtype=float).ravel()) + '\n};\n',
        'static const int cpg_th_sel[] = {\n  '
        + _fmt_i64(data.th_sel) + '\n};\n',
        'static const double cpg_th_lb[] = {\n  '
        + _fmt_dbl(np.asarray(data.th_lb, dtype=float)) + '\n};\n',
        'static const double cpg_th_ub[] = {\n  '
        + _fmt_dbl(np.asarray(data.th_ub, dtype=float)) + '\n};\n',
        'static const int cpg_store_idx[] = {\n  '
        + _fmt_i64(data.store_idx) + '\n};\n',
        'static const double cpg_theta_default[] = {\n  '
        + _fmt_dbl(theta if fam.p else np.zeros(1)) + '\n};\n',
        _EXPLICIT_MAIN.replace('%UPDATE_FNS%', ''.join(upd_fns))
        .replace('%UPDATE_CALL%', upd_call),
    ]
    with open(os.path.join(cdir, 'cpg_explicit.c'), 'w') as f:
        f.write(''.join(parts))
    with open(os.path.join(cdir, 'Makefile'), 'w') as f:
        f.write(_EXPLICIT_MAKEFILE)
    return cdir
