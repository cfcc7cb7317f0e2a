"""Native host runtime: ctypes bindings over cpg_core.cpp.

Port of the JAX package's ``native/__init__.py``.  ``cpg_core.cpp`` is
that package's core: the same code, with one line of its header comment
(which named a path outside the project) changed.  It is the one C++
source that both this runtime and every emitted ``c/`` project
(codegen/emit_c.py) compile, so the two packages' embedded artifacts
compute the same thing.  It is compiled on first use with ``g++`` into
``build/cvxpygen_tpu_torch/`` (ops/build.py's directory, listed in
``.gitignore``) and bound with ctypes: host-side float64 solving without
torch, the counterpart of the reference's generated embedded C.  The
library's name is keyed on the source, the compile flags and the target
that ``-march=native`` resolves to on this host, so a build directory
copied to another machine is never loaded there.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops.build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, 'cpg_core.cpp')
_LIB = None
_LIB_LOCK = threading.Lock()


CXXFLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-std=c++17']


@functools.lru_cache(maxsize=None)
def _host_target():
    """What ``-march=native`` resolves to here (g++'s target options)."""
    res = subprocess.run(['g++', '-march=native', '-Q', '--help=target'],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError('g++ -march=native -Q --help=target failed:\n'
                           + res.stdout + res.stderr)
    return res.stdout


def lib_path():
    """Where the library for the current source, flags and host lives
    (built or not)."""
    h = hashlib.sha1()
    with open(SRC, 'rb') as f:
        h.update(f.read())
    h.update(' '.join(CXXFLAGS).encode())
    h.update(_host_target().encode())
    return os.path.join(BUILD_DIR, f'libcpg_core_{h.hexdigest()[:12]}.so')


def _build_lib():
    out = lib_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # a per-process temp name: processes that build at once each
        # compile their own file and the last rename wins
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = ['g++', *CXXFLAGS, SRC, '-o', tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError('g++ failed for cpg_core.cpp:\n'
                               + res.stdout + res.stderr)
        os.replace(tmp, out)
    return out


def get_lib():
    """The bound library, built on the first call in the process."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(_build_lib()))
        return _LIB


def _bind(lib):
    c_dbl_p = ctypes.POINTER(ctypes.c_double)
    c_i64_p = ctypes.POINTER(ctypes.c_int64)
    lib.cpg_native_init.restype = ctypes.c_void_p
    lib.cpg_native_init.argtypes = [ctypes.c_int64] * 4
    lib.cpg_native_set_map.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
        c_i64_p, c_i64_p, c_dbl_p]
    lib.cpg_native_set_dquad.argtypes = [ctypes.c_void_p, c_dbl_p]
    lib.cpg_native_set_cones_ext.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, c_dbl_p]
    lib.cpg_native_set_cones.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, c_i64_p]
    lib.cpg_native_set_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
        c_i64_p, c_i64_p]
    lib.cpg_native_set_perm.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64]
    lib.cpg_native_set_theta.argtypes = [ctypes.c_void_p, c_dbl_p]
    lib.cpg_native_update_theta.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double]
    lib.cpg_native_set_setting.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_double]
    lib.cpg_native_solve.argtypes = [ctypes.c_void_p]
    lib.cpg_native_obj.restype = ctypes.c_double
    lib.cpg_native_obj.argtypes = [ctypes.c_void_p]
    for fn in ('cpg_native_status', 'cpg_native_iters'):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ('cpg_native_pri_res', 'cpg_native_dua_res'):
        getattr(lib, fn).restype = ctypes.c_double
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.cpg_native_get_x.argtypes = [ctypes.c_void_p, c_dbl_p]
    lib.cpg_native_get_y.argtypes = [ctypes.c_void_p, c_dbl_p]
    lib.cpg_native_gradient.restype = ctypes.c_int32
    lib.cpg_native_gradient.argtypes = [
        ctypes.c_void_p, c_dbl_p, c_dbl_p, ctypes.c_double, c_dbl_p]
    lib.cpg_native_free.argtypes = [ctypes.c_void_p]
    return lib


def _as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


class NativeQPSolver:
    """Host-side float64 solver for a compiled family (QP form, or
    SOC/exp/pow conic form via the conic-ADMM z-update -- the reference's
    embedded SCS C covers zero/nonneg/SOC, scs.py:130-135; PSD families
    are not embeddable).

    This is the counterpart of the reference's embedded C: it runs on the
    host in float64 by design, whatever device the caller has.  It is not
    a fallback of the torch solvers: no route of ``CpgRuntime``,
    ``CompiledQPSolver`` or ``TorchLayer`` dispatches to it, with or
    without a card."""

    MAP_IDS = {'P': 0, 'q': 1, 'd': 2, 'A': 3, 'b': 4}
    SETTING_IDS = {'rho': 0, 'sigma': 1, 'alpha': 2, 'eps_abs': 3,
                   'eps_rel': 4, 'max_iter': 5, 'warm_start': 6,
                   'rho_eq_scale': 7}

    def __init__(self, family, force_sparse=False):
        if getattr(family, 'psd_dims', ()):
            raise ValueError('native solver: PSD cones are not embeddable '
                             '(the projection needs an eigendecomposition; '
                             'the dependency-free core stops at exp/pow -- '
                             'the reference draws the same line by keeping '
                             'PSD on Clarabel, clarabel.py:133-155)')
        self.family = family
        self.lib = get_lib()
        self.h = self.lib.cpg_native_init(family.n, family.m, family.p,
                                          family.n_zero)
        n_exp = int(getattr(family, 'n_exp', 0))
        pows = list(getattr(family, 'pow_alphas', ()) or ())
        if family.soc_dims or n_exp or pows:
            socs = _as_i64(list(family.soc_dims))
            self.lib.cpg_native_set_cones(
                self.h, int(family.n_nonneg), len(family.soc_dims),
                socs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if n_exp or pows:
            alphas = np.ascontiguousarray(pows, dtype=np.float64)
            self.lib.cpg_native_set_cones_ext(
                self.h, n_exp, len(pows),
                alphas.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        import scipy.sparse as spa
        from ..runtime.torch_family import _expand_rows
        n, m = family.n, family.m
        # large families: sparse COO P/A + banded-Cholesky core under a
        # codegen-time RCM permutation (no dense-expanded maps at all);
        # force_sparse exercises the path on small families (tests)
        self.sparse_mode = (force_sparse
                            or (n * n + m * n) * family.p1 > 5e7)
        if self.sparse_mode:
            if (family.soc_dims or getattr(family, 'n_exp', 0)
                    or getattr(family, 'pow_alphas', ())):
                raise ValueError('native solver: family too large for the '
                                 'dense core and the sparse/banded core '
                                 'is box-QP only')
            Pfull = family.P_map.tocsr()
            Afull = family.A_map.tocsr()
            for which, idx in ((0, family.P_idx), (3, family.A_idx)):
                ii = _as_i64(idx[0])
                jj = _as_i64(idx[1])
                self.lib.cpg_native_set_scatter(
                    self.h, which, len(idx[0]),
                    ii.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    jj.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            from scipy.sparse.csgraph import reverse_cuthill_mckee
            Pp = spa.coo_matrix((np.ones(len(family.P_idx[0])),
                                 family.P_idx), shape=(n, n))
            Ap = spa.coo_matrix((np.ones(len(family.A_idx[0])),
                                 family.A_idx), shape=(m, n))
            Mpat = (Pp + Pp.T + Ap.T @ Ap + spa.eye(n)).tocsr()
            perm = _as_i64(reverse_cuthill_mckee(Mpat, symmetric_mode=True))
            Mp = Mpat[np.asarray(perm)][:, np.asarray(perm)].tocoo()
            bw = int(np.max(np.abs(Mp.row - Mp.col))) if Mp.nnz else 0
            self.lib.cpg_native_set_perm(
                self.h, perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                bw)
        else:
            Pfull = spa.csr_matrix(_expand_rows(family.P_map, family.P_idx,
                                                n * n, n))
            Afull = spa.csr_matrix(_expand_rows(family.A_map, family.A_idx,
                                                m * n, n))
        for name, M in (('P', Pfull), ('q', family.q_map), ('d', family.d_map),
                        ('A', Afull), ('b', family.b_map)):
            M = M.tocsr()
            indptr = _as_i64(M.indptr)
            indices = _as_i64(M.indices)
            data = np.ascontiguousarray(M.data, dtype=np.float64)
            self.lib.cpg_native_set_map(
                self.h, self.MAP_IDS[name], M.shape[0],
                indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if family.d_quad is not None:
            dq = np.ascontiguousarray(family.d_quad.toarray(),
                                      dtype=np.float64)
            self.lib.cpg_native_set_dquad(
                self.h, dq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    def set_settings(self, **kwargs):
        for k, v in kwargs.items():
            if k in self.SETTING_IDS:
                self.lib.cpg_native_set_setting(
                    self.h, self.SETTING_IDS[k], float(v))

    def solve(self, theta):
        theta = np.ascontiguousarray(theta, dtype=np.float64)
        if theta.size != self.family.p:
            raise ValueError(f'theta of size {theta.size}, '
                             f'{self.family.p} expected')
        self.lib.cpg_native_set_theta(
            self.h, theta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        self.lib.cpg_native_solve(self.h)
        n, m = self.family.n, self.family.m
        x = np.zeros(n)
        y = np.zeros(m)
        self.lib.cpg_native_get_x(
            self.h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        self.lib.cpg_native_get_y(
            self.h, y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        status = self.lib.cpg_native_status(self.h)
        return dict(
            x=x, y=y, y_canon=-y,
            obj=self.lib.cpg_native_obj(self.h),
            iters=self.lib.cpg_native_iters(self.h),
            solved=status == 1,
            # 1 optimal, 0 max_iter, -3 primal infeasible, -4 dual
            # infeasible/unbounded (OSQP section 3.4 certificates)
            status=status,
            pri_res=self.lib.cpg_native_pri_res(self.h),
            dua_res=self.lib.cpg_native_dua_res(self.h))

    def gradient(self, gx=None, gy=None, gobj=0.0):
        """VJP at the last solve: seeds dL/dx (len n), dL/dy (len m, used
        on active rows) and/or a scalar dL/dobjective; returns dL/dtheta
        (len p).  Embedded counterpart of autodiff/qp_diff.py; fulfils
        the reference's generated-gradient role (cpg_osqp_grad_compute
        .c.jinja2:432-529) in the C artifact."""
        c_dbl_p = ctypes.POINTER(ctypes.c_double)

        def _ptr(v, size):
            if v is None:
                return None
            a = np.ascontiguousarray(v, dtype=np.float64)
            if a.size != size:
                raise ValueError(f'gradient seed of size {a.size}, '
                                 f'{size} expected')
            return a.ctypes.data_as(c_dbl_p)
        dtheta = np.zeros(max(self.family.p, 1))
        rc = self.lib.cpg_native_gradient(
            self.h, _ptr(gx, self.family.n), _ptr(gy, self.family.m),
            float(gobj), dtheta.ctypes.data_as(c_dbl_p))
        if rc == -1:
            raise ValueError('cpg_native_gradient: conic families are not '
                             'differentiable in the embedded core '
                             '(reference gradient is OSQP-only)')
        if rc != 0:
            raise RuntimeError(f'cpg_native_gradient failed (rc={rc})')
        return dtheta[:self.family.p]

    def __del__(self):
        try:
            self.lib.cpg_native_free(self.h)
        except Exception:
            pass
