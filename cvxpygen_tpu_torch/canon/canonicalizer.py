"""Canonicalizer: Problem -> Family (static parametric canonical form).

The Family is the TPU-native analogue of the reference's generated
``cpg_workspace.c`` + affine-map C loops (reference cvxpygen/utils.py:279-294
``write_canonicalize`` and canonicalizer.py:283-332): every canonical tensor
entry is an affine function of theta_t = [theta; 1], stored here as one
stacked dense matrix so that on-device canonicalization is a single GEMM
(MXU-friendly) followed by scatters into dense canonical tensors.

Canonical row convention: each constraint row r is an affine expression
aff_r(x, theta) = (A x)_r + b_r(theta) with groups ordered
[zero | nonneg | soc cones]:
    zero rows   : aff == 0
    nonneg rows : aff >= 0
    soc cone    : aff_(t,x) in SOC (t first)
Lagrangian convention: L = 0.5 x'Px + q'x + d - y' aff(x), y >= 0 on nonneg
rows, y in SOC on cones, y free on zero rows; stationarity Px + q - A'y = 0.
CVXPY-compatible dual signs are recovered in the retrieval metadata
(equality dual = -y segment; inequality dual = +y segment).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as spa

from ..problem import Problem
from .lowering import Lowering
from . import paraff as pa


@dataclass
class VarInfo:
    vid: int
    name: Optional[str]
    shape: tuple
    offset: int
    size: int
    is_user: bool
    # symmetric variables: COO (rows, cols) mapping free entries -> full
    # F-order flattening (reference upper_tri_to_full, canonicalizer.py:124)
    expand: Optional[tuple] = None


@dataclass
class ParamInfo:
    name: str
    pid: int
    shape: tuple
    offset: int
    flat_size: int
    coords: Optional[tuple]  # (rows, cols) inside dense value, or None


@dataclass
class Family:
    """Compiled problem family: all static structure + theta-affine maps."""

    n: int
    p: int
    p1: int
    var_info: List[VarInfo]
    param_info: List[ParamInfo]
    is_maximization: bool

    # objective
    P_idx: Tuple[np.ndarray, np.ndarray]
    P_map: spa.csr_matrix
    q_map: spa.csr_matrix            # (n, p1)
    d_map: spa.csr_matrix            # (1, p1)

    # constraints, rows ordered [zero | nonneg | socs]
    m: int
    n_zero: int
    n_nonneg: int
    soc_dims: List[int]
    A_idx: Tuple[np.ndarray, np.ndarray]
    A_map: spa.csr_matrix
    b_map: spa.csr_matrix            # (m, p1)

    constr_records: List[dict] = field(default_factory=list)
    # theta-QUADRATIC objective offset (p1, p1); affects only the reported
    # objective value, never the minimizer (see paraff.Quad.d_quad)
    d_quad: Optional[spa.csr_matrix] = None
    # exponential cones (3 rows each, after soc rows), PSD blocks
    # (svec rows, s(s+1)/2 each, after exp rows), and 3D power cones
    # (3 rows each, after psd rows; one alpha per cone)
    n_exp: int = 0
    psd_dims: List[int] = field(default_factory=list)
    pow_alphas: List[float] = field(default_factory=list)

    # ------------------------------------------------------------------
    @property
    def n_soc(self):
        return int(sum(self.soc_dims))

    @property
    def user_vars(self):
        return [v for v in self.var_info if v.is_user]

    def pack_theta(self, params=None, values=None):
        """Flatten parameter values into theta (reference analogue:
        cpg_params_vec updates, utils.py:904-935)."""
        theta = np.zeros(self.p)
        for pi in self.param_info:
            if values is not None and pi.name in values:
                v = np.asarray(values[pi.name], dtype=float)
            else:
                v = None
            src = None
            if params is not None:
                for pp in params:
                    if pp.id == pi.pid:
                        src = pp
                        break
            if src is not None and v is None:
                flat = src.flatten_value()
            else:
                if v is None:
                    raise ValueError(f'missing value for parameter {pi.name}')
                v = v.reshape(pi.shape) if pi.shape else v
                if pi.coords is None:
                    flat = np.ravel(v, order='F')
                else:
                    r, c = pi.coords
                    flat = v[r, c] if len(pi.shape) == 2 else v[r]
            theta[pi.offset:pi.offset + pi.flat_size] = flat
        return theta

    def unpack_theta_grad(self, dtheta):
        """Map a theta-gradient back to per-parameter dense gradients
        (parity: param.gradient assembly, reference
        templates/cpg_solver.py.jinja2:171-173)."""
        out = {}
        for pi in self.param_info:
            seg = np.asarray(dtheta[pi.offset:pi.offset + pi.flat_size])
            if pi.coords is None:
                out[pi.name] = (seg.reshape(pi.shape, order='F')
                                if pi.shape else float(seg[0]))
            else:
                g = np.zeros(pi.shape)
                r, c = pi.coords
                if len(pi.shape) == 2:
                    g[r, c] = seg
                else:
                    g[r] = seg
                out[pi.name] = g
        return out

    # -- dense numeric canonical data (offline/NumPy; used by oracle & tests)
    def canon_numpy(self, theta):
        tt = np.concatenate([np.asarray(theta, dtype=float), [1.0]])
        P = np.zeros((self.n, self.n))
        pv = self.P_map @ tt
        np.add.at(P, (self.P_idx[0], self.P_idx[1]), pv)
        q = self.q_map @ tt
        d = float(np.asarray(self.d_map @ tt).ravel()[0]) if self.d_map.shape[0] else 0.0
        if self.d_quad is not None:
            d += float(tt @ (self.d_quad @ tt))
        A = np.zeros((self.m, self.n))
        av = self.A_map @ tt
        np.add.at(A, (self.A_idx[0], self.A_idx[1]), av)
        b = self.b_map @ tt
        return P, q, d, A, b

    def qp_bounds(self, b):
        """OSQP-style box: l <= A x <= u derived from aff = A x + b groups
        (zero rows: equality; nonneg rows: A x >= -b)."""
        mz, mn = self.n_zero, self.n_nonneg
        if self.soc_dims or self.n_exp or self.psd_dims or self.pow_alphas:
            raise ValueError('QP form unavailable: problem has cones')
        l = np.concatenate([-b[:mz], -b[mz:mz + mn]])
        u = np.concatenate([-b[:mz], np.full(mn, np.inf)])
        return l, u


def canonicalize(problem: Problem) -> Family:
    if not problem.parameters():
        # parity: reference rejects parameter-free problems
        # (canonicalizer.py:98-99)
        raise ValueError('Problem has no parameters: nothing to compile into '
                         'a family. Use plain solve instead.')
    if not problem.objective.is_dcp():
        raise ValueError('Problem is not DCP')
    low = Lowering(problem)
    prog = low.run()
    p1 = low.p1

    # -- variable layout: user vars first, then lowering aux vars ---------
    var_info = []
    offset = 0
    for v in problem.variables():
        fsize = getattr(v, 'free_size', v.size)
        expand = v.expansion() if hasattr(v, 'expansion') else None
        var_info.append(VarInfo(v.id, v.name(), v.shape, offset, fsize, True,
                                expand=expand))
        offset += fsize
    for v in prog.aux_vars:
        var_info.append(VarInfo(v.id, None, v.shape, offset, v.size, False))
        offset += v.size
    n = offset
    var_offset = {vi.vid: vi.offset for vi in var_info}

    param_info = []
    for prm in problem.parameters():
        param_info.append(ParamInfo(prm.name(), prm.id, prm.shape,
                                    low.theta_offsets[prm.id],
                                    prm.flat_size, prm.flat_entry_coords()))

    # -- objective --------------------------------------------------------
    quad = prog.objective
    Pi, Pj, Pmaps = [], [], []
    for (va, vb), Qmap in quad.terms.items():
        ma = quad.var_sizes[va]
        Qmap = Qmap.tocsr()
        nz_rows = np.nonzero(np.diff(Qmap.indptr))[0]  # rows with any nnz
        ia = nz_rows % ma
        ib = nz_rows // ma
        gi = var_offset[va] + ia
        gj = var_offset[vb] + ib
        # P = Q + Q^T (symmetrize)
        Pi.append(gi)
        Pj.append(gj)
        Pi.append(gj)
        Pj.append(gi)
        keep = spa.coo_matrix(
            (np.ones(len(nz_rows)), (np.arange(len(nz_rows)), nz_rows)),
            shape=(len(nz_rows), Qmap.shape[0]))
        Mrows = (keep @ Qmap).tocsr()  # one map row per structural entry
        Pmaps.append(Mrows)
        Pmaps.append(Mrows)
    if Pi:
        Pi = np.concatenate(Pi)
        Pj = np.concatenate(Pj)
        M_all = spa.vstack(Pmaps).tocsr()
        key = Pi * n + Pj
        uniq, inv = np.unique(key, return_inverse=True)
        S = spa.coo_matrix((np.ones(len(key)), (inv, np.arange(len(key)))),
                           shape=(len(uniq), len(key)))
        P_map = (S @ M_all).tocsr()
        P_idx = (uniq // n, uniq % n)
    else:
        P_idx = (np.zeros(0, dtype=int), np.zeros(0, dtype=int))
        P_map = spa.csr_matrix((0, p1))

    q_map = spa.csr_matrix((n, p1))
    lin = quad.lin
    for vid, M in lin.coeffs.items():
        m_v = lin.var_sizes[vid]
        # lin is scalar: row index of M is j directly
        pad_top = var_offset[vid]
        blocks = []
        if pad_top:
            blocks.append(spa.csr_matrix((pad_top, p1)))
        blocks.append(M)
        if n - pad_top - m_v:
            blocks.append(spa.csr_matrix((n - pad_top - m_v, p1)))
        q_map = q_map + spa.vstack(blocks).tocsr()
    d_map = lin.offset.tocsr()

    # -- constraints ------------------------------------------------------
    n_zero = prog.n_zero
    n_nonneg = prog.n_nonneg
    soc_dims = [t.size + x.size for (t, x) in prog.socs]
    n_exp = len(prog.exps)
    psd_dims = [s for (_, s) in prog.psds]
    pow_alphas = [a for (_, _, _, a) in prog.pows]
    m = (n_zero + n_nonneg + int(sum(soc_dims)) + 3 * n_exp
         + int(sum(s * (s + 1) // 2 for s in psd_dims))
         + 3 * len(pow_alphas))

    Ai, Aj, Amaps = [], [], []
    b_blocks = []

    def emit_aff(aff, r):
        s = aff.size
        for vid, M in aff.coeffs.items():
            M = M.tocsr()
            nz_rows = np.nonzero(np.diff(M.indptr))[0]
            i = nz_rows % s
            j = nz_rows // s
            Ai.append(r + i)
            Aj.append(var_offset[vid] + j)
            keep = spa.coo_matrix(
                (np.ones(len(nz_rows)), (np.arange(len(nz_rows)), nz_rows)),
                shape=(len(nz_rows), M.shape[0]))
            Amaps.append((keep @ M).tocsr())
        b_blocks.append(aff.offset)
        return r + s

    r = 0
    for aff in prog.zeros:
        r = emit_aff(aff, r)
    assert r == n_zero
    for aff in prog.nonnegs:
        r = emit_aff(aff, r)
    assert r == n_zero + n_nonneg
    for (t_aff, x_aff) in prog.socs:
        r = emit_aff(t_aff, r)
        r = emit_aff(x_aff, r)
    for (x_aff, y_aff, z_aff) in prog.exps:
        r = emit_aff(x_aff, r)
        r = emit_aff(y_aff, r)
        r = emit_aff(z_aff, r)
    for (svec_aff, _) in prog.psds:
        r = emit_aff(svec_aff, r)
    for (x_aff, y_aff, z_aff, _) in prog.pows:
        r = emit_aff(x_aff, r)
        r = emit_aff(y_aff, r)
        r = emit_aff(z_aff, r)
    assert r == m

    if Ai:
        Ai = np.concatenate(Ai)
        Aj = np.concatenate(Aj)
        A_all = spa.vstack(Amaps).tocsr()
        key = Ai * n + Aj
        uniq, inv = np.unique(key, return_inverse=True)
        S = spa.coo_matrix((np.ones(len(key)), (inv, np.arange(len(key)))),
                           shape=(len(uniq), len(key)))
        A_map = (S @ A_all).tocsr()
        A_idx = (uniq // n, uniq % n)
    else:
        A_idx = (np.zeros(0, dtype=int), np.zeros(0, dtype=int))
        A_map = spa.csr_matrix((0, p1))
    b_map = spa.vstack(b_blocks).tocsr() if b_blocks else spa.csr_matrix((0, p1))

    return Family(
        n=n, p=low.p, p1=p1, var_info=var_info, param_info=param_info,
        is_maximization=problem.objective.is_maximization,
        P_idx=P_idx, P_map=P_map, q_map=q_map, d_map=d_map,
        m=m, n_zero=n_zero, n_nonneg=n_nonneg, soc_dims=soc_dims,
        n_exp=n_exp, psd_dims=psd_dims, pow_alphas=pow_alphas,
        A_idx=A_idx, A_map=A_map, b_map=b_map,
        constr_records=prog.constr_records,
        d_quad=(quad.d_quad if quad.d_quad is not None
                and quad.d_quad.nnz else None))


# ---------------------------------------------------------------------------
# Solution retrieval (parity: cpg_retrieve_prim/dual, utils.py:950-985)
# ---------------------------------------------------------------------------

def retrieve_primal(family: Family, x):
    """x (n,) -> dict var_id -> flat FULL value (F-order); symmetric
    variables are expanded from their free entries."""
    out = {}
    for vi in family.var_info:
        if not vi.is_user:
            continue
        free = np.asarray(x[vi.offset:vi.offset + vi.size])
        if vi.expand is not None:
            full = np.zeros(int(np.prod(vi.shape)))
            rows, cols = vi.expand
            full[rows] = free[cols]
            out[vi.vid] = full
        else:
            out[vi.vid] = free
    return out


def retrieve_duals(family: Family, y):
    """y (m,) canonical dual -> list of per-user-constraint dual values
    (CVXPY conventions, see module docstring)."""
    y = np.asarray(y)
    duals = []
    soc_row_starts = []
    base = family.n_zero + family.n_nonneg
    for d in family.soc_dims:
        soc_row_starts.append(base)
        base += d
    exp_row_start = base  # exp triples follow the soc rows
    psd_row_starts = []
    base = base + 3 * getattr(family, 'n_exp', 0)
    for s in getattr(family, 'psd_dims', ()) or ():
        psd_row_starts.append(base)
        base += s * (s + 1) // 2
    pow_row_start = base  # pow triples follow the psd rows
    for rec in family.constr_records:
        if rec['kind'] == 'pow':
            r0 = pow_row_start + 3 * rec['cone_start']
            tri = y[r0:r0 + 3 * rec['n_cones']].reshape(-1, 3)
            shape = rec['shape']
            comps = []
            for j in range(3):
                v = tri[:, j]
                comps.append(v.reshape(shape, order='F') if shape
                             else float(v[0]))
            duals.append(comps)
            continue
        if rec['kind'] == 'psd':
            from ..ops.cones import unsvec_np
            s = rec['s']
            r0 = psd_row_starts[rec['cone_start']]
            seg = y[r0:r0 + s * (s + 1) // 2]
            duals.append(unsvec_np(seg, s))
            continue
        if rec['kind'] == 'exp':
            r0 = exp_row_start + 3 * rec['cone_start']
            tri = y[r0:r0 + 3 * rec['n_cones']].reshape(-1, 3)
            shape = rec['shape']
            comps = []
            for j in range(3):
                v = tri[:, j]
                comps.append(v.reshape(shape, order='F') if shape
                             else float(v[0]))
            duals.append(comps)
            continue
        if rec['kind'] == 'zero':
            seg = y[rec['start']:rec['start'] + rec['size']]
            v = -seg
        elif rec['kind'] == 'nonneg':
            s0 = family.n_zero + rec['start']
            v = y[s0:s0 + rec['size']]
        else:  # soc
            tvals, xvals = [], []
            for k in range(rec['n_cones']):
                ci = rec['cone_start'] + k
                r0 = soc_row_starts[ci]
                dim = family.soc_dims[ci]
                tvals.append(y[r0])
                xvals.append(y[r0 + 1:r0 + dim])
            t_arr = np.array(tvals)
            X = np.stack(xvals, axis=0)  # (n_cones, dim-1)
            x_shape = rec['x_shape']
            if len(x_shape) == 1:
                duals.append([t_arr.reshape(()) if rec['n_cones'] == 1 else t_arr,
                              X.reshape(-1)])
                continue
            if rec['axis'] == 0:
                Xd = X.T          # cones are columns
            else:
                Xd = X            # cones are rows
            duals.append([t_arr, Xd])
            continue
        shape = rec['shape']
        duals.append(v.reshape(shape, order='F') if shape else float(v[0]))
    return duals


# ---------------------------------------------------------------------------
# Plain-array form of a Family (the port's "weights" interchange)
# ---------------------------------------------------------------------------

_MAP_NAMES = ('P_map', 'q_map', 'd_map', 'A_map', 'b_map', 'd_quad')


def family_to_arrays(fam) -> dict:
    """Any Family-like object -> dict of ints, NumPy arrays and plain records.

    Reads the attributes by name only, so a family canonicalized by another
    package with the same Family layout converts without importing that
    package.  ``family_from_arrays`` inverts it."""
    d = dict(n=int(fam.n), m=int(fam.m), p=int(fam.p), p1=int(fam.p1),
             n_zero=int(fam.n_zero), n_nonneg=int(fam.n_nonneg),
             soc_dims=[int(s) for s in fam.soc_dims],
             is_maximization=bool(fam.is_maximization),
             n_exp=int(getattr(fam, 'n_exp', 0)),
             psd_dims=[int(s) for s in (getattr(fam, 'psd_dims', ()) or ())],
             pow_alphas=[float(a) for a in
                         (getattr(fam, 'pow_alphas', ()) or ())],
             P_idx=tuple(np.asarray(i) for i in fam.P_idx),
             A_idx=tuple(np.asarray(i) for i in fam.A_idx))
    for name in _MAP_NAMES:
        M = getattr(fam, name, None)
        if M is None:
            d[name] = None
            continue
        M = M.tocsr()
        d[name] = dict(data=np.asarray(M.data), indices=np.asarray(M.indices),
                       indptr=np.asarray(M.indptr), shape=tuple(M.shape))
    d['var_info'] = [dict(vid=v.vid, name=v.name, shape=tuple(v.shape),
                          offset=v.offset, size=v.size, is_user=v.is_user,
                          expand=getattr(v, 'expand', None))
                     for v in fam.var_info]
    d['param_info'] = [dict(name=pi.name, pid=pi.pid, shape=tuple(pi.shape),
                            offset=pi.offset, flat_size=pi.flat_size,
                            coords=pi.coords)
                       for pi in fam.param_info]
    d['constr_records'] = [dict(r) for r in fam.constr_records]
    return d


def family_from_arrays(d: dict) -> Family:
    """Inverse of ``family_to_arrays``: a Family of this package."""
    maps = {}
    for name in _MAP_NAMES:
        s = d.get(name)
        maps[name] = (None if s is None else spa.csr_matrix(
            (s['data'], s['indices'], s['indptr']), shape=s['shape']))
    return Family(
        n=d['n'], p=d['p'], p1=d['p1'],
        var_info=[VarInfo(**v) for v in d['var_info']],
        param_info=[ParamInfo(**pi) for pi in d['param_info']],
        is_maximization=d['is_maximization'],
        P_idx=tuple(d['P_idx']), P_map=maps['P_map'], q_map=maps['q_map'],
        d_map=maps['d_map'], m=d['m'], n_zero=d['n_zero'],
        n_nonneg=d['n_nonneg'], soc_dims=list(d['soc_dims']),
        A_idx=tuple(d['A_idx']), A_map=maps['A_map'], b_map=maps['b_map'],
        constr_records=[dict(r) for r in d['constr_records']],
        d_quad=maps['d_quad'], n_exp=d['n_exp'],
        psd_dims=list(d['psd_dims']), pow_alphas=list(d['pow_alphas']))
