"""Parametric-affine algebra: the ASA-form engine.

Every expression that is affine in the decision variables x with coefficients
affine in the flattened user-parameter vector theta is represented as

    out_flat[i] = sum_j coeffs[v][(i + s*j), :] @ theta_t * x_v[j]
                  + offset[i, :] @ theta_t

with ``theta_t = [theta; 1]`` (size p1 = p + 1).  This mirrors the reference's
central abstraction where every canonical tensor is a sparse affine map of
theta (reference cvxpygen/mappings.py:23-47 ``AffineMap``/``p_id_to_mapping``
and canonicalizer.py:283-332), except we keep ONE uniform representation all
the way through lowering instead of emitting C loops.

All flattening is column-major (F-order), matching CVXPY/the reference
(templates/cpg_solver.py.jinja2:26-34).  Everything here runs offline at
family-compile time; NumPy/SciPy only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import scipy.sparse as spa


def _csr(m):
    return m.tocsr()


def empty_map(n_rows, p1):
    return spa.csr_matrix((n_rows, p1))


def const_map(values, p1):
    """Map whose rows are constants (last column of theta_t)."""
    v = np.asarray(values, dtype=float).ravel()
    nz = np.nonzero(v)[0]
    return _csr(spa.coo_matrix((v[nz], (nz, np.full(len(nz), p1 - 1))),
                               shape=(len(v), p1)))


class DPPError(ValueError):
    """Raised when an operation would make canonical data non-affine in
    theta (parity: CVXPY's DPP errors, enforced by the reference through
    enforce_dpp=True at canonicalizer.py:89-95)."""


@dataclass
class Aff:
    """Affine-in-x expression with theta-affine coefficients."""

    shape: tuple
    coeffs: Dict[int, spa.csr_matrix]  # var_id -> (s * m_v, p1)
    offset: spa.csr_matrix             # (s, p1)
    var_sizes: Dict[int, int]
    p1: int

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= d
        return n

    def is_var_free(self):
        return all(c.nnz == 0 for c in self.coeffs.values())

    def is_theta_free(self):
        """True if neither coefficients nor offset depend on theta."""
        for m in list(self.coeffs.values()) + [self.offset]:
            if m.nnz and np.any(m.tocoo().col != self.p1 - 1):
                return False
        return True

    def coeffs_theta_free(self):
        for m in self.coeffs.values():
            if m.nnz and np.any(m.tocoo().col != self.p1 - 1):
                return False
        return True

    def const_coeff(self, vid):
        """Dense-free extraction: (s, m) sparse matrix of the constant
        coefficients for variable vid (requires theta-free coeffs)."""
        s, m = self.size, self.var_sizes[vid]
        M = self.coeffs[vid].tocoo()
        i = M.row % s
        j = M.row // s
        return spa.coo_matrix((M.data, (i, j)), shape=(s, m)).tocsr()

    def const_offset_vec(self):
        out = np.zeros(self.size)
        M = self.offset.tocoo()
        mask = M.col == self.p1 - 1
        np.add.at(out, M.row[mask], M.data[mask])
        return out


def zeros(shape, p1):
    s = 1
    for d in shape:
        s *= d
    return Aff(shape, {}, empty_map(s, p1), {}, p1)


def constant(arr, p1):
    arr = np.asarray(arr, dtype=float)
    return Aff(arr.shape, {}, const_map(np.ravel(arr, order='F'), p1), {}, p1)


def var_leaf(var, p1):
    s = var.size
    expansion = var.expansion() if hasattr(var, 'expansion') else None
    if expansion is None:
        rows = np.arange(s) + s * np.arange(s)  # (i + s*i)
        coeff = _csr(spa.coo_matrix((np.ones(s), (rows, np.full(s, p1 - 1))),
                                    shape=(s * s, p1)))
        return Aff(var.shape, {var.id: coeff}, empty_map(s, p1),
                   {var.id: s}, p1)
    # symmetric variable: full entries are a fixed expansion of the free
    # (upper-triangular) entries; coefficient of free var j at output i
    er, ec = expansion
    m = var.free_size
    rows = er + s * ec  # (i + s*j)
    coeff = _csr(spa.coo_matrix(
        (np.ones(len(rows)), (rows, np.full(len(rows), p1 - 1))),
        shape=(s * m, p1)))
    return Aff(var.shape, {var.id: coeff}, empty_map(s, p1),
               {var.id: m}, p1)


def param_leaf(param, theta_offset, p1):
    """Variable-free Aff selecting this parameter's theta entries.

    Handles the `diag` and `sparsity` attributes by placing theta entries
    into their dense positions (reference canonicalizer.py:226-271 flat_usp,
    templates/cpg_solver.py.jinja2:26-34)."""
    s = param.size
    coords = param.flat_entry_coords()
    k = param.flat_size
    if coords is None:
        rows = np.arange(s)
    else:
        if len(param.shape) == 2:
            rows = coords[0] + param.shape[0] * coords[1]
        else:
            rows = coords[0]
    cols = theta_offset + np.arange(k)
    off = _csr(spa.coo_matrix((np.ones(k), (rows, cols)), shape=(s, p1)))
    return Aff(param.shape, {}, off, {}, p1)


# ---------------------------------------------------------------------------
# Structural transforms
# ---------------------------------------------------------------------------

def apply_linear(T, a: Aff, out_shape):
    """Apply a constant linear map T (s_out x s_in, sparse) to the flattened
    output entries of ``a``."""
    T = spa.csr_matrix(T)
    coeffs = {}
    for vid, M in a.coeffs.items():
        m = a.var_sizes[vid]
        coeffs[vid] = _csr(spa.kron(spa.identity(m, format='csr'), T) @ M)
    return Aff(tuple(out_shape), coeffs, _csr(T @ a.offset),
               dict(a.var_sizes), a.p1)


def add(a: Aff, b: Aff):
    a, b = _broadcast_pair(a, b)
    coeffs = dict(a.coeffs)
    sizes = dict(a.var_sizes)
    for vid, M in b.coeffs.items():
        coeffs[vid] = (coeffs[vid] + M) if vid in coeffs else M
        sizes[vid] = b.var_sizes[vid]
    return Aff(a.shape, coeffs, a.offset + b.offset, sizes, a.p1)


def neg(a: Aff):
    return Aff(a.shape, {v: -M for v, M in a.coeffs.items()}, -a.offset,
               dict(a.var_sizes), a.p1)


def scale(c, a: Aff):
    c = float(c)
    return Aff(a.shape, {v: c * M for v, M in a.coeffs.items()},
               c * a.offset, dict(a.var_sizes), a.p1)


def promote(a: Aff, shape):
    """Broadcast scalar -> shape."""
    s = 1
    for d in shape:
        s *= d
    assert a.size == 1
    T = spa.csr_matrix(np.ones((s, 1)))
    return apply_linear(T, a, shape)


def _broadcast_pair(a: Aff, b: Aff):
    if a.shape == b.shape:
        return a, b
    if a.size == 1:
        return promote(a, b.shape), b
    if b.size == 1:
        return a, promote(b, a.shape)
    # general numpy broadcast between shapes (e.g. (n,1) + (n,m))
    out_shape = tuple(np.broadcast_shapes(a.shape, b.shape))

    def bcast(x):
        if x.shape == out_shape:
            return x
        src = np.arange(x.size).reshape(x.shape, order='F')
        tgt = np.ravel(np.broadcast_to(src, out_shape), order='F')
        s_out = tgt.size
        T = spa.coo_matrix((np.ones(s_out), (np.arange(s_out), tgt)),
                           shape=(s_out, x.size))
        return apply_linear(T, x, out_shape)

    return bcast(a), bcast(b)


def index_select(a: Aff, flat_idx, out_shape):
    """Row-gather (slicing / transpose / reshape / promote are all gathers)."""
    flat_idx = np.asarray(flat_idx, dtype=int)
    s_out = len(flat_idx)
    T = spa.coo_matrix((np.ones(s_out), (np.arange(s_out), flat_idx)),
                       shape=(s_out, a.size))
    return apply_linear(T, a, out_shape)


def transpose(a: Aff):
    r, c = a.shape
    src = np.arange(a.size).reshape((r, c), order='F')
    flat = np.ravel(src.T, order='F')
    return index_select(a, flat, (c, r))


def reshape(a: Aff, shape):
    return Aff(tuple(shape), a.coeffs, a.offset, dict(a.var_sizes), a.p1)


def sum_all(a: Aff):
    T = spa.csr_matrix(np.ones((1, a.size)))
    return apply_linear(T, a, ())


def sum_axis(a: Aff, axis):
    r, c = a.shape
    if axis == 0:
        T = spa.kron(spa.identity(c), np.ones((1, r)))
        return apply_linear(T, a, (c,))
    T = spa.hstack([spa.identity(r)] * c)
    return apply_linear(T, a, (r,))


def trace(a: Aff):
    r, _ = a.shape
    idx = np.arange(r) * (r + 1)
    T = spa.coo_matrix((np.ones(r), (np.zeros(r, dtype=int), idx)),
                       shape=(1, a.size))
    return apply_linear(T, a, ())


def diff_vec(a: Aff):
    n = a.size
    T = spa.diags([-np.ones(n), np.ones(n - 1)], [0, 1],
                  shape=(n - 1, n)).tocsr()
    return apply_linear(T, a, (n - 1,))


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------

def mul_elemwise_const(cvals, a: Aff):
    """Elementwise multiply by a theta-free dense array (broadcast to a.shape)."""
    c = np.broadcast_to(np.asarray(cvals, dtype=float), a.shape if a.shape else ())
    T = spa.diags(np.ravel(c, order='F') if a.shape else [float(c)])
    return apply_linear(T, a, a.shape)


def mul_elemwise_param(pm: Aff, a: Aff):
    """Elementwise multiply a variable-free theta-affine factor ``pm`` with a
    theta-free var-affine ``a`` (DPP: parameter * variable)."""
    if not a.is_theta_free():
        raise DPPError('product of two parametrized expressions is not DPP')
    s = a.size
    pmap = pm.offset  # (s_pm, p1); broadcast scalar param over a
    if pm.size == 1 and s != 1:
        pmap = spa.vstack([pmap] * s).tocsr() if s else pmap
    coeffs = {}
    for vid, m in a.var_sizes.items():
        C = a.const_coeff(vid).tocoo()  # (s, m)
        rows = C.row + s * C.col
        D = spa.coo_matrix((C.data, (rows, C.row)), shape=(s * m, s))
        coeffs[vid] = _csr(D @ pmap)
    off_c = a.const_offset_vec()
    D0 = spa.diags(off_c)
    return Aff(a.shape, coeffs, _csr(D0 @ pmap), dict(a.var_sizes), a.p1)


def matmul_const_left(C, a: Aff):
    """C @ a for dense/sparse constant C."""
    C = spa.csr_matrix(C) if not spa.issparse(C) else C.tocsr()
    if len(a.shape) <= 1:
        out_shape = (C.shape[0],) if a.shape else ()
        return apply_linear(C, a, out_shape)
    k, c = a.shape
    T = spa.kron(spa.identity(c, format='csr'), C)
    return apply_linear(T, a, (C.shape[0], c))


def matmul_const_right(a: Aff, C):
    """a @ C for constant C; a is (r, k) or (k,)."""
    C = np.asarray(C.todense()) if spa.issparse(C) else np.asarray(C, dtype=float)
    if len(a.shape) == 1:
        # row-vector semantics: (k,) @ (k, c) -> (c,)
        T = spa.csr_matrix(C.T)
        return apply_linear(T, a, (C.shape[1],) if C.ndim == 2 else ())
    r, k = a.shape
    if C.ndim == 1:
        C = C.reshape(k, 1)
        T = spa.kron(spa.csr_matrix(C).T, spa.identity(r, format='csr'))
        return apply_linear(T, a, (r,))
    T = spa.kron(spa.csr_matrix(C).T, spa.identity(r, format='csr'))
    return apply_linear(T, a, (r, C.shape[1]))


def matmul_param_left(L: Aff, R: Aff):
    """L(theta) @ R(x) with L variable-free, R's coefficients theta-free.

    Derivation: out[(a + so*cc)] = sum_b L[(a + so*b)](theta) * R[(b + si*cc)].
    For each var v: out_coeff[((a + so*cc) + so*c*j)] =
        sum_b R_coeff[(b + si*cc), j] * Lmap[(a + so*b)].
    """
    if not R.coeffs_theta_free():
        raise DPPError('parameter @ expression requires theta-free coefficients')
    Lmap = L.offset  # (so*si, p1)
    if len(L.shape) == 2:
        so, si = L.shape
    else:
        so, si = (1, L.size)  # row-vector semantics for (k,) @ X
    if len(R.shape) == 2:
        si2, c = R.shape
    else:
        si2, c = R.size, 1
    assert si == si2, f'matmul mismatch {L.shape} @ {R.shape}'
    s_out = so * c

    coeffs = {}
    for vid, m in R.var_sizes.items():
        Rc = R.const_coeff(vid).tocoo()  # rows (b + si*cc), cols j
        b = Rc.row % si
        cc = Rc.row // si
        j = Rc.col
        # emit so entries per nnz
        a_idx = np.arange(so)
        rows = ((a_idx[None, :] + so * cc[:, None]) + s_out * j[:, None]).ravel()
        cols = (a_idx[None, :] + so * b[:, None]).ravel()
        data = np.repeat(Rc.data, so)
        S = spa.coo_matrix((data, (rows, cols)), shape=(s_out * m, so * si))
        coeffs[vid] = _csr(S @ Lmap)

    # offset: L(theta) @ R_off -- requires R_off theta-free
    Ro = R.offset.tocoo()
    if Ro.nnz and np.any(Ro.col != R.p1 - 1):
        raise DPPError('parameter @ parametrized offset is not DPP')
    off_vec = R.const_offset_vec()
    nz = np.nonzero(off_vec)[0]
    b, cc = nz % si, nz // si
    a_idx = np.arange(so)
    rows = (a_idx[None, :] + so * cc[:, None]).ravel()
    cols = (a_idx[None, :] + so * b[:, None]).ravel()
    data = np.repeat(off_vec[nz], so)
    S0 = spa.coo_matrix((data, (rows, cols)), shape=(s_out, so * si))
    offset = _csr(S0 @ Lmap)

    if len(L.shape) == 2 and len(R.shape) == 2:
        out_shape = (so, c)
    elif len(L.shape) == 2:
        out_shape = (so,)
    elif len(R.shape) == 2:
        out_shape = (c,)
    else:
        out_shape = ()
    s_final = 1
    for d in out_shape:
        s_final *= d
    assert s_final == s_out
    return Aff(out_shape, coeffs, offset, dict(R.var_sizes), R.p1)


def matmul_param_right(Xa: Aff, Rp: Aff):
    """X(x) @ Rp(theta) with Rp variable-free, X's coefficients theta-free.

    out[(i + r*cc)] = sum_b X[(i + r*b)] * Rp[(b + k*cc)](theta).
    """
    if not Xa.coeffs_theta_free():
        raise DPPError('expression @ parameter requires theta-free coefficients')
    if len(Xa.shape) == 2:
        r, k = Xa.shape
    else:
        r, k = 1, Xa.size  # row-vector: (k,) @ (k,c)
    if len(Rp.shape) == 2:
        k2, c = Rp.shape
    else:
        k2, c = Rp.size, 1
    assert k == k2, f'matmul mismatch {Xa.shape} @ {Rp.shape}'
    Rmap = Rp.offset  # (k*c, p1)
    s_out = r * c

    coeffs = {}
    for vid, m in Xa.var_sizes.items():
        Xc = Xa.const_coeff(vid).tocoo()  # rows (i + r*b), cols j
        i = Xc.row % r
        b = Xc.row // r
        j = Xc.col
        cc_idx = np.arange(c)
        rows = ((i[:, None] + r * cc_idx[None, :]) + s_out * j[:, None]).ravel()
        cols = (b[:, None] + k * cc_idx[None, :]).ravel()
        data = np.repeat(Xc.data, c)
        S = spa.coo_matrix((data, (rows, cols)), shape=(s_out * m, k * c))
        coeffs[vid] = _csr(S @ Rmap)

    Xo = Xa.offset.tocoo()
    if Xo.nnz and np.any(Xo.col != Xa.p1 - 1):
        raise DPPError('parametrized offset @ parameter is not DPP')
    off_vec = Xa.const_offset_vec()
    nz = np.nonzero(off_vec)[0]
    i, b = nz % r, nz // r
    cc_idx = np.arange(c)
    rows = (i[:, None] + r * cc_idx[None, :]).ravel()
    cols = (b[:, None] + k * cc_idx[None, :]).ravel()
    data = np.repeat(off_vec[nz], c)
    S0 = spa.coo_matrix((data, (rows, cols)), shape=(s_out, k * c))
    offset = _csr(S0 @ Rmap)

    if len(Xa.shape) == 2 and len(Rp.shape) == 2:
        out_shape = (r, c)
    elif len(Xa.shape) == 2:
        out_shape = (r,)
    elif len(Rp.shape) == 2:
        out_shape = (c,)
    else:
        out_shape = ()
    return Aff(out_shape, coeffs, offset, dict(Xa.var_sizes), Xa.p1)


# ---------------------------------------------------------------------------
# Quadratic forms
# ---------------------------------------------------------------------------

@dataclass
class Quad:
    """value = sum_{(va,vb)} x_va^T Q_{va,vb} x_vb + lin + theta_t' Dq theta_t.

    ``d_quad`` (p1, p1) captures objective constants that are QUADRATIC in
    theta (e.g. ||b(theta)||^2 from sum_squares(Ax - b) with constant A).
    They never affect the minimizer, only the reported objective, so the
    canonical maps stay affine (the reference's 'd' handling,
    solvers/_interface.py:139-146 / nonzero_d).

    Q maps are theta-affine ((ma*mb, p1) sparse, row = ia + ma*ib).  P
    assembly symmetrizes: P = Q_full + Q_full^T so that the canonical
    objective is (1/2) x^T P x + q^T x + d (OSQP convention, reference
    solvers/_interface.py:18-79 QPCanonMixin)."""

    terms: Dict[tuple, spa.csr_matrix]
    lin: Aff
    var_sizes: Dict[int, int]
    p1: int
    d_quad: spa.csr_matrix = None  # (p1, p1) or None

    def scale_const(self, c):
        return Quad({k: c * v for k, v in self.terms.items()},
                    scale(c, self.lin), dict(self.var_sizes), self.p1,
                    None if self.d_quad is None else c * self.d_quad)

    def scale_param(self, pm: Aff):
        """Multiply by a variable-free scalar theta-affine factor; quadratic
        maps must be theta-free (e.g. lamb(theta) * ||delta_u||^2,
        reference tests/test_E2E_QP.py:33)."""
        terms = {}
        for key, M in self.terms.items():
            Mc = M.tocoo()
            if Mc.nnz and np.any(Mc.col != self.p1 - 1):
                raise DPPError('parameter * parametrized quadratic is not DPP')
            colvec = spa.coo_matrix((Mc.data, (Mc.row, np.zeros(Mc.nnz, dtype=int))),
                                    shape=(M.shape[0], 1))
            terms[key] = _csr(colvec @ pm.offset)
        if self.d_quad is not None and self.d_quad.nnz:
            raise DPPError('parameter * quadratic-in-theta offset is not DPP')
        return Quad(terms, mul_elemwise_param(pm, self.lin),
                    dict(self.var_sizes), self.p1, None)

    def __add__(self, other):
        if isinstance(other, Aff):
            other = Quad({}, other, {}, self.p1, None)
        terms = dict(self.terms)
        for k, v in other.terms.items():
            terms[k] = terms[k] + v if k in terms else v
        sizes = dict(self.var_sizes)
        sizes.update(other.var_sizes)
        if self.d_quad is None:
            dq = other.d_quad
        elif other.d_quad is None:
            dq = self.d_quad
        else:
            dq = self.d_quad + other.d_quad
        return Quad(terms, add(self.lin, other.lin), sizes, self.p1, dq)


def quad_from_affine(a: Aff, M=None, weights: Aff = None):
    """Build sum-of-squares / weighted quadratic:  a^T M a  (M constant,
    default I), or sum_i w_i(theta) * a_i^2 when ``weights`` is given.

    Requires a's variable COEFFICIENTS theta-free (else the lowering
    introduces an auxiliary variable, keeping P's parametric map affine --
    reference 'P' handling at solvers/_interface.py:139-146).  A
    theta-affine OFFSET g(theta) is allowed when weights is None: it yields
    an affine q map and a theta-QUADRATIC objective constant captured in
    Quad.d_quad."""
    if not a.coeffs_theta_free():
        raise DPPError('quadratic over parametrized coefficients (internal)')
    if weights is not None and not a.is_theta_free():
        raise DPPError('weighted quadratic over parametrized offset (internal)')
    s = a.size
    p1 = a.p1
    g = a.const_offset_vec()
    g_map = a.offset.tocsr()  # (s, p1), theta-affine offset
    theta_free_offset = a.is_theta_free()
    if weights is not None:
        W = None
    else:
        W = spa.identity(s, format='csr') if M is None else spa.csr_matrix(M)

    terms = {}
    vids = list(a.var_sizes)
    consts = {vid: a.const_coeff(vid) for vid in vids}
    for ia, va in enumerate(vids):
        Fa = consts[va]  # (s, ma)
        for vb in vids[ia:]:
            Fb = consts[vb]
            if weights is None:
                Qab = (Fa.T @ W @ Fb).tocoo()  # (ma, mb)
                if vb == va:
                    pass
                ma = a.var_sizes[va]
                rows = Qab.row + ma * Qab.col
                Qmap = spa.coo_matrix(
                    (Qab.data, (rows, np.full(Qab.nnz, p1 - 1))),
                    shape=(ma * a.var_sizes[vb], p1))
            else:
                # Q_ab(theta) = sum_i w_i(theta) Fa[i,:]^T Fb[i,:]
                ma = a.var_sizes[va]
                FaC, FbC = Fa.tocoo(), Fb.tocoo()
                # build D: rows (ja + ma*jb), cols i, data Fa[i,ja]*Fb[i,jb]
                Fa_r = Fa.tocsr()
                Fb_r = Fb.tocsr()
                rows_l, cols_l, data_l = [], [], []
                for i in range(s):
                    fa = Fa_r.getrow(i).tocoo()
                    fb = Fb_r.getrow(i).tocoo()
                    if fa.nnz == 0 or fb.nnz == 0:
                        continue
                    ja = np.repeat(fa.col, fb.nnz)
                    jb = np.tile(fb.col, fa.nnz)
                    dd = np.repeat(fa.data, fb.nnz) * np.tile(fb.data, fa.nnz)
                    rows_l.append(ja + ma * jb)
                    cols_l.append(np.full(len(ja), i))
                    data_l.append(dd)
                if rows_l:
                    D = spa.coo_matrix(
                        (np.concatenate(data_l),
                         (np.concatenate(rows_l), np.concatenate(cols_l))),
                        shape=(ma * a.var_sizes[vb], s))
                    wmap = weights.offset  # (s, p1)
                    Qmap = _csr(D @ wmap)
                else:
                    Qmap = empty_map(ma * a.var_sizes[vb], p1)
            key = (va, vb)
            if vb != va:
                pass
            terms[key] = terms.get(key, empty_map(Qmap.shape[0], p1)) + Qmap

    # linear part: 2 g(theta)^T W F x  (or 2 sum_i w_i g_i F_i x)
    lin = zeros((), p1)
    d_quad = None
    for vid in vids:
        F = consts[vid]
        if weights is None:
            # q_map_block = 2 F' W g_map  -- affine in theta
            cmap = _csr(2.0 * (F.T @ W @ g_map))
            av = Aff((), {vid: cmap}, empty_map(1, p1),
                     {vid: a.var_sizes[vid]}, p1)
        else:
            # q_j(theta) = 2 sum_i w_i(theta) g_i F[i,j]
            Fc = F.tocoo()
            D = spa.coo_matrix((2.0 * g[Fc.row] * Fc.data, (Fc.col, Fc.row)),
                               shape=(a.var_sizes[vid], s))
            cmap = _csr(D @ weights.offset)
            av = Aff((), {vid: cmap}, empty_map(1, p1),
                     {vid: a.var_sizes[vid]}, p1)
        lin = add(lin, av)
    if weights is None:
        if theta_free_offset:
            lin = add(lin, constant(float(g @ W @ g), p1))
        else:
            d_quad = _csr(g_map.T @ W @ g_map)  # (p1, p1) theta-quadratic
    else:
        D0 = spa.csr_matrix((g * g).reshape(1, s))
        lin = add(lin, Aff((), {}, _csr(D0 @ weights.offset), {}, p1))
    return Quad(terms, lin, dict(a.var_sizes), p1, d_quad)
