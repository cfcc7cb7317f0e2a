"""Lowering: expression tree -> parametric affine/quadratic + cone constraints.

Replaces the CVXPY reduction chain the reference invokes through
``problem.get_problem_data(solver, enforce_dpp=True)`` (reference
cvxpygen/canonicalizer.py:89-95).  Output feeds canonicalizer.py which
assembles the canonical QP / conic tensors and their theta-affine maps.

Epigraph/hypograph substitutions are sound because the Problem layer performs
a DCP check first (atoms only appear in monotonicity-compatible positions).
Quadratic atoms (sum_squares / quad_form / square) are allowed in the
objective only; when their argument depends on theta, an auxiliary variable
y == arg is introduced so P's parametric map stays affine in theta -- the
same device CVXPY's QP canonicalization uses so that the reference's
canonical 'P' has an affine map (reference solvers/_interface.py:139-146).
"""
from __future__ import annotations

import numpy as np

from .. import atoms as at
from ..constraints import (Equality, ExpCone, Inequality, PSD, PowCone3D,
                           SOC)
from ..expressions import (
    AddExpression, Constant, Expression, Index, MatMul, Multiply, Negate,
    Parameter, Promote, Reshape, Transpose, Variable, _next_id,
)
from . import paraff as pa
from .paraff import Aff, DPPError, Quad


class AuxVar:
    """Internal variable introduced by lowering (epigraph / quadratic aux)."""

    def __init__(self, shape):
        self.id = _next_id()
        self.shape = tuple(shape) if not isinstance(shape, int) else (shape,)
        self.size = int(np.prod(self.shape)) if self.shape else 1


class ConeProgram:
    """Lowered program: groups of cone rows + objective Quad + bookkeeping."""

    def __init__(self, p1):
        self.p1 = p1
        self.zeros = []      # list[Aff]  (aff == 0)
        self.nonnegs = []    # list[Aff]  (aff >= 0)
        self.socs = []       # list[(t Aff scalar, x Aff vector)]
        self.exps = []       # list[(x, y, z) scalar Affs]: triple in K_exp
        self.psds = []       # list[(svec Aff, s)]: svec block in PSD cone
        self.pows = []       # list[(x, y, z, alpha)]: triple in K_alpha
        self.n_zero = 0
        self.n_nonneg = 0
        self.constr_records = []  # per user constraint
        self.objective = None     # Quad
        self.aux_vars = []

    def add_zero(self, aff):
        start = self.n_zero
        self.zeros.append(aff)
        self.n_zero += aff.size
        return start

    def add_nonneg(self, aff):
        start = self.n_nonneg
        self.nonnegs.append(aff)
        self.n_nonneg += aff.size
        return start

    def add_soc(self, t_aff, x_aff):
        self.socs.append((t_aff, x_aff))
        return len(self.socs) - 1

    def add_exp(self, x_aff, y_aff, z_aff):
        assert x_aff.size == y_aff.size == z_aff.size == 1
        self.exps.append((x_aff, y_aff, z_aff))
        return len(self.exps) - 1

    def add_psd(self, svec_aff, s):
        assert svec_aff.size == s * (s + 1) // 2
        self.psds.append((svec_aff, s))
        return len(self.psds) - 1

    def add_pow(self, x_aff, y_aff, z_aff, alpha):
        assert x_aff.size == y_aff.size == z_aff.size == 1
        self.pows.append((x_aff, y_aff, z_aff, float(alpha)))
        return len(self.pows) - 1


class Lowering:
    def __init__(self, problem):
        self.problem = problem
        params = problem.parameters()
        self.theta_offsets = {}
        off = 0
        for p in params:
            self.theta_offsets[p.id] = off
            off += p.flat_size
        self.p = off
        self.p1 = off + 1
        self.prog = ConeProgram(self.p1)
        self._cache = {}

    # ------------------------------------------------------------------
    def run(self):
        prog = self.prog
        # user constraints first (stable dual bookkeeping), then objective
        for con in self.problem.constraints:
            self._lower_constraint(con)
        # implicit variable sign attributes (cp.Variable(nonneg=True),
        # reference tests/test_diff.py:17)
        for v in self.problem.variables():
            if v.attributes.get('nonneg'):
                prog.add_nonneg(pa.var_leaf(v, self.p1))
            if v.attributes.get('nonpos'):
                prog.add_nonneg(pa.neg(pa.var_leaf(v, self.p1)))
            if v.attributes.get('PSD'):
                s = v.shape[0]
                prog.add_psd(self._svec_aff(pa.var_leaf(v, self.p1), s), s)
            if v.attributes.get('NSD'):
                s = v.shape[0]
                prog.add_psd(
                    self._svec_aff(pa.neg(pa.var_leaf(v, self.p1)), s), s)
        obj = self.problem.objective
        expr = obj.expr
        if obj.is_maximization:
            expr = -expr
        prog.objective = self.lower_obj(expr)
        return prog

    # ------------------------------------------------------------------
    def aux(self, shape):
        v = AuxVar(shape)
        self.prog.aux_vars.append(v)
        aff = Aff(v.shape, {v.id: self._identity_coeff(v.size)},
                  pa.empty_map(v.size, self.p1), {v.id: v.size}, self.p1)
        return aff

    def _identity_coeff(self, s):
        import scipy.sparse as spa
        rows = np.arange(s) + s * np.arange(s)
        return spa.coo_matrix((np.ones(s), (rows, np.full(s, self.p1 - 1))),
                              shape=(s * s, self.p1)).tocsr()

    # ------------------------------------------------------------------
    def _lower_constraint(self, con):
        prog = self.prog
        if isinstance(con, Equality):
            aff = self.lower(con.expr)
            if not aff.coeffs:
                raise ValueError('Equality constraint has no variables')
            start = prog.add_zero(aff)
            prog.constr_records.append(
                dict(kind='zero', start=start, size=aff.size, shape=con.shape))
        elif isinstance(con, SOC):
            t_aff = self.lower(con.t)
            x_aff = self.lower(con.X)
            idx0 = len(prog.socs)
            X = con.X
            if X.ndim == 1:
                prog.add_soc(t_aff, x_aff)
            else:
                r, c = X.shape
                for i in range(con.n_cones):
                    if con.axis == 0:  # cone i = column i
                        sel = i * r + np.arange(r)
                    else:              # cone i = row i
                        sel = i + r * np.arange(c)
                    xi = pa.index_select(x_aff, sel, (len(sel),))
                    ti = pa.index_select(t_aff, [i], ())
                    prog.add_soc(ti, xi)
            prog.constr_records.append(
                dict(kind='soc', cone_start=idx0, n_cones=con.n_cones,
                     cone_dim=con.cone_dim, axis=con.axis,
                     x_shape=X.shape, shape=con.shape))
        elif isinstance(con, ExpCone):
            xl = self.lower(con.x)
            yl = self.lower(con.y)
            zl = self.lower(con.z)
            idx0 = len(prog.exps)
            for k in range(con.n_cones):
                prog.add_exp(pa.index_select(xl, [k], ()),
                             pa.index_select(yl, [k], ()),
                             pa.index_select(zl, [k], ()))
            prog.constr_records.append(
                dict(kind='exp', cone_start=idx0, n_cones=con.n_cones,
                     shape=con.shape))
        elif isinstance(con, PowCone3D):
            xl = self.lower(con.x)
            yl = self.lower(con.y)
            zl = self.lower(con.z)
            idx0 = len(prog.pows)
            for k in range(con.n_cones):
                prog.add_pow(pa.index_select(xl, [k], ()),
                             pa.index_select(yl, [k], ()),
                             pa.index_select(zl, [k], ()), con.alpha)
            prog.constr_records.append(
                dict(kind='pow', cone_start=idx0, n_cones=con.n_cones,
                     shape=con.shape))
        elif isinstance(con, PSD):
            el = self.lower(con.expr)
            s = con.shape[0]
            idx0 = len(prog.psds)
            prog.add_psd(self._svec_aff(el, s), s)
            prog.constr_records.append(
                dict(kind='psd', cone_start=idx0, s=s, shape=con.shape))
        elif isinstance(con, Inequality):
            # lhs <= rhs  ->  rhs - lhs >= 0; epigraph lowering of the
            # convex lhs / concave rhs happens inside lower()
            aff = self.lower(con.rhs - con.lhs)
            start = prog.add_nonneg(aff)
            prog.constr_records.append(
                dict(kind='nonneg', start=start, size=aff.size, shape=con.shape))
        else:
            raise ValueError(f'unsupported constraint {con!r}')

    # ------------------------------------------------------------------
    # affine / epigraph lowering
    # ------------------------------------------------------------------
    def lower(self, e: Expression) -> Aff:
        # key on id(e) but pin the expression in the cache: temporaries must
        # not be garbage-collected or CPython may reuse their id
        key = id(e)
        if key in self._cache:
            return self._cache[key][1]
        out = self._lower(e)
        self._cache[key] = (e, out)
        return out

    def _lower(self, e):
        p1 = self.p1
        if isinstance(e, Constant):
            return pa.constant(e.value, p1)
        if isinstance(e, Variable):
            return pa.var_leaf(e, p1)
        if isinstance(e, Parameter):
            return pa.param_leaf(e, self.theta_offsets[e.id], p1)
        if isinstance(e, AddExpression):
            return pa.add(self.lower(e.args[0]), self.lower(e.args[1]))
        if isinstance(e, Negate):
            return pa.neg(self.lower(e.args[0]))
        if isinstance(e, Index):
            return pa.index_select(self.lower(e.args[0]), e.flat_idx, e.shape)
        if isinstance(e, Transpose):
            return pa.transpose(self.lower(e.args[0]))
        if isinstance(e, Reshape):
            return pa.reshape(self.lower(e.args[0]), e.shape)
        if isinstance(e, Promote):
            return pa.promote(self.lower(e.args[0]), e.shape)
        if isinstance(e, Multiply):
            return self._lower_multiply(e)
        if isinstance(e, MatMul):
            return self._lower_matmul(e)
        if isinstance(e, at.Sum):
            inner = self.lower(e.args[0])
            return pa.sum_all(inner) if e.axis is None else pa.sum_axis(inner, e.axis)
        if isinstance(e, at.Trace):
            return pa.trace(self.lower(e.args[0]))
        if isinstance(e, at.Diff):
            return pa.diff_vec(self.lower(e.args[0]))
        if isinstance(e, at.Abs):
            return self._epi_abs(self.lower(e.args[0]))
        if isinstance(e, at.Norm):
            return self._epi_norm(e)
        if isinstance(e, at.Maximum):
            return self._epi_minmax(e, convex=True)
        if isinstance(e, at.Minimum):
            return self._epi_minmax(e, convex=False)
        if isinstance(e, at.Pos):
            el = self.lower(e.args[0])
            t = self.aux(e.shape)
            self.prog.add_nonneg(pa.add(t, pa.neg(el)))
            self.prog.add_nonneg(t)
            return t
        if isinstance(e, at.NegPart):
            el = self.lower(e.args[0])
            t = self.aux(e.shape)
            self.prog.add_nonneg(pa.add(t, el))
            self.prog.add_nonneg(t)
            return t
        if isinstance(e, at.Exp):
            return self._epi_exp(e)
        if isinstance(e, at.Log):
            return self._hypo_log(e)
        if isinstance(e, at.Entr):
            return self._hypo_entr(e)
        if isinstance(e, at.RelEntr):
            return self._epi_rel_entr(e)
        if isinstance(e, at.KlDiv):
            xl = self.lower(e.args[0])
            yl = self.lower(e.args[1])
            r = self._epi_rel_entr(e)
            return pa.add(r, pa.add(pa.neg(xl), yl))
        if isinstance(e, at.Logistic):
            return self._epi_logistic(e)
        if isinstance(e, at.LogSumExp):
            return self._epi_log_sum_exp(e)
        if isinstance(e, at.LambdaMax):
            return self._epi_lambda_max(e)
        if isinstance(e, at.LambdaMin):
            return self._hypo_lambda_min(e)
        if isinstance(e, at.LogDet):
            return self._hypo_log_det(e)
        if isinstance(e, at.Power):
            return self._pow_atom(e)
        if isinstance(e, at.Sqrt):
            return self._hypo_sqrt(e)
        if isinstance(e, at.GeoMean):
            return self._hypo_geo_mean(e)
        if isinstance(e, at.QuadOverLin):
            return self._epi_quad_over_lin(e)
        if isinstance(e, at.InvPos):
            return self._epi_inv_pos(e)
        if isinstance(e, (at.SumSquares, at.Square, at.QuadForm, at.Huber)):
            raise NotImplementedError(
                'quadratic atoms are only supported in the objective')
        raise NotImplementedError(f'cannot lower {type(e).__name__}')

    def _lower_multiply(self, e):
        a, b = e.args
        out_shape = e.shape
        if a.is_constant() and not a.parameters():
            ca = np.asarray(a.value, dtype=float)
            bl = self.lower(b)
            if bl.size == 1 and ca.size > 1:
                bl = pa.promote(bl, out_shape)
            return pa.mul_elemwise_const(ca, bl)
        if b.is_constant() and not b.parameters():
            cb = np.asarray(b.value, dtype=float)
            al = self.lower(a)
            if al.size == 1 and cb.size > 1:
                al = pa.promote(al, out_shape)
            return pa.mul_elemwise_const(cb, al)
        # parameter side x variable side
        pa_side, var_side = (a, b) if a.is_constant() else (b, a)
        pl = self.lower(pa_side)
        vl = self.lower(var_side)
        if vl.size == 1 and pl.size > 1:
            vl = pa.promote(vl, out_shape)
        if pl.size == 1 and vl.size > 1:
            pass  # mul_elemwise_param broadcasts scalar pm
        if vl.is_theta_free():
            return pa.mul_elemwise_param(pl, vl)
        if pl.is_theta_free():  # parameter expression that is actually const
            return pa.mul_elemwise_const(pl.const_offset_vec().reshape(
                pl.shape if pl.shape else ()), vl)
        raise DPPError('multiply: product of two parametrized expressions')

    def _lower_matmul(self, e):
        a, b = e.args
        if a.is_constant() and not a.parameters():
            C = np.asarray(a.value, dtype=float)
            bl = self.lower(b)
            if C.ndim == 1:
                C = C.reshape(1, -1)
                out = pa.matmul_const_left(C, bl)
                return pa.reshape(out, e.shape)
            return pa.matmul_const_left(C, bl)
        if b.is_constant() and not b.parameters():
            C = np.asarray(b.value, dtype=float)
            al = self.lower(a)
            return pa.reshape(pa.matmul_const_right(al, C), e.shape)
        if a.is_constant():  # parameter-affine (variable-free) left factor
            return pa.reshape(
                pa.matmul_param_left(self.lower(a), self.lower(b)), e.shape)
        if b.is_constant():
            return pa.reshape(
                pa.matmul_param_right(self.lower(a), self.lower(b)), e.shape)
        raise DPPError('matmul: product of two variable expressions')

    # -- epigraphs -----------------------------------------------------
    def _epi_abs(self, el):
        t = self.aux(el.shape)
        self.prog.add_nonneg(pa.add(t, pa.neg(el)))
        self.prog.add_nonneg(pa.add(t, el))
        return t

    def _epi_norm(self, e):
        el = self.lower(e.args[0])
        if e.p == 1.0:
            if e.axis is not None:
                raise NotImplementedError('norm1 with axis')
            t = self._epi_abs(el)
            return pa.sum_all(t)
        if e.p == np.inf:
            if e.axis is not None:
                raise NotImplementedError('norm_inf with axis')
            t = self.aux(())
            tp = pa.promote(t, el.shape if el.shape else (1,))
            tp = pa.reshape(tp, el.shape)
            self.prog.add_nonneg(pa.add(tp, pa.neg(el)))
            self.prog.add_nonneg(pa.add(tp, el))
            return t
        # p == 2
        if e.axis is None:
            t = self.aux(())
            x = pa.reshape(el, (el.size,))
            self.prog.add_soc(t, x)
            return t
        arg = e.args[0]
        r, c = arg.shape
        n_cones = c if e.axis == 0 else r
        t = self.aux((n_cones,))
        for i in range(n_cones):
            if e.axis == 0:
                sel = i * r + np.arange(r)
            else:
                sel = i + r * np.arange(c)
            xi = pa.index_select(el, sel, (len(sel),))
            ti = pa.index_select(t, [i], ())
            self.prog.add_soc(ti, xi)
        return t

    # -- power-cone graph implementation ---------------------------------
    def _pow_atom(self, e):
        """x^p via K_alpha (elementwise):
        0<p<1 (hypograph):  t <= x^p        <=> (x, 1, t) in K_p
        p>1   (epigraph):   t >= |x|^p      <=> (t, 1, x) in K_{1/p}
        p<0   (epigraph):   t >= x^p (x>0)  <=> (x, t, 1) in K_{-p/(1-p)}
        """
        el = self.lower(e.args[0])
        t = self.aux(e.shape)
        one = self._one()
        p = e.p
        for xk, tk in zip(self._elems(el), self._elems(t)):
            if 0 < p < 1:
                self.prog.add_pow(xk, one, tk, p)
            elif p > 1:
                self.prog.add_pow(tk, one, xk, 1.0 / p)
            else:
                self.prog.add_pow(xk, tk, one, -p / (1.0 - p))
        return t

    # -- rotated-SOC (hyperbolic) graph implementations ------------------
    def _concat(self, affs):
        """Stack scalar/vector Affs into one vector Aff."""
        import scipy.sparse as spa
        total = sum(a.size for a in affs)
        out = None
        off = 0
        for a in affs:
            T = spa.coo_matrix(
                (np.ones(a.size), (np.arange(a.size) + off, np.arange(a.size))),
                shape=(total, a.size)).tocsr()
            piece = pa.apply_linear(T, a, (total,))
            out = piece if out is None else pa.add(out, piece)
            off += a.size
        return out

    def _hyper(self, u, v, w):
        """u v >= ||w||^2, u, v >= 0 as the rotated SOC
        ||(2w, u - v)||_2 <= u + v  (u, v scalar Affs; w any Aff)."""
        t_aff = pa.add(u, v)
        x_aff = self._concat([pa.scale(2.0, pa.reshape(w, (w.size,))),
                              pa.add(u, pa.neg(v))])
        self.prog.add_soc(t_aff, x_aff)

    def _hypo_sqrt(self, e):
        """t <= sqrt(x): t^2 <= x * 1."""
        el = self.lower(e.args[0])
        t = self.aux(e.shape)
        one = self._one()
        for xk, tk in zip(self._elems(el), self._elems(t)):
            self._hyper(xk, one, tk)
        return t

    def _hypo_geo_mean(self, e):
        """t <= sqrt(x y): t^2 <= x y."""
        xl = self.lower(e.args[0])
        yl = self.lower(e.args[1])
        if xl.size == 1 and yl.size > 1:
            xl = pa.promote(xl, e.shape)
        if yl.size == 1 and xl.size > 1:
            yl = pa.promote(yl, e.shape)
        t = self.aux(e.shape)
        for xk, yk, tk in zip(self._elems(xl), self._elems(yl),
                              self._elems(t)):
            self._hyper(xk, yk, tk)
        return t

    def _epi_quad_over_lin(self, e):
        """t >= ||x||^2 / y: ||x||^2 <= y t."""
        xl = self.lower(e.args[0])
        yl = self.lower(e.args[1])
        t = self.aux(())
        self._hyper(yl if yl.shape == () else pa.reshape(yl, ()), t, xl)
        return t

    def _epi_inv_pos(self, e):
        """t >= 1/x (x > 0): t x >= 1."""
        el = self.lower(e.args[0])
        t = self.aux(e.shape)
        one = self._one()
        for xk, tk in zip(self._elems(el), self._elems(t)):
            self._hyper(tk, xk, one)
        return t

    # -- PSD-cone graph implementations ---------------------------------
    def _svec_aff(self, el, s):
        """svec of the symmetric part of a lowered (s, s) matrix Aff:
        upper triangle, column-major, off-diagonals scaled sqrt(2)
        (ops/cones.py convention; an isometry, so cone projection commutes)."""
        import scipy.sparse as spa
        k = s * (s + 1) // 2
        rows, cols, vals = [], [], []
        r = 0
        h = np.sqrt(2.0) / 2.0
        for j in range(s):
            for i in range(j + 1):
                if i == j:
                    rows.append(r)
                    cols.append(i + s * j)
                    vals.append(1.0)
                else:
                    rows.extend([r, r])
                    cols.extend([i + s * j, j + s * i])
                    vals.extend([h, h])
                r += 1
        T = spa.coo_matrix((vals, (rows, cols)), shape=(k, s * s)).tocsr()
        return pa.apply_linear(T, el, (k,))

    def _diag_embed(self, t, s):
        """scalar Aff t -> (s, s) Aff t*I."""
        import scipy.sparse as spa
        idx = np.arange(s) * (s + 1)
        T = spa.coo_matrix((np.ones(s), (idx, np.zeros(s, dtype=int))),
                           shape=(s * s, 1)).tocsr()
        return pa.apply_linear(T, t, (s, s))

    def _hypo_log_det(self, e):
        """t <= log det X via (MOSEK cookbook sec. 6.2.3):
        exists Z lower triangular:
            [[X, Z], [Z', diag(Z)]] >> 0,  t = sum_i log(Z_ii).
        Combines one PSD block (2s x 2s) with s exp cones (log hypographs)."""
        import scipy.sparse as spa
        el = self.lower(e.args[0])
        s = e.args[0].shape[0]
        Z = self.aux((s, s))
        # strictly-upper entries of Z forced to 0 (Z lower triangular)
        up = [i + s * j for j in range(s) for i in range(j)]
        if up:
            self.prog.add_zero(pa.index_select(Z, up, (len(up),)))

        # assemble M = [[X, Z], [Z', diag(Z)]] as a (2s, 2s) Aff
        n2 = 2 * s

        def place(src_idx, dst_idx, n_src):
            return spa.coo_matrix(
                (np.ones(len(src_idx)), (dst_idx, src_idx)),
                shape=(n2 * n2, n_src)).tocsr()

        # X block at (0:s, 0:s): dst i + n2*j from src i + s*j
        src = np.arange(s * s)
        i_s, j_s = src % s, src // s
        T_X = place(src, i_s + n2 * j_s, s * s)
        # Z at (0:s, s:2s): dst i + n2*(s+j)
        T_Ztr = place(src, i_s + n2 * (s + j_s), s * s)
        # Z' at (s:2s, 0:s): dst (s+j) + n2*i  from Z[i,j] (note transpose)
        T_Zbl = place(src, (s + j_s) + n2 * i_s, s * s)
        # diag(Z) at (s+i, s+i): dst (s+i) + n2*(s+i) from Z[i,i]
        di = np.arange(s)
        T_Zd = place(di + s * di, (s + di) + n2 * (s + di), s * s)

        M = pa.apply_linear(T_X, pa.reshape(el, (s * s,)), (n2, n2))
        Zf = pa.reshape(Z, (s * s,))
        M = pa.add(M, pa.apply_linear(T_Ztr, Zf, (n2, n2)))
        M = pa.add(M, pa.apply_linear(T_Zbl, Zf, (n2, n2)))
        M = pa.add(M, pa.apply_linear(T_Zd, Zf, (n2, n2)))
        self.prog.add_psd(self._svec_aff(M, n2), n2)

        # t_i <= log(Z_ii); return sum t
        dz = pa.index_select(Z, list(di + s * di), (s,))
        t = self.aux((s,))
        one = self._one()
        for tk, zk in zip(self._elems(t), self._elems(dz)):
            self.prog.add_exp(tk, one, zk)
        return pa.sum_all(t)

    def _epi_lambda_max(self, e):
        """t >= lambda_max(X)  <=>  t I - X >> 0."""
        el = self.lower(e.args[0])
        s = e.args[0].shape[0]
        t = self.aux(())
        self.prog.add_psd(
            self._svec_aff(pa.add(self._diag_embed(t, s), pa.neg(el)), s), s)
        return t

    def _hypo_lambda_min(self, e):
        """t <= lambda_min(X)  <=>  X - t I >> 0."""
        el = self.lower(e.args[0])
        s = e.args[0].shape[0]
        t = self.aux(())
        self.prog.add_psd(
            self._svec_aff(pa.add(el, pa.neg(self._diag_embed(t, s))), s), s)
        return t

    # -- exponential-cone graph implementations ------------------------
    # K_exp = cl{(a, b, c): b > 0, b e^{a/b} <= c}  (ops/cones.py)
    def _one(self):
        return pa.constant(1.0, self.p1)

    def _elems(self, aff):
        return [pa.index_select(aff, [k], ()) for k in range(aff.size)]

    def _epi_exp(self, e):
        """t >= e^x  <=>  (x, 1, t) in K_exp (elementwise)."""
        el = self.lower(e.args[0])
        t = self.aux(e.shape)
        one = self._one()
        for xk, tk in zip(self._elems(el), self._elems(t)):
            self.prog.add_exp(xk, one, tk)
        return t

    def _hypo_log(self, e):
        """t <= log x  <=>  (t, 1, x) in K_exp."""
        el = self.lower(e.args[0])
        t = self.aux(e.shape)
        one = self._one()
        for xk, tk in zip(self._elems(el), self._elems(t)):
            self.prog.add_exp(tk, one, xk)
        return t

    def _hypo_entr(self, e):
        """t <= -x log x  <=>  (t, x, 1) in K_exp."""
        el = self.lower(e.args[0])
        t = self.aux(e.shape)
        one = self._one()
        for xk, tk in zip(self._elems(el), self._elems(t)):
            self.prog.add_exp(tk, xk, one)
        return t

    def _epi_rel_entr(self, e):
        """t >= x log(x/y)  <=>  (-t, x, y) in K_exp."""
        xl = self.lower(e.args[0])
        yl = self.lower(e.args[1])
        if xl.size == 1 and yl.size > 1:
            xl = pa.promote(xl, e.shape)
        if yl.size == 1 and xl.size > 1:
            yl = pa.promote(yl, e.shape)
        t = self.aux(e.shape)
        for xk, yk, tk in zip(self._elems(xl), self._elems(yl),
                              self._elems(t)):
            self.prog.add_exp(pa.neg(tk), xk, yk)
        return t

    def _epi_logistic(self, e):
        """t >= log(1+e^x): e^{x-t} + e^{-t} <= 1 via two exp cones."""
        el = self.lower(e.args[0])
        t = self.aux(e.shape)
        u = self.aux(e.shape)
        v = self.aux(e.shape)
        one = self._one()
        for xk, tk, uk, vk in zip(self._elems(el), self._elems(t),
                                  self._elems(u), self._elems(v)):
            self.prog.add_exp(pa.add(xk, pa.neg(tk)), one, uk)
            self.prog.add_exp(pa.neg(tk), one, vk)
            self.prog.add_nonneg(
                pa.add(one, pa.neg(pa.add(uk, vk))))
        return t

    def _epi_log_sum_exp(self, e):
        """t >= log sum e^{x_i}: sum_i e^{x_i - t} <= 1."""
        el = self.lower(e.args[0])
        one = self._one()
        arg = e.args[0]
        if e.axis is None:
            groups = [list(range(el.size))]
            t = self.aux(())
            t_elems = [t] * 1
        else:
            r, c = arg.shape
            n_g = c if e.axis == 0 else r
            if e.axis == 0:
                groups = [[g * r + i for i in range(r)] for g in range(n_g)]
            else:
                groups = [[g + r * j for j in range(c)] for g in range(n_g)]
            t = self.aux((n_g,))
            t_elems = self._elems(t)
        el_elems = self._elems(el)
        for g, rows in enumerate(groups):
            tg = t_elems[g] if e.axis is not None else t
            u = self.aux((len(rows),))
            u_elems = self._elems(u)
            for uk, i in zip(u_elems, rows):
                self.prog.add_exp(pa.add(el_elems[i], pa.neg(tg)), one, uk)
            self.prog.add_nonneg(pa.add(one, pa.neg(pa.sum_all(u))))
        return t

    def _epi_minmax(self, e, convex):
        """Maximum (epigraph t >= arg_i) / Minimum (hypograph t <= arg_i)."""
        t = self.aux(e.shape)
        for arg in e.args:
            al = self.lower(arg)
            if al.size == 1 and t.size > 1:
                al = pa.promote(al, e.shape)
            elif al.shape != e.shape and al.size == t.size:
                al = pa.reshape(al, e.shape)
            if convex:
                self.prog.add_nonneg(pa.add(t, pa.neg(al)))
            else:
                self.prog.add_nonneg(pa.add(al, pa.neg(t)))
        return t

    # ------------------------------------------------------------------
    # objective lowering (quadratic-aware)
    # ------------------------------------------------------------------
    def lower_obj(self, e) -> Quad:
        if not _has_quad(e):
            aff = self.lower(e)
            return Quad({}, aff, dict(aff.var_sizes), self.p1)
        if isinstance(e, AddExpression):
            return self.lower_obj(e.args[0]) + self.lower_obj(e.args[1])
        if isinstance(e, Negate):
            return self.lower_obj(e.args[0]).scale_const(-1.0)
        if isinstance(e, at.SumSquares):
            return self._quad_of(e.args[0], M=None)
        if isinstance(e, at.QuadForm):
            return self._quad_of(e.args[0], M=e.M)
        if isinstance(e, at.Huber):
            if e.size != 1:
                raise NotImplementedError(
                    'vector huber must be wrapped in sum()')
            return self._obj_huber(e)
        if isinstance(e, at.Sum) and isinstance(e.args[0], at.Huber):
            return self._obj_huber(e.args[0])
        if isinstance(e, at.Square):
            if e.size != 1:
                raise NotImplementedError(
                    'vector square must be wrapped in sum()/weighted sum')
            return self._quad_of(e.args[0], M=None)
        if isinstance(e, at.Sum) and isinstance(e.args[0], at.Square):
            return self._quad_of(e.args[0].args[0], M=None)
        if isinstance(e, (Multiply, MatMul)):
            return self._lower_obj_product(e)
        raise NotImplementedError(
            f'quadratic atom under unsupported node {type(e).__name__}')

    def _lower_obj_product(self, e):
        a, b = e.args
        quad_side = b if _has_quad(b) else a
        other = a if quad_side is b else b
        if _has_quad(other):
            raise DPPError('product of two quadratic expressions')
        if isinstance(quad_side, at.Square) and quad_side.size > 1:
            # weighted sum of squares: w @ square(x) (or multiply+sum)
            if isinstance(e, MatMul):
                w = other
                if w.is_constant() and not w.parameters():
                    wv = np.asarray(w.value, dtype=float).ravel()
                    return self._quad_of(quad_side.args[0], M=np.diag(wv))
                wl = self.lower(w)
                return self._quad_of(quad_side.args[0], weights=wl)
            raise NotImplementedError('elementwise weighted square: wrap in sum()')
        # scalar scaling of a quadratic subtree
        q = self.lower_obj(quad_side)
        if not other.is_scalar():
            raise NotImplementedError('non-scalar weight on quadratic term')
        if other.is_constant() and not other.parameters():
            return q.scale_const(float(np.asarray(other.value)))
        wl = self.lower(other)  # variable-free scalar (theta-affine)
        if not wl.is_var_free():
            raise DPPError('variable * quadratic is not DCP')
        return q.scale_param(wl)

    def _obj_huber(self, h):
        """sum(huber(x, M)) = min_{x = n + s} sum(n^2) + 2M sum(|s|)
        (aux-variable QP form; matches CVXPY's huber canonicalization)."""
        el = self.lower(h.args[0])
        nv = self.aux((el.size,))
        sv = self.aux((el.size,))
        flat = pa.reshape(el, (el.size,))
        self.prog.add_zero(pa.add(flat, pa.neg(pa.add(nv, sv))))
        t = self._epi_abs(sv)
        quad = pa.quad_from_affine(nv)
        return quad + pa.scale(2.0 * h.M, pa.sum_all(t))

    def _quad_of(self, inner, M=None, weights=None):
        el = self.lower(inner)
        need_aux = not el.coeffs_theta_free()
        if weights is not None and not el.is_theta_free():
            need_aux = True
        if need_aux:
            # aux substitution keeps P's map affine in theta (a theta-affine
            # OFFSET alone is handled directly via Quad.d_quad)
            y = self.aux((el.size,))
            flat = pa.reshape(el, (el.size,))
            self.prog.add_zero(pa.add(y, pa.neg(flat)))
            el = y
        return pa.quad_from_affine(el, M=M, weights=weights)


def _has_quad(e):
    if isinstance(e, (at.SumSquares, at.Square, at.QuadForm, at.Huber)):
        return True
    return any(_has_quad(a) for a in e.args)
