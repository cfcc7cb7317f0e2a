"""Atom library.

Covers the atom set used by the reference's tests and examples
(reference tests/test_E2E_QP.py, test_E2E_LP.py, test_E2E_SOCP.py,
test_explicit.py, test_diff.py, examples/*): sum_squares, quad_form, square,
abs, norm (p in {1, 2, inf}, optional axis), minimum, maximum, multiply, sum,
trace, vec, diff, pos, neg, reshape.

Atoms are declarative; their graph implementations (epigraph / hypograph
lowerings to affine + cone constraints) live in canon/lowering.py.
"""
from __future__ import annotations

import numpy as np

from .expressions import (
    AFFINE, CONCAVE, CONSTANT, CONVEX, SIGN_POS, SIGN_UNKNOWN, UNKNOWN,
    Constant, Expression, Multiply, Reshape, broadcast_shapes, curv_neg,
    sign_neg, to_expr,
)


class Atom(Expression):
    def __init__(self, *args):
        self.args = [to_expr(a) for a in args]
        self.shape = self._shape_from_args()

    def _shape_from_args(self):
        return ()


# ---------------------------------------------------------------------------
# Affine atoms
# ---------------------------------------------------------------------------

class Sum(Atom):
    def __init__(self, x, axis=None):
        self.axis = axis
        super().__init__(x)

    def _shape_from_args(self):
        x = self.args[0]
        if self.axis is None:
            return ()
        if x.ndim != 2:
            raise ValueError('axis only valid for matrices')
        return (x.shape[1],) if self.axis == 0 else (x.shape[0],)

    def curvature(self):
        return self.args[0].curvature()

    def sign(self):
        return self.args[0].sign()

    def numeric(self, values):
        return np.sum(values[0], axis=self.axis)


class Trace(Atom):
    def _shape_from_args(self):
        x = self.args[0]
        if x.ndim != 2 or x.shape[0] != x.shape[1]:
            raise ValueError('trace requires a square matrix')
        return ()

    def curvature(self):
        return self.args[0].curvature()

    def sign(self):
        return self.args[0].sign()

    def numeric(self, values):
        return np.trace(values[0])


class Diff(Atom):
    """First differences along a vector (cp.diff, used in test_explicit.py:18)."""

    def __init__(self, x, k=1):
        if k != 1:
            raise NotImplementedError('only first differences supported')
        super().__init__(x)

    def _shape_from_args(self):
        x = self.args[0]
        if x.ndim != 1:
            raise NotImplementedError('diff supports vectors only')
        return (x.shape[0] - 1,)

    def curvature(self):
        return self.args[0].curvature()

    def numeric(self, values):
        return np.diff(values[0])


# ---------------------------------------------------------------------------
# Convex / concave atoms
# ---------------------------------------------------------------------------

def _affine_arg_curv(arg, result):
    c = arg.curvature()
    if c in (CONSTANT,):
        return CONSTANT
    if c in (AFFINE,):
        return result
    return UNKNOWN


class Abs(Atom):
    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return np.abs(values[0])


class Norm(Atom):
    """p-norm; p in {1, 2, inf}. axis=None reduces to scalar; axis=k applies
    the norm along axis k of a matrix (reference test_E2E_SOCP.py:32
    ``cp.norm(u, 2, axis=1)``)."""

    def __init__(self, x, p=2, axis=None):
        self.p = float(p) if p != 'inf' else np.inf
        self.axis = axis
        super().__init__(x)
        if self.p not in (1.0, 2.0, np.inf):
            raise NotImplementedError('norm p must be 1, 2 or inf')

    def _shape_from_args(self):
        x = self.args[0]
        if self.axis is None:
            return ()
        if x.ndim != 2:
            raise ValueError('axis only valid for matrices')
        return (x.shape[1],) if self.axis == 0 else (x.shape[0],)

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        v = values[0]
        if self.axis is None:
            v = np.ravel(v, order='F')
            return np.linalg.norm(v, self.p)
        return np.linalg.norm(v, self.p, axis=self.axis)


class Minimum(Atom):
    """Elementwise minimum (concave)."""

    def _shape_from_args(self):
        s = self.args[0].shape
        for a in self.args[1:]:
            s = broadcast_shapes(s, a.shape)
        return s

    def curvature(self):
        for a in self.args:
            if a.curvature() not in (CONSTANT, AFFINE, CONCAVE):
                return UNKNOWN
        return CONCAVE

    def numeric(self, values):
        out = values[0]
        for v in values[1:]:
            out = np.minimum(out, v)
        return out


class Maximum(Atom):
    """Elementwise maximum (convex)."""

    def _shape_from_args(self):
        s = self.args[0].shape
        for a in self.args[1:]:
            s = broadcast_shapes(s, a.shape)
        return s

    def curvature(self):
        for a in self.args:
            if a.curvature() not in (CONSTANT, AFFINE, CONVEX):
                return UNKNOWN
        return CONVEX

    def numeric(self, values):
        out = values[0]
        for v in values[1:]:
            out = np.maximum(out, v)
        return out


class Square(Atom):
    """Elementwise square (convex)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return values[0] ** 2


class SumSquares(Atom):
    """sum of squares of all entries (convex quadratic)."""

    def _shape_from_args(self):
        return ()

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return float(np.sum(np.asarray(values[0]) ** 2))


class QuadForm(Atom):
    """x^T M x with constant PSD (or NSD) M (reference supports parametrized
    P only via sqrt factor products; we match test usage: constant M,
    tests/test_explicit.py:131 ``cp.quad_form(x, P)`` with numpy P)."""

    def __init__(self, x, M):
        x = to_expr(x)
        M = np.asarray(M.value if isinstance(M, Expression) else M, dtype=float)
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise ValueError('quad_form matrix must be square')
        if x.size != M.shape[0]:
            raise ValueError('quad_form dimension mismatch')
        self.M = 0.5 * (M + M.T)
        ev = np.linalg.eigvalsh(self.M)
        # NB: plain `abs` is shadowed by the Abs atom in this module
        ev_scale = max(1.0, float(np.abs(ev).max()))
        self.psd = bool(np.all(ev >= -1e-9 * ev_scale))
        self.nsd = bool(np.all(ev <= 1e-9 * ev_scale))
        if not (self.psd or self.nsd):
            raise ValueError('quad_form matrix must be PSD or NSD')
        super().__init__(x)

    def _shape_from_args(self):
        return ()

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX if self.psd else CONCAVE)

    def numeric(self, values):
        v = np.ravel(values[0], order='F')
        return float(v @ self.M @ v)


class Huber(Atom):
    """Elementwise Huber penalty: x^2 for |x| <= M, 2M|x| - M^2 beyond
    (convex; affine arg).  QP-representable: huber(x) =
    min_{x = n + s} n^2 + 2M|s| (canon/lowering.py objective path)."""

    def __init__(self, x, M=1.0):
        self.M = float(M.value if isinstance(M, Expression) else M)
        if self.M <= 0:
            raise ValueError('huber M must be positive')
        super().__init__(x)

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        x = np.asarray(values[0], dtype=float)
        M = self.M
        return np.where(np.abs(x) <= M, x ** 2, 2 * M * np.abs(x) - M * M)


class Pos(Atom):
    """max(x, 0) elementwise (convex)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return np.maximum(values[0], 0.0)


class NegPart(Atom):
    """cp.neg: max(-x, 0) elementwise (convex, nonneg)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return np.maximum(-values[0], 0.0)


# ---------------------------------------------------------------------------
# Exponential-cone atoms (reference: supported via Clarabel's exp cone,
# cvxpygen/solvers/clarabel.py:133-155; here lowered to EXP rows consumed by
# the conic-ADMM engine's exp-cone projection, ops/cones.py)
# ---------------------------------------------------------------------------

def _monotone_curv(arg, result, increasing=True):
    """Curvature of a monotone convex/concave scalar atom composition."""
    c = arg.curvature()
    if c == CONSTANT:
        return CONSTANT
    if c == AFFINE:
        return result
    if result == CONVEX:
        ok = CONVEX if increasing else CONCAVE
    else:
        ok = CONCAVE if increasing else CONVEX
    return result if c == ok else UNKNOWN


class Exp(Atom):
    """Elementwise e^x (convex, increasing, positive)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _monotone_curv(self.args[0], CONVEX, increasing=True)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return np.exp(values[0])


class Log(Atom):
    """Elementwise natural log (concave, increasing)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _monotone_curv(self.args[0], CONCAVE, increasing=True)

    def sign(self):
        return SIGN_UNKNOWN

    def numeric(self, values):
        return np.log(values[0])


class Entr(Atom):
    """Elementwise entropy -x log x (concave, not monotone: affine arg)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONCAVE)

    def numeric(self, values):
        x = np.asarray(values[0], dtype=float)
        return np.where(x > 0, -x * np.log(np.where(x > 0, x, 1.0)),
                        np.where(x == 0, 0.0, -np.inf))


class RelEntr(Atom):
    """Elementwise x log(x/y) (jointly convex; affine args)."""

    def _shape_from_args(self):
        a, b = self.args
        return broadcast_shapes(a.shape, b.shape)

    def curvature(self):
        for a in self.args:
            if a.curvature() not in (CONSTANT, AFFINE):
                return UNKNOWN
        if all(a.curvature() == CONSTANT for a in self.args):
            return CONSTANT
        return CONVEX

    def numeric(self, values):
        x, y = (np.asarray(v, dtype=float) for v in values)
        return np.where((x > 0) & (y > 0),
                        x * np.log(np.where((x > 0) & (y > 0), x / y, 1.0)),
                        np.where((x == 0) & (y >= 0), 0.0, np.inf))


class KlDiv(Atom):
    """Elementwise x log(x/y) - x + y (convex, nonneg; affine args)."""

    def _shape_from_args(self):
        a, b = self.args
        return broadcast_shapes(a.shape, b.shape)

    def curvature(self):
        return RelEntr.curvature(self)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        x, y = (np.asarray(v, dtype=float) for v in values)
        r = RelEntr.numeric(self, values)
        return r - x + y


class Logistic(Atom):
    """Elementwise log(1 + e^x) (convex, increasing, positive)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _monotone_curv(self.args[0], CONVEX, increasing=True)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return np.logaddexp(0.0, values[0])


class LogSumExp(Atom):
    """log sum_i e^{x_i} over all entries (axis=None) or along an axis
    (convex, increasing)."""

    def __init__(self, x, axis=None):
        self.axis = axis
        super().__init__(x)

    def _shape_from_args(self):
        x = self.args[0]
        if self.axis is None:
            return ()
        if x.ndim != 2:
            raise ValueError('axis only valid for matrices')
        return (x.shape[1],) if self.axis == 0 else (x.shape[0],)

    def curvature(self):
        return _monotone_curv(self.args[0], CONVEX, increasing=True)

    def numeric(self, values):
        x = np.asarray(values[0], dtype=float)
        if self.axis is None:
            m = x.max()
            return m + np.log(np.sum(np.exp(x - m)))
        m = x.max(axis=self.axis)
        return m + np.log(np.sum(
            np.exp(x - np.expand_dims(m, self.axis)), axis=self.axis))


# ---------------------------------------------------------------------------
# SOC-representable power-family atoms (lowered to rotated second-order
# cones, canon/lowering.py _hyper; the classic uv >= w^2 representation)
# ---------------------------------------------------------------------------

class Sqrt(Atom):
    """Elementwise sqrt(x) (concave, increasing, arg >= 0 implied)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _monotone_curv(self.args[0], CONCAVE, increasing=True)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return np.sqrt(values[0])


class GeoMean(Atom):
    """Two-term geometric mean sqrt(x * y), elementwise (concave)."""

    def __init__(self, x, y):
        super().__init__(x, y)

    def _shape_from_args(self):
        a, b = self.args
        return broadcast_shapes(a.shape, b.shape)

    def curvature(self):
        for a in self.args:
            if a.curvature() not in (CONSTANT, AFFINE, CONCAVE):
                return UNKNOWN
        if all(a.curvature() == CONSTANT for a in self.args):
            return CONSTANT
        return CONCAVE

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return np.sqrt(np.asarray(values[0]) * np.asarray(values[1]))


class QuadOverLin(Atom):
    """sum(x^2) / y with y > 0 (jointly convex; y concave-compatible)."""

    def __init__(self, x, y):
        super().__init__(x, y)
        if self.args[1].size != 1:
            raise ValueError('quad_over_lin denominator must be scalar')

    def _shape_from_args(self):
        return ()

    def curvature(self):
        x, y = self.args
        if x.curvature() not in (CONSTANT, AFFINE):
            return UNKNOWN
        if y.curvature() not in (CONSTANT, AFFINE, CONCAVE):
            return UNKNOWN
        return CONVEX

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return float(np.sum(np.asarray(values[0]) ** 2)
                     / float(np.asarray(values[1])))


class InvPos(Atom):
    """Elementwise 1/x on x > 0 (convex, decreasing)."""

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        return _monotone_curv(self.args[0], CONVEX, increasing=False)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return 1.0 / np.asarray(values[0], dtype=float)


class Power(Atom):
    """Elementwise x^p via the 3D power cone (canon/lowering.py):
    p in (0,1): concave increasing; p > 1 or p < 0: convex (x >= 0
    implied, as in cvxpy's power)."""

    def __init__(self, x, p):
        self.p = float(p)
        assert self.p not in (0.0, 1.0)
        super().__init__(x)

    def _shape_from_args(self):
        return self.args[0].shape

    def curvature(self):
        if 0 < self.p < 1:
            return _monotone_curv(self.args[0], CONCAVE, increasing=True)
        if self.p > 1:
            return _affine_arg_curv(self.args[0], CONVEX)
        return _monotone_curv(self.args[0], CONVEX, increasing=False)

    def sign(self):
        return SIGN_POS

    def numeric(self, values):
        return np.asarray(values[0], dtype=float) ** self.p


def _power_atom(x, p):
    """cp.power parity: special-cased p (affine/QP/SOC lowerings), general
    real p via the 3D power cone."""
    p = float(p)
    if p == 1.0:
        return to_expr(x)
    if p == 2.0:
        return Square(x)
    if p == 0.5:
        return Sqrt(x)
    if p == -1.0:
        return InvPos(x)
    if p == 0.0:
        raise ValueError('power p=0 is constant 1')
    return Power(x, p)


# ---------------------------------------------------------------------------
# PSD-cone atoms (reference: Clarabel PSD triangle cone,
# cvxpygen/solvers/clarabel.py:148-154)
# ---------------------------------------------------------------------------

class LambdaMax(Atom):
    """Largest eigenvalue of a symmetric matrix (convex; affine arg)."""

    def _shape_from_args(self):
        x = self.args[0]
        if x.ndim != 2 or x.shape[0] != x.shape[1]:
            raise ValueError('lambda_max requires a square matrix')
        return ()

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONVEX)

    def numeric(self, values):
        X = np.asarray(values[0], dtype=float)
        return float(np.linalg.eigvalsh(0.5 * (X + X.T)).max())


class LogDet(Atom):
    """log det(X) for PSD X (concave; affine arg).  Lowered via the
    standard SDP+exp representation (canon/lowering.py _hypo_log_det):
    t <= log det X  <=>  exists lower-triangular Z with
    [[X, Z], [Z', diag(Z)]] >> 0 and t <= sum_i log(Z_ii)."""

    def _shape_from_args(self):
        x = self.args[0]
        if x.ndim != 2 or x.shape[0] != x.shape[1]:
            raise ValueError('log_det requires a square matrix')
        return ()

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONCAVE)

    def numeric(self, values):
        X = np.asarray(values[0], dtype=float)
        sign, logdet = np.linalg.slogdet(0.5 * (X + X.T))
        return logdet if sign > 0 else -np.inf


class LambdaMin(Atom):
    """Smallest eigenvalue of a symmetric matrix (concave; affine arg)."""

    def _shape_from_args(self):
        x = self.args[0]
        if x.ndim != 2 or x.shape[0] != x.shape[1]:
            raise ValueError('lambda_min requires a square matrix')
        return ()

    def curvature(self):
        return _affine_arg_curv(self.args[0], CONCAVE)

    def numeric(self, values):
        X = np.asarray(values[0], dtype=float)
        return float(np.linalg.eigvalsh(0.5 * (X + X.T)).min())


# ---------------------------------------------------------------------------
# Functional API (cp.* parity)
# ---------------------------------------------------------------------------

def sum(x, axis=None):  # noqa: A001 - cp.sum parity
    return Sum(x, axis=axis)


def trace(x):
    return Trace(x)


def vec(x):
    x = to_expr(x)
    return Reshape(x, (x.size,))


def reshape(x, shape):
    return Reshape(to_expr(x), shape)


def diff(x, k=1):
    return Diff(x, k)


def abs(x):  # noqa: A001 - cp.abs parity
    return Abs(x)


def norm(x, p=2, axis=None):
    return Norm(x, p, axis)


def norm1(x):
    return Norm(x, 1)


def norm2(x):
    return Norm(x, 2)


def norm_inf(x):
    return Norm(x, 'inf')


def minimum(*args):
    return Minimum(*args)


def maximum(*args):
    return Maximum(*args)


def multiply(a, b):
    return Multiply(to_expr(a), to_expr(b))


def square(x):
    return Square(x)


def sum_squares(x):
    return SumSquares(x)


def quad_form(x, M):
    return QuadForm(x, M)


def pos(x):
    return Pos(x)


def neg(x):
    return NegPart(x)


def exp(x):
    return Exp(x)


def log(x):
    return Log(x)


def entr(x):
    return Entr(x)


def rel_entr(x, y):
    return RelEntr(x, y)


def kl_div(x, y):
    return KlDiv(x, y)


def logistic(x):
    return Logistic(x)


def log_sum_exp(x, axis=None):
    return LogSumExp(x, axis=axis)


def lambda_max(x):
    return LambdaMax(x)


def lambda_min(x):
    return LambdaMin(x)


def log_det(x):
    return LogDet(x)


def sqrt(x):
    return Sqrt(x)


def geo_mean(x, y=None):
    if y is None:
        x = to_expr(x)
        if x.size != 2:
            raise NotImplementedError(
                'geo_mean of an n-vector: only 2 elements supported')
        return GeoMean(x[0], x[1])
    return GeoMean(x, y)


def quad_over_lin(x, y):
    return QuadOverLin(x, y)


def inv_pos(x):
    return InvPos(x)


def power(x, p):
    return _power_atom(x, p)


def huber(x, M=1.0):
    return Huber(x, M)
