"""Constraint classes (parity: cvxpy constraints consumed by the reference).

Dual-value conventions follow CVXPY so that the reference's test harness
pattern (tests/utils_test.py:5-13 get_dual_vec) carries over:
- Inequality  lhs <= rhs: dual >= 0 for (lhs - rhs <= 0)
- Equality    lhs == rhs: free dual for (lhs - rhs == 0)
- SOC(t, X, axis): dual_value is a list [dual_t, dual_X]
"""
from __future__ import annotations

import numpy as np

from .expressions import Expression, _next_id, to_expr


class Constraint:
    def __init__(self, args):
        self.args = [to_expr(a) for a in args]
        self.id = _next_id()
        self.dual_value = None

    def variables(self):
        out = []
        for a in self.args:
            out.extend(a.variables())
        return out

    def parameters(self):
        out = []
        for a in self.args:
            out.extend(a.parameters())
        return out

    def save_dual_value(self, v):
        self.dual_value = v


class Equality(Constraint):
    def __init__(self, lhs, rhs):
        super().__init__([lhs, rhs])
        self.expr = to_expr(lhs) - to_expr(rhs)  # == 0
        self.shape = self.expr.shape
        if not self.expr.is_affine():
            raise ValueError('Equality constraints must be affine')

    @property
    def size(self):
        return self.expr.size

    def violation(self):
        return np.abs(self.expr.value)

    def __repr__(self):
        return f'Equality(shape={self.shape})'


class Inequality(Constraint):
    """lhs <= rhs, i.e. lhs - rhs <= 0 with nonneg dual."""

    def __init__(self, lhs, rhs):
        super().__init__([lhs, rhs])
        self.lhs = to_expr(lhs)
        self.rhs = to_expr(rhs)
        self.expr = self.lhs - self.rhs  # <= 0, convex required
        self.shape = self.expr.shape
        if not (self.lhs.is_convex() and self.rhs.is_concave()):
            raise ValueError('Inequality requires convex <= concave (DCP)')

    @property
    def size(self):
        return self.expr.size

    def violation(self):
        return np.maximum(self.expr.value, 0.0)

    def __repr__(self):
        return f'Inequality(shape={self.shape})'


class SOC(Constraint):
    """Second-order-cone constraint ``norm(X, 2, axis) <= t``.

    Parity: cp.SOC(t, X, axis=...) as used in reference
    tests/test_E2E_SOCP.py:33.  With axis=0 each column of X, with axis=1
    each row of X forms a cone with the matching entry of t.  For vector X,
    t is scalar and the whole vector is one cone.
    """

    def __init__(self, t, X, axis=0):
        super().__init__([t, X])
        self.t = to_expr(t)
        self.X = to_expr(X)
        self.axis = axis
        if not (self.t.is_affine() and self.X.is_affine()):
            raise ValueError('SOC arguments must be affine')
        if self.X.ndim == 1:
            if self.t.size != 1:
                raise ValueError('scalar t required for vector X')
            self.n_cones = 1
            self.cone_dim = self.X.size + 1
        else:
            n_cones = self.X.shape[1] if axis == 0 else self.X.shape[0]
            if self.t.size != n_cones:
                raise ValueError('t size must match number of cones')
            self.n_cones = n_cones
            self.cone_dim = (self.X.shape[0] if axis == 0 else self.X.shape[1]) + 1
        self.shape = (self.n_cones,)

    @property
    def size(self):
        return self.n_cones * self.cone_dim

    def violation(self):
        tv = np.atleast_1d(np.asarray(self.t.value, dtype=float).ravel())
        Xv = np.asarray(self.X.value, dtype=float)
        if Xv.ndim == 1:
            norms = np.array([np.linalg.norm(Xv)])
        else:
            norms = np.linalg.norm(Xv, axis=self.axis)
        return np.maximum(norms - tv, 0.0)

    def __repr__(self):
        return f'SOC(n_cones={self.n_cones}, cone_dim={self.cone_dim})'


class PSD(Constraint):
    """Positive-semidefinite cone constraint: expr >> 0.

    Parity: cvxpy.constraints.PSD, the cone the reference supports through
    Clarabel (cvxpygen/solvers/clarabel.py:148-154 'PSDTriangleConeT').
    The expression must be a square affine matrix; its symmetric part is
    constrained (svec rows in the canonical form).  dual_value is the full
    symmetric dual matrix.
    """

    def __init__(self, expr):
        super().__init__([expr])
        self.expr = self.args[0]
        if self.expr.ndim != 2 or self.expr.shape[0] != self.expr.shape[1]:
            raise ValueError('PSD constraint requires a square matrix')
        if not self.expr.is_affine():
            raise ValueError('PSD constraint requires an affine expression')
        self.shape = self.expr.shape

    @property
    def size(self):
        s = self.shape[0]
        return s * (s + 1) // 2

    def violation(self):
        X = np.asarray(self.expr.value, dtype=float)
        X = 0.5 * (X + X.T)
        lam = np.linalg.eigvalsh(X)
        return max(0.0, float(-lam.min()))

    def __repr__(self):
        return f'PSD(shape={self.shape})'


class PowCone3D(Constraint):
    """3D power-cone constraint: (x_i, y_i, z_i) in K_alpha elementwise,
    K_alpha = {(x, y, z): x^alpha y^(1-alpha) >= |z|, x, y >= 0}.

    Parity: cvxpy.constraints.PowCone3D, the cone the reference supports
    through Clarabel ('PowerConeT', cvxpygen/solvers/clarabel.py:148-154).
    """

    def __init__(self, x, y, z, alpha):
        super().__init__([x, y, z])
        self.x, self.y, self.z = self.args
        self.alpha = float(alpha)
        if not (0.0 < self.alpha < 1.0):
            raise ValueError('PowCone3D alpha must be in (0, 1)')
        if not all(a.is_affine() for a in self.args):
            raise ValueError('PowCone3D arguments must be affine')
        if not (self.x.shape == self.y.shape == self.z.shape):
            raise ValueError('PowCone3D arguments must share one shape')
        self.shape = self.x.shape
        self.n_cones = self.x.size

    @property
    def size(self):
        return 3 * self.n_cones

    def violation(self):
        from .ops.cones import _proj_pow_np
        xv = np.ravel(np.asarray(self.x.value, dtype=float), order='F')
        yv = np.ravel(np.asarray(self.y.value, dtype=float), order='F')
        zv = np.ravel(np.asarray(self.z.value, dtype=float), order='F')
        out = np.zeros(self.n_cones)
        for k in range(self.n_cones):
            v = np.array([xv[k], yv[k], zv[k]])
            out[k] = np.linalg.norm(v - _proj_pow_np(v, self.alpha))
        return out.reshape(self.shape) if self.shape else float(out[0])

    def __repr__(self):
        return f'PowCone3D(alpha={self.alpha}, n_cones={self.n_cones})'


class ExpCone(Constraint):
    """Exponential-cone constraint: (x_i, y_i, z_i) in K_exp elementwise,
    K_exp = cl{(x, y, z): y > 0, y e^{x/y} <= z}.

    Parity: cvxpy.constraints.ExpCone(x, y, z), the cone the reference
    supports through Clarabel (cvxpygen/solvers/clarabel.py:139).
    dual_value is a list [du, dv, dw] shaped like the arguments.
    """

    def __init__(self, x, y, z):
        super().__init__([x, y, z])
        self.x, self.y, self.z = self.args
        if not all(a.is_affine() for a in self.args):
            raise ValueError('ExpCone arguments must be affine')
        if not (self.x.shape == self.y.shape == self.z.shape):
            raise ValueError('ExpCone arguments must share one shape')
        self.shape = self.x.shape
        self.n_cones = self.x.size

    @property
    def size(self):
        return 3 * self.n_cones

    def violation(self):
        from .ops.cones import _proj_exp_np
        xv = np.ravel(np.asarray(self.x.value, dtype=float), order='F')
        yv = np.ravel(np.asarray(self.y.value, dtype=float), order='F')
        zv = np.ravel(np.asarray(self.z.value, dtype=float), order='F')
        out = np.zeros(self.n_cones)
        for k in range(self.n_cones):
            v = np.array([xv[k], yv[k], zv[k]])
            out[k] = np.linalg.norm(v - _proj_exp_np(v))
        return out.reshape(self.shape) if self.shape else float(out[0])

    def __repr__(self):
        return f'ExpCone(n_cones={self.n_cones})'
