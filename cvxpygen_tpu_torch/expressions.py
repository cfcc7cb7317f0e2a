"""Expression system: the user modeling layer (L0).

The reference delegates modeling to CVXPY (`cp.Variable`, `cp.Parameter`,
`cp.Problem`; see reference cvxpygen/canonicalizer.py:89-95 which calls
``problem.get_problem_data(solver, enforce_dpp=True)``).  CVXPY is not a
dependency of this framework: we provide a self-contained disciplined-convex
modeling layer covering the atom set exercised by the reference's tests and
examples (sum_squares, quad_form, square, abs, norm1/norm2(+axis)/norm_inf,
minimum/maximum, multiply, trace, sum, vec, diff, pos/neg, matmul, indexing,
transpose, reshape), with DPP-compliant parameter handling.

Design notes (TPU-first): expressions are a lightweight symbolic tree used
*offline only*.  Canonicalization (canon/) compiles the tree once into static
parametric affine maps; all online work is jitted JAX.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as spa

# ---------------------------------------------------------------------------
# Curvature / sign lattice
# ---------------------------------------------------------------------------

CONSTANT = 'constant'
AFFINE = 'affine'
CONVEX = 'convex'
CONCAVE = 'concave'
UNKNOWN = 'unknown'

SIGN_POS = 'nonneg'
SIGN_NEG = 'nonpos'
SIGN_ZERO = 'zero'
SIGN_UNKNOWN = 'unknown'


def curv_add(a, b):
    order = {CONSTANT: 0, AFFINE: 1, CONVEX: 2, CONCAVE: 3, UNKNOWN: 4}
    a, b = (a, b) if order[a] <= order[b] else (b, a)
    if a in (CONSTANT, AFFINE):
        return b if b != CONSTANT or a != CONSTANT else CONSTANT
    if a == b:
        return a
    return UNKNOWN


def curv_neg(c):
    return {CONVEX: CONCAVE, CONCAVE: CONVEX}.get(c, c)


def sign_add(a, b):
    if a == SIGN_ZERO:
        return b
    if b == SIGN_ZERO:
        return a
    if a == b:
        return a
    return SIGN_UNKNOWN


def sign_neg(s):
    return {SIGN_POS: SIGN_NEG, SIGN_NEG: SIGN_POS}.get(s, s)


def sign_mul(a, b):
    if SIGN_ZERO in (a, b):
        return SIGN_ZERO
    if SIGN_UNKNOWN in (a, b):
        return SIGN_UNKNOWN
    return SIGN_POS if a == b else SIGN_NEG


# ---------------------------------------------------------------------------
# Shape helpers (numpy-like, restricted to ndim <= 2)
# ---------------------------------------------------------------------------

def shape_size(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def broadcast_shapes(s1, s2):
    """Shape of s1 (op) s2 under scalar broadcast or exact match."""
    if s1 == s2:
        return s1
    if shape_size(s1) == 1:
        return s2
    if shape_size(s2) == 1:
        return s1
    # numpy-style broadcasting for ndim-2 (used by e.g. row + matrix)
    try:
        return tuple(np.broadcast_shapes(s1, s2))
    except ValueError:
        raise ValueError(f'Incompatible shapes {s1} and {s2}')


def matmul_shape(s1, s2):
    a = s1 if len(s1) == 2 else (1, s1[0]) if len(s1) == 1 else (1, 1)
    b = s2 if len(s2) == 2 else (s2[0], 1) if len(s2) == 1 else (1, 1)
    if a[1] != b[0]:
        raise ValueError(f'Incompatible matmul shapes {s1} @ {s2}')
    if len(s1) == 2 and len(s2) == 2:
        return (a[0], b[1])
    if len(s1) == 2 and len(s2) == 1:
        return (a[0],)
    if len(s1) == 1 and len(s2) == 2:
        return (b[1],)
    return ()


# ---------------------------------------------------------------------------
# Expression base
# ---------------------------------------------------------------------------

_LEAF_COUNTER = [0]


def _next_id():
    _LEAF_COUNTER[0] += 1
    return _LEAF_COUNTER[0]


class Expression:
    """Base class of the symbolic tree.

    Subclasses define: shape, args, curvature(), sign(), value property.
    """

    shape: tuple = ()
    args: list = []

    # make numpy defer to our reflected operators (np.ones(n) @ expr etc.)
    __array_ufunc__ = None
    __array_priority__ = 100

    # --- introspection ----------------------------------------------------
    @property
    def size(self):
        return shape_size(self.shape)

    @property
    def ndim(self):
        return len(self.shape)

    def is_scalar(self):
        return self.size == 1

    def curvature(self):
        raise NotImplementedError

    def sign(self):
        return SIGN_UNKNOWN

    def is_constant(self):
        return self.curvature() == CONSTANT

    def is_affine(self):
        return self.curvature() in (CONSTANT, AFFINE)

    def is_convex(self):
        return self.curvature() in (CONSTANT, AFFINE, CONVEX)

    def is_concave(self):
        return self.curvature() in (CONSTANT, AFFINE, CONCAVE)

    def is_nonneg(self):
        return self.sign() in (SIGN_POS, SIGN_ZERO)

    def is_nonpos(self):
        return self.sign() in (SIGN_NEG, SIGN_ZERO)

    def variables(self):
        out, seen = [], set()
        self._collect(Variable, out, seen)
        return out

    def parameters(self):
        out, seen = [], set()
        self._collect(Parameter, out, seen)
        return out

    def _collect(self, cls, out, seen):
        if isinstance(self, cls) and id(self) not in seen:
            seen.add(id(self))
            out.append(self)
        for a in self.args:
            a._collect(cls, out, seen)

    # --- numeric evaluation ----------------------------------------------
    @property
    def value(self):
        """Numeric value given current Variable/Parameter values (or None)."""
        vals = []
        for a in self.args:
            v = a.value
            if v is None:
                return None
            vals.append(np.asarray(v, dtype=float))
        return self.numeric(vals)

    def numeric(self, values):
        raise NotImplementedError

    # --- operators --------------------------------------------------------
    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(other, self)

    def __sub__(self, other):
        return add(self, negate(to_expr(other)))

    def __rsub__(self, other):
        return add(other, negate(self))

    def __neg__(self):
        return negate(self)

    def __mul__(self, other):
        return _smart_mul(self, to_expr(other))

    def __rmul__(self, other):
        return _smart_mul(to_expr(other), self)

    def __truediv__(self, other):
        other = to_expr(other)
        if not other.is_constant() and not (isinstance(other, Parameter) and other.is_scalar()):
            raise ValueError('Can only divide by a constant or scalar parameter')
        if other.is_constant():
            return _smart_mul(Constant(1.0 / np.asarray(other.value, dtype=float)), self)
        raise NotImplementedError('division by parameter not supported (not DPP)')

    def __matmul__(self, other):
        return MatMul(self, to_expr(other))

    def __rmatmul__(self, other):
        return MatMul(to_expr(other), self)

    def __pow__(self, p):
        if p == 2:
            from .atoms import square
            return square(self)
        raise NotImplementedError('only **2 supported')

    def __le__(self, other):
        from .constraints import Inequality
        return Inequality(self, to_expr(other))

    def __ge__(self, other):
        from .constraints import Inequality
        return Inequality(to_expr(other), self)

    def __eq__(self, other):  # noqa: intentional constraint semantics
        from .constraints import Equality
        return Equality(self, to_expr(other))

    def __rshift__(self, other):
        """X >> Y: X - Y is positive semidefinite (cvxpy parity)."""
        from .constraints import PSD
        return PSD(self - to_expr(other))

    def __lshift__(self, other):
        """X << Y: Y - X is positive semidefinite."""
        from .constraints import PSD
        return PSD(to_expr(other) - self)

    def __hash__(self):
        return id(self)

    def __getitem__(self, key):
        return Index(self, key)

    @property
    def T(self):
        if self.ndim < 2:
            return self
        return Transpose(self)


def to_expr(x):
    if isinstance(x, Expression):
        return x
    return Constant(x)


def add(a, b):
    return AddExpression(to_expr(a), to_expr(b))


def negate(a):
    return Negate(to_expr(a))


def _smart_mul(a, b):
    """`*` operator: scalar multiply or elementwise with a constant/parameter.

    Mirrors CVXPY semantics where `*` between a scalar and an expression
    scales, and elementwise multiply requires cp.multiply (we allow `*` for
    same-shape when one side is constant/parameter, like CVXPY >= 1.1).
    """
    a, b = to_expr(a), to_expr(b)
    if a.is_scalar() or b.is_scalar():
        return Multiply(a, b)
    raise ValueError('Use multiply() for elementwise products of non-scalars')


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

def _canon_shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(d) for d in shape)


class Leaf(Expression):
    args = []

    def __init__(self, shape=(), name=None, nonneg=False, nonpos=False):
        self.shape = _canon_shape(shape)
        if len(self.shape) > 2:
            raise ValueError('Only scalars, vectors and matrices supported')
        self.id = _next_id()
        self.name_str = name if name is not None else f'{type(self).__name__.lower()}{self.id}'
        self.attributes = {'nonneg': nonneg, 'nonpos': nonpos}
        self._value = None

    def name(self):
        return self.name_str

    def sign(self):
        if self.attributes.get('nonneg'):
            return SIGN_POS
        if self.attributes.get('nonpos'):
            return SIGN_NEG
        return SIGN_UNKNOWN

    def __repr__(self):
        return f'{type(self).__name__}({self.name_str}, shape={self.shape})'


class Variable(Leaf):
    """Decision variable (parity: cp.Variable(shape, name=..., nonneg=...,
    symmetric=...)).  Symmetric matrix variables are represented by their
    upper-triangular entries internally and expanded on retrieval
    (reference canonicalizer.py:124-158 upper_tri_to_full)."""

    def __init__(self, shape=(), name=None, nonneg=False, nonpos=False,
                 symmetric=False, PSD=False, NSD=False):
        super().__init__(shape, name, nonneg, nonpos)
        # PSD/NSD variables are symmetric with an implicit cone constraint
        # (parity: cp.Variable(PSD=True); reference supports these through
        # its symmetric upper-tri expansion, canonicalizer.py:124-158)
        self.attributes['symmetric'] = symmetric or PSD or NSD
        self.attributes['PSD'] = PSD
        self.attributes['NSD'] = NSD
        if PSD and NSD:
            raise ValueError('a variable cannot be both PSD and NSD')
        if self.attributes['symmetric']:
            if len(self.shape) != 2 or self.shape[0] != self.shape[1]:
                raise ValueError('symmetric requires a square matrix variable')
        self.gradient = None  # set by user for cpg_gradient parity

    @property
    def free_size(self):
        """Number of independent scalar entries."""
        if self.attributes.get('symmetric'):
            nn = self.shape[0]
            return nn * (nn + 1) // 2
        return self.size

    def expansion(self):
        """(rows, cols) COO of the map from free entries to the full
        F-order flattening, or None for plain variables.  Free entries are
        the upper triangle in column-major order."""
        if not self.attributes.get('symmetric'):
            return None
        nn = self.shape[0]
        rows, cols = [], []
        k = 0
        for j in range(nn):
            for i in range(j + 1):
                rows.append(i + nn * j)
                cols.append(k)
                if i != j:
                    rows.append(j + nn * i)
                    cols.append(k)
                k += 1
        return np.asarray(rows), np.asarray(cols)

    def curvature(self):
        return AFFINE

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self._value = None if v is None else np.asarray(v, dtype=float).reshape(self.shape)

    def save_value(self, v):
        self._value = v


class Parameter(Leaf):
    """Problem-family parameter.

    Parity with cp.Parameter attributes used by the reference: ``nonneg``,
    ``diag`` (reference tests/test_E2E_QP.py:52-54), ``sparsity``
    (examples/main.py:17).  The flattened entries of all parameters form the
    theta vector of the ASA form (reference cvxpygen/mappings.py:130-137).
    """

    def __init__(self, shape=(), name=None, nonneg=False, nonpos=False,
                 diag=False, sparsity=None):
        super().__init__(shape, name, nonneg, nonpos)
        self.attributes['diag'] = diag
        self.attributes['sparsity'] = None
        self.gradient = None
        if diag:
            if len(self.shape) != 2 or self.shape[0] != self.shape[1]:
                raise ValueError('diag requires a square matrix parameter')
        if sparsity is not None:
            rows, cols = np.asarray(sparsity[0], dtype=int), np.asarray(sparsity[1], dtype=int)
            order = np.lexsort((rows, cols))  # column-major order
            self.attributes['sparsity'] = (rows[order], cols[order])
            self.sparse_idx = (rows, cols)

    @property
    def flat_size(self):
        """Number of theta entries contributed by this parameter."""
        if self.attributes['diag']:
            return self.shape[0]
        if self.attributes['sparsity'] is not None:
            return len(self.attributes['sparsity'][0])
        return self.size

    def flat_entry_coords(self):
        """(rows, cols) of the theta entries inside the dense parameter,
        column-major order; None for full dense (all entries, F-order)."""
        if self.attributes['diag']:
            idx = np.arange(self.shape[0])
            return idx, idx
        if self.attributes['sparsity'] is not None:
            return self.attributes['sparsity']
        return None

    def flatten_value(self, v=None):
        """Map a user-facing dense value to its theta entries (F-order),
        mirroring templates/cpg_solver.py.jinja2:26-34 get_param_value."""
        v = self._value if v is None else np.asarray(v, dtype=float)
        if v is None:
            raise ValueError(f'Parameter {self.name_str} has no value')
        v = np.asarray(v, dtype=float).reshape(self.shape)
        coords = self.flat_entry_coords()
        if coords is None:
            return np.ravel(v, order='F')
        return v[coords[0], coords[1]] if v.ndim == 2 else v[coords[0]]

    def curvature(self):
        return CONSTANT

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self._value = None if v is None else np.asarray(v, dtype=float).reshape(self.shape)

    @property
    def value_sparse(self):
        return self._value

    @value_sparse.setter
    def value_sparse(self, v):
        self._value = np.asarray(v.todense(), dtype=float).reshape(self.shape)


class Constant(Expression):
    args = []

    def __init__(self, value):
        if spa.issparse(value):
            value = np.asarray(value.todense())
        self._value = np.asarray(value, dtype=float)
        if self._value.ndim > 2:
            raise ValueError('Only scalars, vectors and matrices supported')
        self.shape = self._value.shape

    def curvature(self):
        return CONSTANT

    def sign(self):
        if np.all(self._value >= 0):
            return SIGN_ZERO if np.all(self._value == 0) else SIGN_POS
        if np.all(self._value <= 0):
            return SIGN_NEG
        return SIGN_UNKNOWN

    @property
    def value(self):
        return self._value


# ---------------------------------------------------------------------------
# Core affine operations
# ---------------------------------------------------------------------------

class AddExpression(Expression):
    def __init__(self, a, b):
        self.args = [a, b]
        self.shape = broadcast_shapes(a.shape, b.shape)

    def curvature(self):
        return curv_add(self.args[0].curvature(), self.args[1].curvature())

    def sign(self):
        return sign_add(self.args[0].sign(), self.args[1].sign())

    def numeric(self, values):
        return values[0] + values[1]


class Negate(Expression):
    def __init__(self, a):
        self.args = [a]
        self.shape = a.shape

    def curvature(self):
        return curv_neg(self.args[0].curvature())

    def sign(self):
        return sign_neg(self.args[0].sign())

    def numeric(self, values):
        return -values[0]


class Multiply(Expression):
    """Elementwise (or scalar-broadcast) product; at most one side may
    depend on variables, and at most one side on parameters (DPP)."""

    def __init__(self, a, b):
        a, b = to_expr(a), to_expr(b)
        if not a.is_constant() and not b.is_constant():
            raise ValueError('multiply: at least one factor must be variable-free')
        self.args = [a, b]
        self.shape = broadcast_shapes(a.shape, b.shape)

    def curvature(self):
        a, b = self.args
        cf, other = (a, b) if a.is_constant() else (b, a)
        oc = other.curvature()
        if oc in (CONSTANT, AFFINE):
            return oc
        if cf.is_nonneg():
            return oc
        if cf.is_nonpos():
            return curv_neg(oc)
        return UNKNOWN

    def sign(self):
        return sign_mul(self.args[0].sign(), self.args[1].sign())

    def numeric(self, values):
        return values[0] * values[1]


class MatMul(Expression):
    def __init__(self, a, b):
        a, b = to_expr(a), to_expr(b)
        if not a.is_constant() and not b.is_constant():
            raise ValueError('matmul: at least one factor must be variable-free')
        self.args = [a, b]
        self.shape = matmul_shape(a.shape, b.shape)

    def curvature(self):
        a, b = self.args
        cf, other = (a, b) if a.is_constant() else (b, a)
        oc = other.curvature()
        if oc in (CONSTANT, AFFINE):
            return oc
        if cf.is_nonneg():
            return oc
        if cf.is_nonpos():
            return curv_neg(oc)
        return UNKNOWN

    def sign(self):
        return sign_mul(self.args[0].sign(), self.args[1].sign())

    def numeric(self, values):
        return values[0] @ values[1]


class Index(Expression):
    def __init__(self, a, key):
        self.args = [a]
        self.key = key if isinstance(key, tuple) else (key,)
        probe = np.empty(a.shape)
        self.shape = np.asarray(probe[key]).shape
        # index arrays: flat positions (F-order) selected from the argument
        idx = np.arange(a.size).reshape(a.shape, order='F')
        self.flat_idx = np.ravel(np.asarray(idx[key]), order='F')

    def curvature(self):
        return self.args[0].curvature()

    def sign(self):
        return self.args[0].sign()

    def numeric(self, values):
        return values[0][tuple(self.key)] if len(self.key) > 1 else values[0][self.key[0]]


class Transpose(Expression):
    def __init__(self, a):
        self.args = [a]
        self.shape = tuple(reversed(a.shape))

    def curvature(self):
        return self.args[0].curvature()

    def sign(self):
        return self.args[0].sign()

    def numeric(self, values):
        return values[0].T


class Reshape(Expression):
    """F-order reshape (CVXPY default order='F')."""

    def __init__(self, a, shape):
        self.args = [a]
        self.shape = _canon_shape(shape)
        if shape_size(self.shape) != a.size:
            raise ValueError('reshape size mismatch')

    def curvature(self):
        return self.args[0].curvature()

    def sign(self):
        return self.args[0].sign()

    def numeric(self, values):
        return np.reshape(values[0], self.shape, order='F')


class Promote(Expression):
    """Broadcast a scalar to a shape."""

    def __init__(self, a, shape):
        assert a.is_scalar()
        self.args = [a]
        self.shape = _canon_shape(shape)

    def curvature(self):
        return self.args[0].curvature()

    def sign(self):
        return self.args[0].sign()

    def numeric(self, values):
        return np.broadcast_to(np.asarray(values[0]).reshape(()), self.shape)
