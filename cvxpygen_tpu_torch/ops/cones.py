"""Cone layout and float64 NumPy cone projections (oracle / offline use).

The NumPy half of the JAX package's ``ops/cones.py``: the modeling layer
(constraints.py), solution retrieval (canon/canonicalizer.py) and the
float64 oracle (solvers/oracle.py) call these.  The batched torch
projections arrive with the conic ADMM slice of the port.

Row-layout convention (canon/canonicalizer.py): constraint rows are grouped
    [zero | nonneg | SOC blocks | exp triples | PSD svec blocks | pow triples]
Zero rows are equalities and are handled by the consumer, so `ConeLayout`
covers the rows from `nonneg` on.

svec convention for an s x s symmetric matrix: upper triangle, column-major,
off-diagonal entries scaled by sqrt(2) (an isometry, so projection commutes
with svec).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

_SQRT2 = math.sqrt(2.0)


@dataclass(frozen=True)
class ConeLayout:
    """Static cone layout (hashable: usable as a jit static argument).
    Row groups in order: nonneg | SOC | EXP triples | PSD svec | POW triples
    (pows = tuple of alpha exponents, one 3D power cone each)."""
    n_nonneg: int = 0
    socs: Tuple[int, ...] = ()
    n_exp: int = 0
    psds: Tuple[int, ...] = ()
    pows: Tuple[float, ...] = ()

    @property
    def total(self) -> int:
        return (self.n_nonneg + int(sum(self.socs)) + 3 * self.n_exp
                + int(sum(s * (s + 1) // 2 for s in self.psds))
                + 3 * len(self.pows))

    @property
    def has_exp(self) -> bool:
        return self.n_exp > 0

    @property
    def has_psd(self) -> bool:
        return len(self.psds) > 0

    def blocks(self):
        """Yield (kind, offset, length, extra) per cone block."""
        off = 0
        if self.n_nonneg:
            yield ('nonneg', 0, self.n_nonneg, None)
            off = self.n_nonneg
        for d in self.socs:
            yield ('soc', off, d, None)
            off += d
        if self.n_exp:
            yield ('exp', off, 3 * self.n_exp, self.n_exp)
            off += 3 * self.n_exp
        for s in self.psds:
            k = s * (s + 1) // 2
            yield ('psd', off, k, s)
            off += k
        for a in self.pows:
            yield ('pow', off, 3, a)
            off += 3


def svec_indices(s: int):
    """(rows, cols) of the upper triangle in svec (column-major) order,
    plus the sqrt(2) scale vector."""
    rows, cols, scale = [], [], []
    for j in range(s):
        for i in range(j + 1):
            rows.append(i)
            cols.append(j)
            scale.append(1.0 if i == j else _SQRT2)
    return (np.asarray(rows), np.asarray(cols),
            np.asarray(scale, dtype=np.float64))


def svec_np(X):
    """svec of a symmetric matrix (float64 NumPy)."""
    s = X.shape[-1]
    r, c, sc = svec_indices(s)
    return X[..., r, c] * sc


def unsvec_np(w, s):
    r, c, sc = svec_indices(s)
    X = np.zeros(w.shape[:-1] + (s, s))
    vals = w / sc
    X[..., r, c] = vals
    X[..., c, r] = vals
    return X


# ---------------------------------------------------------------------------
# JAX projections


# ---------------------------------------------------------------------------
# NumPy float64 twins (oracle / offline use)
# ---------------------------------------------------------------------------

def _proj_soc_np(v):
    t, x = v[0], v[1:]
    nx = np.linalg.norm(x)
    if nx <= t:
        return v.copy()
    if nx <= -t:
        return np.zeros_like(v)
    coef = 0.5 * (1.0 + t / nx)
    out = np.empty_like(v)
    out[0] = coef * nx
    out[1:] = coef * x
    return out


def _proj_exp_np(v, n_iter=90):
    v = np.asarray(v, dtype=np.float64)
    nrm = max(np.linalg.norm(v), 1e-300)
    r, s, t = v / nrm
    tol = 1e-12

    def safe_exp(x):
        return math.exp(min(max(x, -700.0), 700.0))

    if (s > 0 and s * safe_exp(r / s) <= t + tol) or \
       (abs(s) <= tol and r <= tol and t >= -tol):
        return v.copy()
    u1, u2, u3 = -r, -s, -t
    if (u1 < 0 and -u1 * safe_exp(u2 / u1) <= math.e * u3 + tol) or \
       (abs(u1) <= tol and u2 >= -tol and u3 >= -tol):
        return np.zeros(3)
    face = np.array([min(r, 0.0), 0.0, max(t, 0.0)])
    if r <= 0 and s <= 0:
        return face * nrm

    AMAX = 60.0
    lo = -AMAX if r <= 0 else max(-AMAX, 1.0 - s / r)
    hi = AMAX if r >= 0 else min(AMAX, 1.0 - s / r)
    if s > 0:
        hi = min(hi, r / s)
    elif s < 0:
        lo = max(lo, r / s)
    eps_w = 1e-9 * max(hi - lo, 0.0)
    lo, hi = lo + eps_w, hi - eps_w

    def h(alpha):
        den = alpha * alpha - alpha + 1.0
        x2 = (r * (alpha - 1.0) + s) / den
        g = (r - alpha * s) / den
        ea = safe_exp(alpha)
        return x2 * ea - g / ea - t, x2, ea

    vn = np.array([r, s, t])
    if hi <= lo:
        return face * nrm
    h_lo = h(lo)[0]
    a, b = lo, hi
    for _ in range(n_iter):
        mid = 0.5 * (a + b)
        hm = h(mid)[0]
        if np.sign(hm) != np.sign(h_lo):
            b = mid
        else:
            a = mid
    alpha = 0.5 * (a + b)
    _, x2, ea = h(alpha)
    x2 = max(x2, 0.0)
    x = np.array([alpha * x2, x2, x2 * ea])
    # face candidate wins when the true root lies beyond the clipped window
    if np.sum((face - vn) ** 2) < np.sum((x - vn) ** 2):
        x = face
    return x * nrm


def _proj_pow_np(v, a, n_iter=90):
    v = np.asarray(v, dtype=np.float64)
    r0, s0, t0 = v
    at = abs(t0)
    tol = 1e-12

    def powa(x, y):
        return max(x, 0.0) ** a * max(y, 0.0) ** (1.0 - a)

    if r0 >= -tol and s0 >= -tol and powa(r0, s0) >= at - tol:
        return v.copy()
    if r0 <= tol and s0 <= tol and \
            powa(-r0 / a, -s0 / (1.0 - a)) >= at - tol:
        return np.zeros(3)
    if at <= tol:
        return np.array([max(r0, 0.0), max(s0, 0.0), 0.0])

    def xi(vi, ai, rr):
        return 0.5 * (vi + math.sqrt(vi * vi + 4.0 * ai * rr * (at - rr)))

    def phi(rr):
        return powa(xi(r0, a, rr), xi(s0, 1.0 - a, rr)) - rr

    aa, bb = 1e-14 * max(at, 1.0), at * (1.0 - 1e-9)
    for _ in range(n_iter):
        mid = 0.5 * (aa + bb)
        if phi(mid) >= 0:
            aa = mid
        else:
            bb = mid
    rr = 0.5 * (aa + bb)
    return np.array([xi(r0, a, rr), xi(s0, 1.0 - a, rr),
                     math.copysign(rr, t0)])


def _proj_psd_np(w, s):
    X = unsvec_np(w, s)
    lam, Q = np.linalg.eigh(X)
    lam = np.maximum(lam, 0.0)
    Xp = (Q * lam) @ Q.T
    return svec_np(Xp)


def project_cone_np(v, layout: ConeLayout):
    """Unbatched float64 projection (oracle twin of project_cone)."""
    v = np.asarray(v, dtype=np.float64)
    out = np.empty_like(v)
    for kind, off, length, extra in layout.blocks():
        blk = v[off:off + length]
        if kind == 'nonneg':
            out[off:off + length] = np.maximum(blk, 0.0)
        elif kind == 'soc':
            out[off:off + length] = _proj_soc_np(blk)
        elif kind == 'exp':
            for k in range(extra):
                out[off + 3 * k:off + 3 * k + 3] = _proj_exp_np(
                    blk[3 * k:3 * k + 3])
        elif kind == 'psd':
            out[off:off + length] = _proj_psd_np(blk, extra)
        else:
            out[off:off + length] = _proj_pow_np(blk, extra)
    return out


def project_dual_cone_np(v, layout: ConeLayout):
    return v + project_cone_np(-np.asarray(v, dtype=np.float64), layout)
