"""Cone layout, batched torch cone projections and their float64 NumPy
twins.

Port of the JAX package's ``ops/cones.py``.  The batched torch projections
(``project_cone``, ``project_dual_cone``, ``in_dual_cone_violation``) run
inside the conic ADMM (solvers/conic_admm.py); they follow the reference's
arithmetic step by step, with fixed trip counts for the exp (64) and power
(60) root finds and the same clipping, so that float64 iteration counts
downstream match.  The NumPy half serves the modeling layer
(constraints.py), solution retrieval (canon/canonicalizer.py) and the
float64 oracle (solvers/oracle.py).

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
import torch

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
# torch projections (batched over the leading axes)
# ---------------------------------------------------------------------------

def _proj_soc_block(v):
    """v (..., d) -> projection onto SOC (t first)."""
    t, x = v[..., 0], v[..., 1:]
    nx = torch.linalg.norm(x, dim=-1)
    inside = nx <= t
    below = nx <= -t          # polar: projection is 0
    coef = torch.where(below, 0.0,
                       0.5 * (1.0 + t / torch.clamp(nx, min=1e-30)))
    t_new = torch.where(inside, t, coef * nx)
    x_new = torch.where(inside[..., None], x, coef[..., None] * x)
    t_new = torch.where(below, 0.0, t_new)
    return torch.cat([t_new[..., None], x_new], dim=-1)


def _exp_h(alpha, v1, v2, v3):
    """Friberg's univariate optimality function h(alpha) with
    x2(alpha) = (v1 (alpha-1) + v2) / (alpha^2 - alpha + 1)  (primal y-comp)
    g(alpha)  = (v1 - alpha v2)   / (alpha^2 - alpha + 1)  (= mu e^alpha)
    h = x2 e^alpha - g e^{-alpha} - v3; root <=> projection onto the exp-cone
    boundary.  Valid where x2 > 0 and g > 0."""
    den = alpha * alpha - alpha + 1.0          # >= 3/4 always
    x2 = (v1 * (alpha - 1.0) + v2) / den
    g = (v1 - alpha * v2) / den
    ea = torch.exp(torch.clamp(alpha, -60.0, 60.0))
    return x2 * ea - g / ea - v3, x2, g, ea


def _safe_exp(x):
    return torch.exp(torch.clamp(x, -60.0, 60.0))


def _proj_exp_block(v, n_iter=64):
    """v (..., 3) -> projection onto the exponential cone (batched).

    Case analysis (SCS's proj_exp_cone and Friberg 2023):
      1. v in K_exp                      -> v
      2. v in polar (-v in K_exp^*)      -> 0
      3. v1 <= 0 and v2 <= 0             -> (v1, 0, max(v3, 0))
      4. else: bisection (fixed n_iter) on h over the feasible alpha-window
         where the primal y-component and the multiplier are positive.
    Scale-invariance (proj(c v) = c proj(v)) normalizes v first, so all
    root finding happens on O(1) numbers."""
    nrm = torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    w = v / nrm
    r, s, t = w[..., 0], w[..., 1], w[..., 2]

    tol = 1e-7
    in_K = ((s > 0) & (s * _safe_exp(r / torch.where(s > 0, s, 1.0))
                       <= t + tol)) \
        | ((torch.abs(s) <= tol) & (r <= tol) & (t >= -tol))
    # polar: -w in K*;  K* = cl{(u1,u2,u3): u1<0, -u1 e^{u2/u1} <= e u3}
    u1, u2, u3 = -r, -s, -t
    in_polar = ((u1 < 0) & (-u1 * _safe_exp(u2 / torch.where(u1 < 0, u1, -1.0))
                            <= math.e * u3 + tol)) \
        | ((torch.abs(u1) <= tol) & (u2 >= -tol) & (u3 >= -tol))
    third = (r <= 0) & (s <= 0)

    # case 4: bisection window from x2 > 0 and mu > 0
    AMAX = 30.0
    # x2 > 0:  v1 * alpha > v1 - v2
    lo_x2 = torch.where(r > 0, 1.0 - s / torch.where(r > 0, r, 1.0), -AMAX)
    hi_x2 = torch.where(r < 0, 1.0 - s / torch.where(r < 0, r, -1.0), AMAX)
    # mu > 0:  alpha * v2 < v1
    hi_mu = torch.where(s > 0, r / torch.where(s > 0, s, 1.0), AMAX)
    lo_mu = torch.where(s < 0, r / torch.where(s < 0, s, -1.0), -AMAX)
    lo = torch.clamp(torch.maximum(lo_x2, lo_mu), -AMAX, AMAX)
    hi = torch.clamp(torch.minimum(hi_x2, hi_mu), -AMAX, AMAX)
    eps_w = 1e-6 * (hi - lo)
    lo = lo + eps_w
    hi = hi - eps_w

    sign_lo = torch.sign(_exp_h(lo, r, s, t)[0])
    a, b = lo, hi
    for _ in range(n_iter):
        mid = 0.5 * (a + b)
        # root in [a, mid] iff sign(h_lo) != sign(h_mid); h increasing
        # through the root is not guaranteed, so bracket on sign-vs-h(lo)
        go_left = torch.sign(_exp_h(mid, r, s, t)[0]) != sign_lo
        a, b = torch.where(go_left, a, mid), torch.where(go_left, mid, b)
    alpha = 0.5 * (a + b)
    _, x2, _, ea = _exp_h(alpha, r, s, t)
    x2 = torch.clamp(x2, min=0.0)
    x = torch.stack([alpha * x2, x2, x2 * ea], dim=-1)
    # face candidate (min(r,0), 0, max(t,0)): the projection when the true
    # root lies at |alpha| -> inf (window empty or clipped); both candidates
    # are feasible, so the closer one is the better approximation
    face = torch.stack([torch.clamp(r, max=0.0), torch.zeros_like(s),
                        torch.clamp(t, min=0.0)], dim=-1)
    d_root = torch.sum((x - w) ** 2, dim=-1)
    d_face = torch.sum((face - w) ** 2, dim=-1)
    use_face = (b - a <= 0) | (d_face < d_root)
    x = torch.where(use_face[..., None], face, x)

    out = torch.where(third[..., None], face, x)
    out = torch.where(in_polar[..., None], 0.0, out)
    out = torch.where(in_K[..., None], w, out)
    return out * nrm


def _proj_pow_block(v, a, n_iter=60):
    """v (..., 3) -> projection onto the 3D power cone
    K_a = {(x, y, z): x^a y^(1-a) >= |z|, x, y >= 0}   (0 < a < 1).

    Hien ("Differential properties of Euclidean projection onto power
    cone", 2015): for v outside K_a and its polar with v3 != 0, the
    projection is x = (x1(r), x2(r), sign(v3) r) with
        x_i(r) = (v_i + sqrt(v_i^2 + 4 a_i r(|v3| - r))) / 2
    and r in (0, |v3|) the root of Phi(r) = x1^a x2^(1-a) - r
    (bisection: Phi >= 0 at 0+, < 0 at |v3|)."""
    r0, s0, t0 = v[..., 0], v[..., 1], v[..., 2]
    at = torch.abs(t0)
    tol = 1e-9

    def powa(x, y):
        # x^a y^(1-a) with clamping for x, y >= 0
        return (torch.clamp(x, min=0.0) ** a
                * torch.clamp(y, min=0.0) ** (1.0 - a))

    in_K = (r0 >= -tol) & (s0 >= -tol) & (powa(r0, s0) >= at - tol)
    # polar = -K*; K* = {(u,v,w): (u/a)^a (v/(1-a))^(1-a) >= |w|, u,v >= 0}
    in_polar = (r0 <= tol) & (s0 <= tol) \
        & (powa(-r0 / a, -s0 / (1.0 - a)) >= at - tol)
    degenerate = at <= tol  # v3 ~ 0: projection is (v1+, v2+, 0)

    def xi(vi, ai, rr):
        return 0.5 * (vi + torch.sqrt(vi * vi + 4.0 * ai * rr * (at - rr)))

    lo = torch.full_like(at, 1e-12) * torch.clamp(at, min=1.0)
    hi = at * (1.0 - 1e-7)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        pos = powa(xi(r0, a, mid), xi(s0, 1.0 - a, mid)) - mid >= 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    rr = 0.5 * (lo + hi)
    x = torch.stack([xi(r0, a, rr), xi(s0, 1.0 - a, rr),
                     torch.sign(t0) * rr], dim=-1)

    face = torch.stack([torch.clamp(r0, min=0.0), torch.clamp(s0, min=0.0),
                        torch.zeros_like(t0)], dim=-1)
    out = torch.where(degenerate[..., None], face, x)
    out = torch.where(in_polar[..., None], 0.0, out)
    return torch.where(in_K[..., None], v, out)


def _proj_psd_block(w, s):
    """w (..., s(s+1)/2) svec -> projection onto the PSD cone (eigh)."""
    r, c, sc = svec_indices(s)
    r = torch.as_tensor(r, device=w.device)
    c = torch.as_tensor(c, device=w.device)
    sc = torch.as_tensor(sc, dtype=w.dtype, device=w.device)
    vals = w / sc
    X = torch.zeros(w.shape[:-1] + (s, s), dtype=w.dtype, device=w.device)
    X[..., r, c] = vals
    X[..., c, r] = vals
    lam, Q = torch.linalg.eigh(X)
    lam = torch.clamp(lam, min=0.0)
    Xp = torch.einsum('...ik,...k,...jk->...ij', Q, lam, Q)
    return Xp[..., r, c] * sc


def project_cone(v, layout: ConeLayout):
    """v (B, mc) -> projection onto K (rows laid out per `layout`)."""
    parts = []
    for kind, off, length, extra in layout.blocks():
        blk = v[:, off:off + length]
        if kind == 'nonneg':
            parts.append(torch.clamp(blk, min=0.0))
        elif kind == 'soc':
            parts.append(_proj_soc_block(blk))
        elif kind == 'exp':
            tri = blk.reshape(blk.shape[0], extra, 3)
            parts.append(_proj_exp_block(tri).reshape(blk.shape[0], length))
        elif kind == 'psd':
            parts.append(_proj_psd_block(blk, extra))
        else:  # pow
            parts.append(_proj_pow_block(blk, extra))
    if not parts:
        return v[:, :0]
    return torch.cat(parts, dim=1)


def project_dual_cone(v, layout: ConeLayout):
    """Projection onto K^* via Moreau: Pi_{K*}(v) = v + Pi_K(-v)."""
    return v + project_cone(-v, layout)


def in_dual_cone_violation(v, layout: ConeLayout):
    """Distance-to-dual-cone per instance: ||v - Pi_{K*}(v)||_inf."""
    d = v - project_dual_cone(v, layout)
    if not d.shape[-1]:
        return torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
    return torch.amax(torch.abs(d), dim=-1)


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
