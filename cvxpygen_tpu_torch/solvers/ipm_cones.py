"""Exotic-cone (exponential / 3D power / PSD) calculus for the conic IPM.

Port of the JAX package's ``solvers/ipm_cones.py``: it extends
solvers/ipm.py beyond the symmetric (nonneg/SOC) cones so the IPM engine
covers the reference Clarabel interface's full cone list (reference
cvxpygen/solvers/clarabel.py:133-155: zero/nonneg/SOC/exp/PSD/pow).

Method (the nonsymmetric IPM of ECOS-exp / MOSEK, Serrano 2015; Dahl &
Andersen 2021):

- For each nonsymmetric cone block the KKT scaling is the dual-barrier
  Hessian H = mu grad^2 F*(z) (3x3 dense for exp/pow), or the two-secant
  primal-dual scaling built from it.  The JAX package takes the barriers'
  gradients and Hessians from autodiff; here they are written out in
  closed form (``_exp_dual_derivs``, ``_pow_derivs``), the same functions.
- PSD blocks use the Nesterov-Todd scaling point W (matrix geometric mean
  of S and Z, by eigh): H svec(M) = svec(W M W).
- Complementarity RHS for these blocks (H-form):
      affine    ds = -s - H dz
      combined  ds = -s - H dz - sigma mu grad F*(z)
- Step length to the boundary: batched bisection on strict cone membership
  for exp/pow; PSD uses the closed form 1/max(0, -lambda_min(S^-1/2 dS
  S^-1/2)).

Conventions (ops/cones.py):
    EXP      K = cl{(x,y,z): y>0, y e^{x/y} <= z}
    EXP dual K* = cl{(u,v,w): u<0, -u e^{v/u} <= e w}
             barrier F*(u,v,w) = -log(v - u + u log(-u/w)) - log(-u) - log(w)
    POW(a)   K = {(x,y,z): x^a y^(1-a) >= |z|, x,y >= 0}
    POW dual K* = {(u,v,w): (u/a)^a (v/(1-a))^(1-a) >= |w|}
             barrier F*(u,v,w) = F_pow(u/a, v/(1-a), w) with
             F_pow(x,y,z) = -log(x^{2a} y^{2(1-a)} - z^2)
                            - (1-a) log x - a log y
    PSD(s)   svec (upper triangle, column-major, sqrt(2) off-diag)

Exotic rows sit after the symmetric rows:
    [nonneg | SOC | EXP triples | PSD svec blocks | POW triples].
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.cones import svec_indices

_BIG = 1e20
# PD/dual crossover (see _pd_scaling_full): blocks with
# det(S'Z)/(s'z s~'z~) below this use the plain dual scaling, above it the
# two-secant primal-dual scaling.  Environment override for
# experimentation only, as in the JAX package.
_PD_THRESH = float(os.environ.get('CPG_PD_THRESH', '0.1'))


@dataclass(frozen=True)
class ExoticCones:
    """Static exotic-cone layout."""
    n_exp: int = 0
    psd_dims: Tuple[int, ...] = ()
    pow_alphas: Tuple[float, ...] = ()

    @property
    def dim(self) -> int:
        return (3 * self.n_exp
                + int(sum(s * (s + 1) // 2 for s in self.psd_dims))
                + 3 * len(self.pow_alphas))

    @property
    def degree(self) -> int:
        """Barrier degree: 3 per exp/pow cone, s per PSD(s) block."""
        return (3 * self.n_exp + int(sum(self.psd_dims))
                + 3 * len(self.pow_alphas))

    def __bool__(self):
        return bool(self.n_exp or self.psd_dims or self.pow_alphas)

    @property
    def psd_off(self) -> int:
        return 3 * self.n_exp

    @property
    def pow_off(self) -> int:
        return self.psd_off + int(sum(s * (s + 1) // 2
                                      for s in self.psd_dims))

    def blocks(self):
        """(start, length) of every exotic block within the exotic rows."""
        out = []
        off = 0
        for _ in range(self.n_exp):
            out.append((off, 3))
            off += 3
        for s in self.psd_dims:
            k = s * (s + 1) // 2
            out.append((off, k))
            off += k
        for _ in self.pow_alphas:
            out.append((off, 3))
            off += 3
        return out


# ---------------------------------------------------------------------------
# barrier derivatives (closed form)
# ---------------------------------------------------------------------------

def _sym3(h00, h01, h02, h11, h12, h22):
    """(N, 3, 3) symmetric matrices from their six distinct entries."""
    r0 = torch.stack([h00, h01, h02], dim=-1)
    r1 = torch.stack([h01, h11, h12], dim=-1)
    r2 = torch.stack([h02, h12, h22], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def _exp_dual_derivs(z):
    """Gradient (N, 3) and Hessian (N, 3, 3) of the exp dual barrier
    F*(u,v,w) = -log t - log(-u) - log w,  t = v - u + u log(-u/w)."""
    u, v, w = z[:, 0], z[:, 1], z[:, 2]
    lg = torch.log(-u / w)
    t = v - u + u * lg
    tu, tw = lg, -u / w                      # grad t = (lg, 1, -u/w)
    g = torch.stack([-tu / t - 1.0 / u, -1.0 / t, -tw / t - 1.0 / w], dim=1)
    t2 = t * t
    # grad t grad t' / t^2 - hess t / t + diag(1/u^2, 0, 1/w^2), with
    # t_uu = 1/u, t_uw = -1/w, t_ww = u/w^2
    H = _sym3(tu * tu / t2 - (1.0 / u) / t + 1.0 / (u * u),
              tu / t2,
              tu * tw / t2 + (1.0 / w) / t,
              1.0 / t2,
              tw / t2,
              tw * tw / t2 - (u / (w * w)) / t + 1.0 / (w * w))
    return g, H


def _exp_primal_grad(s):
    """Gradient (N, 3) of the exp primal barrier
    F(x,y,z) = -log(y log(z/y) - x) - log y - log z."""
    x, y, zz = s[:, 0], s[:, 1], s[:, 2]
    lg = torch.log(zz / y)
    r = y * lg - x                           # grad r = (-1, lg - 1, y/z)
    return torch.stack([1.0 / r, -(lg - 1.0) / r - 1.0 / y,
                        -(y / zz) / r - 1.0 / zz], dim=1)


def _pow_derivs(x, y, zz, a, hess=True):
    """Gradient (N, 3) and Hessian (N, 3, 3) of the Chares barrier
    F(x,y,z) = -log(x^{2a} y^{2(1-a)} - z^2) - (1-a) log x - a log y."""
    ep = torch.exp(2.0 * (a * torch.log(x) + (1.0 - a) * torch.log(y)))
    psi = ep - zz * zz
    px, py, pz = 2.0 * a * ep / x, 2.0 * (1.0 - a) * ep / y, -2.0 * zz
    g = torch.stack([-px / psi - (1.0 - a) / x, -py / psi - a / y,
                     -pz / psi], dim=1)
    if not hess:
        return g, None
    p2 = psi * psi
    pxx = 2.0 * a * (2.0 * a - 1.0) * ep / (x * x)
    pxy = 4.0 * a * (1.0 - a) * ep / (x * y)
    pyy = 2.0 * (1.0 - a) * (1.0 - 2.0 * a) * ep / (y * y)
    H = _sym3(px * px / p2 - pxx / psi + (1.0 - a) / (x * x),
              px * py / p2 - pxy / psi,
              px * pz / p2,
              py * py / p2 - pyy / psi + a / (y * y),
              py * pz / p2,
              pz * pz / p2 + 2.0 / psi)
    return g, H


def _pow_dual_derivs(z3, a):
    """Gradient and Hessian of the pow dual barrier F_pow(u/a, v/(1-a), w)
    (chain rule through the diagonal coordinate scaling)."""
    g, H = _pow_derivs(z3[:, 0] / a, z3[:, 1] / (1.0 - a), z3[:, 2], a)
    sc = torch.tensor([1.0 / a, 1.0 / (1.0 - a), 1.0], dtype=z3.dtype,
                      device=z3.device)
    return g * sc, H * sc[:, None] * sc[None, :]


def _pow_primal_grad(s3, a):
    return _pow_derivs(s3[:, 0], s3[:, 1], s3[:, 2], a, hess=False)[0]


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _sanitize_blocks(H, g, s3, z3, mu_floor=None):
    """Replace non-finite (or overflowing) 3x3 scaling blocks / gradients
    with the finite SPD fallback H = (s'z/3) I, -grad F*(z) = 3 s / s'z:
    a centering-flavoured direction that re-enters the neighbourhood
    (float32 iterates ~1e-12 from the cone boundary overflow the barrier
    Hessian products)."""
    big = float(torch.finfo(H.dtype).eps) ** -1.5
    bad = ~(torch.all(torch.isfinite(H).flatten(1), dim=1)
            & torch.all(torch.isfinite(g), dim=1)
            & (torch.amax(torch.abs(H), dim=(1, 2)) < big)
            & (torch.amax(torch.abs(g), dim=1) < big))
    mu_b = torch.sum(s3 * z3, dim=1) / 3.0
    if mu_floor is not None:
        mu_b = torch.maximum(mu_b, 0.01 * mu_floor)
    mu_b = torch.clamp(mu_b, min=100 * float(torch.finfo(H.dtype).eps) ** 2)
    H = torch.where(bad[:, None, None], mu_b[:, None, None] * _eye3(H)[None],
                    H)
    g = torch.where(bad[:, None], -s3 / mu_b[:, None], g)
    return H, g


def _pd_scaling_full(s3, z3, g, h, zt):
    """Two-secant primal-dual scaling of a 3-dim nonsymmetric block (Dahl &
    Andersen 2021): H > 0 with H z = s and H z~ = s~ (s~ = -g), built as
    H = S M^{-1} S' + (I - S M^{-1} Z') T (I - Z M^{-1} S'),  T = mu h,
    M = S'Z; near the central path (det M / (s'z s~'z~) below the
    crossover) the block keeps T, the exact scaling there."""
    nu = 3.0
    s_t = -g
    a11 = torch.sum(s3 * z3, dim=1)
    mu_loc = a11 / nu
    T = mu_loc[:, None, None] * h
    a22 = torch.sum(s_t * zt, dim=1)
    det = a11 * a22 - nu * nu
    ok = ((det > _PD_THRESH * torch.clamp(a11 * a22, min=1e-30))
          & torch.isfinite(det) & torch.all(torch.isfinite(zt), dim=1))
    dsafe = torch.where(ok, det, torch.ones_like(det))
    S = torch.stack([s3, s_t], dim=2)              # (N, 3, 2)
    Z = torch.stack([z3, zt], dim=2)
    nu_col = -nu * torch.ones_like(a11)
    Minv = torch.stack([torch.stack([a22, nu_col], dim=1),
                        torch.stack([nu_col, a11], dim=1)],
                       dim=1) / dsafe[:, None, None]
    SMi = torch.matmul(S, Minv)                    # S M^{-1} (N, 3, 2)
    H1 = torch.matmul(SMi, S.transpose(1, 2))
    Pm = _eye3(s3)[None] - torch.matmul(SMi, Z.transpose(1, 2))
    H2 = torch.einsum('nik,nkl,njl->nij', Pm, T, Pm)
    Hpd = H1 + H2
    Hpd = 0.5 * (Hpd + Hpd.transpose(1, 2))
    return torch.where(ok[:, None, None], Hpd, T)


# ---------------------------------------------------------------------------
# svec helpers (PSD blocks)
# ---------------------------------------------------------------------------

def _svec_idx(s, like):
    r, c, sc = svec_indices(s)
    return (torch.as_tensor(r, device=like.device),
            torch.as_tensor(c, device=like.device),
            torch.as_tensor(sc, dtype=like.dtype, device=like.device))


def _svec_to_mat(w, s):
    """w (..., k) svec -> symmetric matrix (..., s, s)."""
    r, c, sc = _svec_idx(s, w)
    vals = w / sc
    X = w.new_zeros(w.shape[:-1] + (s, s))
    X[..., r, c] = vals
    X[..., c, r] = vals
    return X


def _mat_to_svec(X, s):
    r, c, sc = _svec_idx(s, X)
    return X[..., r, c] * sc


def _psd_basis(s, like):
    """Constant (k, s, s) svec basis matrices: mat(e_j)."""
    r, c, sc = svec_indices(s)
    k = len(r)
    E = np.zeros((k, s, s))
    for j in range(k):
        E[j, r[j], c[j]] = 1.0 / sc[j]
        E[j, c[j], r[j]] = 1.0 / sc[j]
    return torch.as_tensor(E, dtype=like.dtype, device=like.device)


def _mat_sqrt(X, inv=False):
    """Symmetric PSD matrix square root (or inverse square root) by eigh."""
    lam, Q = torch.linalg.eigh(X)
    lam = torch.clamp(lam, min=torch.finfo(X.dtype).tiny)
    p = -0.5 if inv else 0.5
    return torch.einsum('...ik,...k,...jk->...ij', Q, lam ** p, Q)


def _psd_nt_scaling(S, Z):
    """NT scaling point W with W Z W = S (matrix geometric mean)."""
    A = _mat_sqrt(S)
    M = A @ Z @ A
    return A @ _mat_sqrt(M, inv=True) @ A


# ---------------------------------------------------------------------------
# scaling state for the exotic blocks
# ---------------------------------------------------------------------------

class ExoticScaling:
    """Per-iteration scaling data: H blocks (and their inverses on demand)
    and dual-barrier gradients for the centering RHS.

    ``strategy``: 'pd' = two-secant primal-dual scaling (robust
    off-center), 'dual' = mu grad^2 F*(z) (accurate near the central
    path)."""

    def __init__(self, exo: ExoticCones, s_exo, z_exo, mu, strategy='pd'):
        self.exo = exo
        self.dtype = z_exo.dtype
        B = z_exo.shape[0]
        self.B = B
        ne = exo.n_exp
        self.H_exp = None
        self.g_exp = None
        if ne:
            zf = z_exo[:, :3 * ne].reshape(B * ne, 3)
            sf = s_exo[:, :3 * ne].reshape(B * ne, 3)
            g, h = _exp_dual_derivs(zf)
            mu_rep = torch.repeat_interleave(mu, ne)
            if strategy == 'pd':
                Hf = _pd_scaling_full(sf, zf, g, h, -_exp_primal_grad(sf))
            else:
                Hf = mu_rep[:, None, None] * h
            Hf, g = _sanitize_blocks(Hf, g, sf, zf, mu_floor=mu_rep)
            self.g_exp = g.reshape(B, ne, 3)
            self.H_exp = Hf.reshape(B, ne, 3, 3)
        self.W_psd = []
        off = exo.psd_off
        for s in exo.psd_dims:
            k = s * (s + 1) // 2
            Sm = _svec_to_mat(s_exo[:, off:off + k], s)
            Zm = _svec_to_mat(z_exo[:, off:off + k], s)
            self.W_psd.append(_psd_nt_scaling(Sm, Zm))
            off += k
        self.H_pow = []
        self.g_pow = []
        off = exo.pow_off
        for a in exo.pow_alphas:
            z3 = z_exo[:, off:off + 3]
            s3 = s_exo[:, off:off + 3]
            g, h = _pow_dual_derivs(z3, a)
            if strategy == 'pd':
                Hp = _pd_scaling_full(s3, z3, g, h, -_pow_primal_grad(s3, a))
            else:
                Hp = mu[:, None, None] * h
            Hp, g = _sanitize_blocks(Hp, g, s3, z3, mu_floor=mu)
            self.g_pow.append(g)
            self.H_pow.append(Hp)
            off += 3

    def centering_rhs(self, z_exo):
        """-grad F*(z) stacked over exotic rows (B, dim); PSD blocks use
        +svec(Z^{-1}) (= -grad F*(z) for the -log det barrier)."""
        exo = self.exo
        B = self.B
        parts = []
        if exo.n_exp:
            parts.append(-self.g_exp.reshape(B, 3 * exo.n_exp))
        off = exo.psd_off
        for s in exo.psd_dims:
            k = s * (s + 1) // 2
            Zi = torch.linalg.inv(_svec_to_mat(z_exo[:, off:off + k], s))
            Zi = 0.5 * (Zi + Zi.transpose(-1, -2))
            parts.append(_mat_to_svec(Zi, s))
            off += k
        for g in self.g_pow:
            parts.append(-g)
        return (torch.cat(parts, dim=1) if parts
                else z_exo.new_zeros((B, 0)))

    def apply(self, v_exo):
        """H v over the exotic rows (B, dim)."""
        exo = self.exo
        B = self.B
        parts = []
        if exo.n_exp:
            vf = v_exo[:, :3 * exo.n_exp].reshape(B, exo.n_exp, 3)
            parts.append(torch.einsum('bnij,bnj->bni', self.H_exp,
                                      vf).reshape(B, 3 * exo.n_exp))
        off = exo.psd_off
        for (s, W) in zip(exo.psd_dims, self.W_psd):
            k = s * (s + 1) // 2
            M = _svec_to_mat(v_exo[:, off:off + k], s)
            parts.append(_mat_to_svec(W @ M @ W, s))
            off += k
        off = exo.pow_off
        for Hp in self.H_pow:
            parts.append(torch.einsum('bij,bj->bi', Hp,
                                      v_exo[:, off:off + 3]))
            off += 3
        return (torch.cat(parts, dim=1) if parts
                else v_exo.new_zeros((B, 0)))

    def set_H(self, H, row0, inv=False):
        """Write the exotic diagonal blocks into the dense KKT H matrix
        (B, mc, mc) starting at row/col offset row0 (a new tensor)."""
        exo = self.exo
        B = self.B
        H = H.clone()
        if exo.n_exp:
            ne = exo.n_exp
            Hs = self.H_exp
            if inv:
                Hs = _inv33(Hs.reshape(B * ne, 3, 3)).reshape(Hs.shape)
            # every 3x3 block at once: entry (i, a, b) at row0 + 3 i + a,
            # row0 + 3 i + b
            blk = row0 + 3 * torch.arange(ne, device=H.device)
            ab = torch.arange(3, device=H.device)
            rows = (blk[:, None, None] + ab[None, :, None]).expand(ne, 3, 3)
            cols = (blk[:, None, None] + ab[None, None, :]).expand(ne, 3, 3)
            H[:, rows.reshape(-1), cols.reshape(-1)] = Hs.reshape(B, 9 * ne)
        off = row0 + exo.psd_off
        for (s, W) in zip(exo.psd_dims, self.W_psd):
            k = s * (s + 1) // 2
            Wu = torch.linalg.inv(W) if inv else W
            E = _psd_basis(s, W)
            T = torch.einsum('bpq,kqr,brs->bkps', Wu, E, Wu)
            blk = _mat_to_svec(T, s).transpose(1, 2)   # (B, k_row, k_col)
            H[:, off:off + k, off:off + k] = blk
            off += k
        off = row0 + exo.pow_off
        for Hp in self.H_pow:
            H[:, off:off + 3, off:off + 3] = _inv33(Hp) if inv else Hp
            off += 3
        return H


def _inv33(A):
    """Closed-form inverse of (..., 3, 3) matrices (adjugate / det): the
    adjugate's columns are the cross products of the rows."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c0 = torch.linalg.cross(r1, r2, dim=-1)
    adj = torch.stack([c0, torch.linalg.cross(r2, r0, dim=-1),
                       torch.linalg.cross(r0, r1, dim=-1)], dim=-1)
    det = torch.sum(r0 * c0, dim=-1)
    return adj / det[..., None, None]


# ---------------------------------------------------------------------------
# initialization, membership, step length, violation
# ---------------------------------------------------------------------------

# standard strictly-interior unit point of K_exp that also lies strictly
# inside K*_exp (ECOS/Hypatia choice); s' z = 3 so mu starts balanced
_EXP_INIT = (-1.051383945322714, 0.556409619469370, 1.258967884768947)


def exotic_init(B, exo: ExoticCones, dtype, device=None):
    """Strictly interior starting point, used for both s and z."""
    parts = []
    if exo.n_exp:
        e = torch.tensor(_EXP_INIT, dtype=dtype, device=device)
        parts.append(e.repeat(B, exo.n_exp))
    for s in exo.psd_dims:
        r, c, _ = svec_indices(s)
        ident = torch.tensor([1.0 if rr == cc else 0.0
                              for rr, cc in zip(r, c)], dtype=dtype,
                             device=device)
        parts.append(ident.repeat(B, 1))
    for a in exo.pow_alphas:
        p = torch.tensor([math.sqrt(1.0 + a), math.sqrt(2.0 - a), 0.0],
                         dtype=dtype, device=device)
        parts.append(p.repeat(B, 1))
    return (torch.cat(parts, dim=1) if parts
            else torch.zeros((B, 0), dtype=dtype, device=device))


def _exp_primal_in(s3):
    """(..., 3) -> strict interior of K_exp."""
    x, y, z = s3[..., 0], s3[..., 1], s3[..., 2]
    ys = torch.clamp(y, min=1e-300)
    zs = torch.clamp(z, min=1e-300)
    return (y > 0) & (z > 0) & (y * torch.log(zs / ys) - x > 0)


def _exp_dual_in(z3):
    u, v, w = z3[..., 0], z3[..., 1], z3[..., 2]
    um = torch.clamp(-u, min=1e-300)
    wm = torch.clamp(w, min=1e-300)
    return (u < 0) & (w > 0) & (v - u + u * torch.log(um / wm) > 0)


def _pow_primal_in(s3, a):
    x, y, z = s3[..., 0], s3[..., 1], s3[..., 2]
    xs = torch.clamp(x, min=1e-300)
    ys = torch.clamp(y, min=1e-300)
    phi = 2.0 * (a * torch.log(xs) + (1.0 - a) * torch.log(ys))
    return (x > 0) & (y > 0) & (phi > 2.0 * torch.log(
        torch.clamp(torch.abs(z), min=1e-300)))


def _pow_dual_in(z3, a):
    return _pow_primal_in(
        torch.stack([z3[..., 0] / a, z3[..., 1] / (1.0 - a), z3[..., 2]],
                    dim=-1), a)


def _membership(exo: ExoticCones, v, dual):
    """Strict-interior membership of the exotic subvector v (B, dim)."""
    B = v.shape[0]
    ok = torch.ones((B,), dtype=torch.bool, device=v.device)
    if exo.n_exp:
        t = v[:, :3 * exo.n_exp].reshape(B, exo.n_exp, 3)
        fn = _exp_dual_in if dual else _exp_primal_in
        ok = ok & torch.all(fn(t), dim=1)
    off = exo.psd_off
    for s in exo.psd_dims:
        k = s * (s + 1) // 2
        lam = torch.linalg.eigvalsh(_svec_to_mat(v[:, off:off + k], s))
        ok = ok & (lam[:, 0] > 0)
        off += k
    off = exo.pow_off
    for a in exo.pow_alphas:
        fn = _pow_dual_in if dual else _pow_primal_in
        ok = ok & fn(v[:, off:off + 3], a)
        off += 3
    return ok


def exotic_max_step(exo: ExoticCones, s_exo, ds, z_exo, dz, cap=2.0,
                    iters=40):
    """Largest alpha <= cap with s + alpha ds in int K and z + alpha dz in
    int K* over all exotic blocks; _BIG where alpha = cap works.  PSD blocks
    use the closed form; exp/pow batched bisection (the feasible alphas
    form an interval since the cones are convex)."""
    B = s_exo.shape[0]
    alpha = torch.full((B,), _BIG, dtype=s_exo.dtype, device=s_exo.device)
    off = exo.psd_off
    for s in exo.psd_dims:
        k = s * (s + 1) // 2
        for (v, dv) in ((s_exo, ds), (z_exo, dz)):
            M = _svec_to_mat(v[:, off:off + k], s)
            dM = _svec_to_mat(dv[:, off:off + k], s)
            Mi = _mat_sqrt(M, inv=True)
            lmin = torch.linalg.eigvalsh(Mi @ dM @ Mi)[:, 0]
            a = torch.where(lmin < 0, -1.0 / torch.where(
                lmin < 0, lmin, -torch.ones_like(lmin)),
                torch.full_like(lmin, _BIG))
            alpha = torch.minimum(alpha, a)
        off += k

    if exo.n_exp or exo.pow_alphas:
        sub = ExoticCones(exo.n_exp, (), exo.pow_alphas)
        ps, pe = exo.psd_off, exo.pow_off
        sv = torch.cat([s_exo[:, :ps], s_exo[:, pe:]], dim=1)
        dsv = torch.cat([ds[:, :ps], ds[:, pe:]], dim=1)
        zv = torch.cat([z_exo[:, :ps], z_exo[:, pe:]], dim=1)
        dzv = torch.cat([dz[:, :ps], dz[:, pe:]], dim=1)

        def ok_at(a):
            return (_membership(sub, sv + a[:, None] * dsv, dual=False)
                    & _membership(sub, zv + a[:, None] * dzv, dual=True))

        capv = torch.full((B,), cap, dtype=s_exo.dtype, device=s_exo.device)
        feas_cap = ok_at(capv)
        lo = torch.zeros_like(capv)
        hi = capv
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            ok = ok_at(mid)
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        a_bis = torch.where(feas_cap, torch.full_like(lo, _BIG), lo)
        alpha = torch.minimum(alpha, a_bis)
    return alpha


def exotic_proximity(exo: ExoticCones, s_exo, z_exo, mu):
    """Scaled-norm centrality measure of the nonsymmetric (exp/pow) blocks,
    eta_i = || s_i + mu grad F*(z_i) ||_{grad^2 F*(z_i)^{-1}} / mu (0 on
    the central path), maximised over blocks (B,).  PSD blocks are
    self-scaled and excluded."""
    B = s_exo.shape[0]
    out = s_exo.new_zeros((B,))

    def block_eta(s3, g, h):
        """eta of blocks (..., 3) at instance mu (leading axis B); the
        maximum over blocks is exact, so all exp blocks go at once."""
        m = mu.reshape((B,) + (1,) * (s3.dim() - 1))
        r = s3 + m * g
        hinv_r = torch.einsum('...ij,...j->...i', _inv33(h), r)
        q = torch.clamp(torch.sum(r * hinv_r, dim=-1), min=0.0)
        eta = torch.sqrt(q) / m[..., 0]
        # overflowed barrier Hessians yield NaN: report a large finite eta
        # so backtracking still accepts candidates that reduce proximity
        return torch.where(torch.isfinite(eta), eta,
                           torch.full_like(eta, 1e6))

    if exo.n_exp:
        ne = exo.n_exp
        g, h = _exp_dual_derivs(z_exo[:, :3 * ne].reshape(B * ne, 3))
        eta = block_eta(s_exo[:, :3 * ne].reshape(B, ne, 3),
                        g.reshape(B, ne, 3), h.reshape(B, ne, 3, 3))
        out = torch.maximum(out, torch.amax(eta, dim=1))
    off = exo.pow_off
    for a in exo.pow_alphas:
        g, h = _pow_dual_derivs(z_exo[:, off:off + 3], a)
        out = torch.maximum(out, block_eta(s_exo[:, off:off + 3], g, h))
        off += 3
    return out


def exotic_centrality_alpha(exo: ExoticCones, s, ds, z, dz, kdeg, alpha,
                            beta=0.8, shrink=0.7, backtracks=12):
    """Neighbourhood-safeguarded step length for nonsymmetric blocks: shrink
    alpha until every exp/pow block satisfies eta_i(alpha) <= beta, or, for
    an iterate already outside the neighbourhood, stays within 1% of its
    current proximity (a threshold below it would reject every candidate
    and freeze mu)."""
    if not (exo.n_exp or exo.pow_alphas):
        return alpha
    ms = s.shape[1] - exo.dim

    def prox_at(a):
        sa = s + a[:, None] * ds
        za = z + a[:, None] * dz
        mu_a = torch.clamp(torch.sum(sa * za, dim=1) / kdeg, min=1e-300)
        return exotic_proximity(exo, sa[:, ms:], za[:, ms:], mu_a)

    thr = torch.clamp(1.01 * prox_at(torch.zeros_like(alpha)), min=beta)
    for _ in range(backtracks):
        ok = prox_at(alpha) <= thr
        # once every instance accepts, the remaining trips change nothing
        if bool(ok.all()):
            break
        alpha = torch.where(ok, alpha, alpha * shrink)
    return alpha


def exotic_dual_dist(exo: ExoticCones, v):
    """Per-instance violation of v (B, dim) vs the dual exotic cones (the
    direction-based primal-infeasibility certificate)."""
    B = v.shape[0]
    out = v.new_zeros((B,))
    if exo.n_exp:
        t = v[:, :3 * exo.n_exp].reshape(B, exo.n_exp, 3)
        u, vv, w = t[..., 0], t[..., 1], t[..., 2]
        um = torch.clamp(-u, min=1e-12)
        wm = torch.clamp(w, min=1e-12)
        main = torch.where(-u > 1e-12, -(vv - u + u * torch.log(um / wm)),
                           torch.clamp(-vv, min=0.0))
        viol = torch.maximum(torch.maximum(u, -w),
                             torch.clamp(main, min=0.0))
        out = torch.maximum(out, torch.amax(torch.clamp(viol, min=0.0),
                                            dim=1))
    off = exo.psd_off
    for s in exo.psd_dims:
        k = s * (s + 1) // 2
        lam = torch.linalg.eigvalsh(_svec_to_mat(v[:, off:off + k], s))
        out = torch.maximum(out, torch.clamp(-lam[:, 0], min=0.0))
        off += k
    off = exo.pow_off
    for a in exo.pow_alphas:
        u, vv, w = v[:, off], v[:, off + 1], v[:, off + 2]
        us = torch.clamp(u / a, min=0.0)
        vs = torch.clamp(vv / (1.0 - a), min=0.0)
        main = torch.abs(w) - us ** a * vs ** (1.0 - a)
        viol = torch.maximum(torch.maximum(-u, -vv), main)
        out = torch.maximum(out, torch.clamp(viol, min=0.0))
        off += 3
    return out


def exotic_primal_dist(exo: ExoticCones, v):
    """Per-instance violation of v (B, dim) vs the primal exotic cones (the
    recession-cone check of the dual-infeasibility certificate)."""
    B = v.shape[0]
    out = v.new_zeros((B,))
    if exo.n_exp:
        t = v[:, :3 * exo.n_exp].reshape(B, exo.n_exp, 3)
        x, y, z = t[..., 0], t[..., 1], t[..., 2]
        ys = torch.clamp(y, min=1e-12)
        zs = torch.clamp(z, min=1e-12)
        main = torch.where(y > 1e-12, x - y * torch.log(zs / ys),
                           torch.clamp(x, min=0.0))
        viol = torch.maximum(torch.maximum(-y, -z),
                             torch.clamp(main, min=0.0))
        out = torch.maximum(out, torch.amax(torch.clamp(viol, min=0.0),
                                            dim=1))
    off = exo.psd_off
    for s in exo.psd_dims:
        k = s * (s + 1) // 2
        lam = torch.linalg.eigvalsh(_svec_to_mat(v[:, off:off + k], s))
        out = torch.maximum(out, torch.clamp(-lam[:, 0], min=0.0))
        off += k
    off = exo.pow_off
    for a in exo.pow_alphas:
        x, y, z = v[:, off], v[:, off + 1], v[:, off + 2]
        xs = torch.clamp(x, min=0.0)
        ys = torch.clamp(y, min=0.0)
        main = torch.abs(z) - xs ** a * ys ** (1.0 - a)
        viol = torch.maximum(torch.maximum(-x, -y), main)
        out = torch.maximum(out, torch.clamp(viol, min=0.0))
        off += 3
    return out
