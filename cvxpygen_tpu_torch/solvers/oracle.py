"""Reference conic-QP interior-point solver (NumPy, float64, CPU).

Role: the stock-solver oracle that the reference's tests compare generated
code against (reference tests/utils_test.py:20-35 solves with OSQP/SCS/
CLARABEL...).  Since this framework is standalone (no cvxpy/osqp/scs in the
environment), this dense Mehrotra predictor-corrector IPM with Nesterov-Todd
scalings for nonneg/SOC cones plays that role: float64, small problems,
correctness over speed.  The batched TPU solvers are tested against it.

Problem form (matches canon/canonicalizer.py Family convention):
    minimize    0.5 x'Px + q'x
    subject to  E x + f = 0                      (zero rows)
                G x + h = s,  s in K             (nonneg rows + SOC cones)
with K = R+^l x SOC(d1) x ... x SOC(dk).
Duals: stationarity P x + q - E'nu - G'z = 0,  z in K*.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ConeDims:
    nonneg: int
    socs: list

    @property
    def total(self):
        return self.nonneg + int(sum(self.socs))

    @property
    def degree(self):
        return self.nonneg + len(self.socs)


@dataclass
class OracleResult:
    status: str
    x: np.ndarray
    nu: np.ndarray
    z: np.ndarray
    s: np.ndarray
    obj: float
    iters: int
    gap: float
    res_primal: float
    res_dual: float


# ---------------------------------------------------------------------------
# cone utilities
# ---------------------------------------------------------------------------

def cone_e(dims: ConeDims):
    e = np.ones(dims.total)
    off = dims.nonneg
    for d in dims.socs:
        e[off] = 1.0
        e[off + 1:off + d] = 0.0
        off += d
    return e


def in_cone(v, dims: ConeDims, margin=0.0):
    if dims.nonneg and np.min(v[:dims.nonneg]) <= margin:
        return False
    off = dims.nonneg
    for d in dims.socs:
        t, x = v[off], v[off + 1:off + d]
        if t <= margin or t <= np.linalg.norm(x) + margin:
            return False
        off += d
    return True


def max_step(v, dv, dims: ConeDims):
    """Largest alpha with v + alpha*dv on the cone boundary (inf if none)."""
    alpha = np.inf
    if dims.nonneg:
        neg = dv[:dims.nonneg] < 0
        if np.any(neg):
            alpha = min(alpha, np.min(-v[:dims.nonneg][neg] / dv[:dims.nonneg][neg]))
    off = dims.nonneg
    for d in dims.socs:
        t, x = v[off], v[off + 1:off + d]
        dt, dx = dv[off], dv[off + 1:off + d]
        # (t+a dt)^2 - |x+a dx|^2 >= 0 and t + a dt >= 0
        a2 = dt * dt - dx @ dx
        a1 = t * dt - x @ dx
        a0 = t * t - x @ x
        roots = []
        if abs(a2) > 1e-14:
            disc = a1 * a1 - a2 * a0
            if disc >= 0:
                sq = np.sqrt(disc)
                roots += [(-a1 + sq) / a2, (-a1 - sq) / a2]
        elif abs(a1) > 1e-14:
            roots += [-a0 / (2 * a1)]
        if dt < 0:
            roots += [-t / dt]
        pos = [r for r in roots if r > 1e-14]
        if pos:
            # smallest positive root where the iterate leaves the cone
            for r in sorted(pos):
                vmid = v[off:off + d] + 0.5 * r * dv[off:off + d]
                if vmid[0] > 0 and vmid[0] ** 2 - vmid[1:] @ vmid[1:] > 0:
                    alpha = min(alpha, r)
                    break
                alpha = min(alpha, r)
                break
        off += d
    return alpha


def jordan_prod(u, v, dims: ConeDims):
    out = np.empty(dims.total)
    out[:dims.nonneg] = u[:dims.nonneg] * v[:dims.nonneg]
    off = dims.nonneg
    for d in dims.socs:
        u0, u1 = u[off], u[off + 1:off + d]
        v0, v1 = v[off], v[off + 1:off + d]
        out[off] = u0 * v0 + u1 @ v1
        out[off + 1:off + d] = u0 * v1 + v0 * u1
        off += d
    return out


def jordan_div(lam, v, dims: ConeDims):
    """Solve lam o u = v."""
    out = np.empty(dims.total)
    out[:dims.nonneg] = v[:dims.nonneg] / lam[:dims.nonneg]
    off = dims.nonneg
    for d in dims.socs:
        l0, l1 = lam[off], lam[off + 1:off + d]
        Arw = np.empty((d, d))
        Arw[0, 0] = l0
        Arw[0, 1:] = l1
        Arw[1:, 0] = l1
        Arw[1:, 1:] = l0 * np.eye(d - 1)
        out[off:off + d] = np.linalg.solve(Arw, v[off:off + d])
        off += d
    return out


class NTScaling:
    """W with W z = W^{-T} s = lambda (Nesterov-Todd)."""

    def __init__(self, s, z, dims: ConeDims):
        self.dims = dims
        self.d_nn = np.sqrt(s[:dims.nonneg] / z[:dims.nonneg])
        self.soc = []
        off = dims.nonneg
        for d in dims.socs:
            ss, zz = s[off:off + d], z[off:off + d]
            det_s = ss[0] ** 2 - ss[1:] @ ss[1:]
            det_z = zz[0] ** 2 - zz[1:] @ zz[1:]
            sb = ss / np.sqrt(det_s)
            zb = zz / np.sqrt(det_z)
            gamma = np.sqrt((1.0 + sb @ zb) / 2.0)
            wb = np.empty(d)
            wb[0] = (sb[0] + zb[0]) / (2 * gamma)
            wb[1:] = (sb[1:] - zb[1:]) / (2 * gamma)
            eta = (det_s / det_z) ** 0.25
            self.soc.append((wb, eta, d))
            off += d

    def _soc_mat(self, wb, eta, d, inv=False):
        W = np.empty((d, d))
        w0, w1 = wb[0], wb[1:]
        sgn = -1.0 if inv else 1.0
        W[0, 0] = w0
        W[0, 1:] = sgn * w1
        W[1:, 0] = sgn * w1
        W[1:, 1:] = np.eye(d - 1) + np.outer(w1, w1) / (1.0 + w0)
        return W * (1.0 / eta if inv else eta)

    def mul(self, v, inv=False, trans=False):
        """W v (or W^{-1} v); W symmetric so trans is a no-op."""
        dims = self.dims
        out = np.empty(dims.total)
        dn = 1.0 / self.d_nn if inv else self.d_nn
        out[:dims.nonneg] = dn * v[:dims.nonneg]
        off = dims.nonneg
        for (wb, eta, d) in self.soc:
            W = self._soc_mat(wb, eta, d, inv=inv)
            out[off:off + d] = W @ v[off:off + d]
            off += d
        return out

    def wtw(self):
        """Dense W^T W = W^2 (block diagonal)."""
        dims = self.dims
        M = np.zeros((dims.total, dims.total))
        M[:dims.nonneg, :dims.nonneg] = np.diag(self.d_nn ** 2)
        off = dims.nonneg
        for (wb, eta, d) in self.soc:
            W = self._soc_mat(wb, eta, d)
            M[off:off + d, off:off + d] = W @ W
            off += d
        return M


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

def solve_conic_qp(P, q, E, f, G, h, dims: ConeDims, max_iter=100,
                   tol=1e-9, verbose=False):
    n = len(q)
    mz = E.shape[0] if E is not None else 0
    mc = dims.total
    if E is None:
        E = np.zeros((0, n))
        f = np.zeros(0)
    if mc == 0:
        # equality-constrained QP
        K = np.block([[P, E.T], [E, np.zeros((mz, mz))]])
        rhs = np.concatenate([-q, -f])
        sol = np.linalg.solve(K + 1e-12 * np.eye(n + mz), rhs)
        x, nu = sol[:n], -sol[n:]
        obj = 0.5 * x @ P @ x + q @ x
        return OracleResult('optimal', x, nu, np.zeros(0), np.zeros(0), obj,
                            0, 0.0, np.linalg.norm(E @ x + f), 0.0)

    e = cone_e(dims)
    x = np.zeros(n)
    nu = np.zeros(mz)
    s = e.copy()
    z = e.copy()
    kdeg = dims.degree

    def residuals(x, nu, z, s):
        rx = P @ x + q - E.T @ nu - G.T @ z
        ry = E @ x + f
        rz = G @ x + h - s
        return rx, ry, rz

    status = 'max_iter'
    it = 0
    for it in range(1, max_iter + 1):
        rx, ry, rz = residuals(x, nu, z, s)
        mu = (s @ z) / kdeg
        gap = abs(s @ z)
        obj = 0.5 * x @ P @ x + q @ x
        rel = max(1.0, np.linalg.norm(q))
        rp = max(np.linalg.norm(ry), np.linalg.norm(rz))
        rd = np.linalg.norm(rx)
        if rp < tol * max(1.0, np.linalg.norm(h) + np.linalg.norm(f)) and \
           rd < tol * rel and gap < tol * max(1.0, abs(obj)):
            status = 'optimal'
            break

        Wsc = NTScaling(s, z, dims)
        lam = Wsc.mul(z)
        WtW = Wsc.wtw()

        K = np.zeros((n + mz + mc, n + mz + mc))
        K[:n, :n] = P
        K[:n, n:n + mz] = -E.T
        K[:n, n + mz:] = -G.T
        K[n:n + mz, :n] = E
        K[n + mz:, :n] = G
        K[n + mz:, n + mz:] = WtW
        import scipy.linalg as sla
        lu = sla.lu_factor(K + 1e-13 * np.eye(K.shape[0]))

        def solve_dir(dt_vec):
            rhs = np.concatenate([
                -rx, -ry, -rz + Wsc.mul(jordan_div(lam, dt_vec, dims))])
            sol = sla.lu_solve(lu, rhs)
            dx, dnu, dz = sol[:n], sol[n:n + mz], sol[n + mz:]
            ds = G @ dx + rz
            return dx, dnu, dz, ds

        # affine (predictor)
        dt = -jordan_prod(lam, lam, dims)
        dx_a, dnu_a, dz_a, ds_a = solve_dir(dt)
        a_s = max_step(s, ds_a, dims)
        a_z = max_step(z, dz_a, dims)
        alpha_aff = min(1.0, a_s, a_z)
        mu_aff = ((s + alpha_aff * ds_a) @ (z + alpha_aff * dz_a)) / kdeg
        sigma = np.clip((mu_aff / mu) ** 3, 1e-8, 1.0 - 1e-8)

        # corrector
        corr = jordan_prod(Wsc.mul(ds_a, inv=True), Wsc.mul(dz_a), dims)
        dt = sigma * mu * e - jordan_prod(lam, lam, dims) - corr
        dx, dnu, dz, ds = solve_dir(dt)

        a_s = max_step(s, ds, dims)
        a_z = max_step(z, dz, dims)
        alpha = min(1.0, 0.99 * min(a_s, a_z))
        x = x + alpha * dx
        nu = nu + alpha * dnu
        z = z + alpha * dz
        s = s + alpha * ds
        if verbose:
            print(f'iter {it}: mu={mu:.2e} rp={rp:.2e} rd={rd:.2e} alpha={alpha:.2f}')

    rx, ry, rz = residuals(x, nu, z, s)
    obj = 0.5 * x @ P @ x + q @ x
    return OracleResult(status if status == 'optimal' else
                        ('optimal_inaccurate' if np.linalg.norm(rx) < 1e-5 else status),
                        x, nu, z, s, obj, it, float(abs(s @ z)),
                        float(max(np.linalg.norm(ry), np.linalg.norm(rz))),
                        float(np.linalg.norm(rx)))


def solve_conic_admm_np(P, q, A, b, n_zero, layout, tol=1e-9,
                        max_iter=200000, rho=1.0, sigma=1e-6, alpha=1.5):
    """Float64 conic ADMM oracle (unbatched) for cone families the NT-scaled
    IPM does not cover (exp/PSD).  Same splitting as
    solvers/conic_admm.py, NumPy twin projections from ops/cones.py.
    Correctness over speed: exact Cholesky KKT, tight tolerance."""
    import scipy.linalg as sla

    from ..ops.cones import project_cone_np

    m, n = A.shape
    mc = m - n_zero
    rho_vec = np.where(np.arange(m) < n_zero, 1e3 * rho, rho)
    x = np.zeros(n)
    z = np.zeros(m)
    y = np.zeros(m)

    def factor(rv):
        M = P + sigma * np.eye(n) + A.T @ (rv[:, None] * A)
        return sla.cho_factor(M)

    cf = factor(rho_vec)
    it = 0
    status = 'max_iter'
    for it in range(1, max_iter + 1):
        rhs = sigma * x - q + A.T @ (rho_vec * z - y)
        xt = sla.cho_solve(cf, rhs)
        zt = A @ xt
        x = alpha * xt + (1 - alpha) * x
        w = alpha * zt + (1 - alpha) * z + y / rho_vec
        z_new = np.empty(m)
        z_new[:n_zero] = -b[:n_zero]
        if mc:
            z_new[n_zero:] = project_cone_np(w[n_zero:] + b[n_zero:],
                                             layout) - b[n_zero:]
        y = rho_vec * (w - z_new)
        z = z_new
        if it % 50 == 0:
            Ax = A @ x
            rp = np.max(np.abs(Ax - z)) if m else 0.0
            rd = np.max(np.abs(P @ x + q + A.T @ y))
            den_p = max(np.max(np.abs(Ax), initial=0.0),
                        np.max(np.abs(z), initial=0.0), 1.0)
            den_d = max(np.max(np.abs(P @ x)), np.max(np.abs(q)),
                        np.max(np.abs(A.T @ y), initial=0.0), 1.0)
            if rp <= tol * den_p and rd <= tol * den_d:
                status = 'optimal'
                break
            # adaptive rho every 1000 iters
            if it % 1000 == 0:
                ratio = np.sqrt((rp / den_p) / max(rd / den_d, 1e-16))
                if ratio > 5.0 or ratio < 0.2:
                    rho_vec = np.clip(rho_vec * np.clip(ratio, 0.1, 10.0),
                                      1e-6, 1e6)
                    cf = factor(rho_vec)
    obj = 0.5 * x @ P @ x + q @ x
    y_canon = -y  # Family convention: Px + q - A'y_canon = 0
    nu = y_canon[:n_zero]
    zc = y_canon[n_zero:]
    rp = float(np.linalg.norm(A @ x - z)) if m else 0.0
    rd = float(np.linalg.norm(P @ x + q + A.T @ y))
    return OracleResult(status, x, nu, zc, z[n_zero:] + b[n_zero:], obj, it,
                        float(abs((z[n_zero:] + b[n_zero:]) @ zc)), rp, rd)


def solve_family_numpy(family, theta, **kwargs):
    """Canonicalize at theta and solve with the oracle.  Returns
    (OracleResult, y_full) with y the canonical dual in Family convention
    (y = [nu; z] over [zero | nonneg | socs | exp | psd] rows).

    Families with exp/PSD cones route to the float64 conic-ADMM oracle
    (the NT-scaled IPM covers zero/nonneg/SOC only), mirroring how the
    reference routes cone types to capable solvers (scs.py:130-135)."""
    P, q, d, A, b = family.canon_numpy(theta)
    mz = family.n_zero
    n_exp = getattr(family, 'n_exp', 0)
    psd_dims = tuple(getattr(family, 'psd_dims', ()) or ())
    pow_alphas = tuple(getattr(family, 'pow_alphas', ()) or ())
    if n_exp or psd_dims or pow_alphas:
        from ..ops.cones import ConeLayout
        layout = ConeLayout(n_nonneg=family.n_nonneg,
                            socs=tuple(family.soc_dims),
                            n_exp=n_exp, psds=psd_dims, pows=pow_alphas)
        kw = {k: v for k, v in kwargs.items() if k in ('tol', 'max_iter')}
        res = solve_conic_admm_np(P, q, A, b, mz, layout, **kw)
        y = np.concatenate([res.nu, res.z]) if family.m else np.zeros(0)
        return res, y
    E, f = A[:mz], b[:mz]
    G, h = A[mz:], b[mz:]
    dims = ConeDims(family.n_nonneg, list(family.soc_dims))
    res = solve_conic_qp(P, q, E, f, G, h, dims, **kwargs)
    y = np.concatenate([res.nu, res.z]) if family.m else np.zeros(0)
    return res, y
