"""Homogeneous self-dual embedding (HSDE) pass for the conic IPM.

Port of the JAX package's ``solvers/ipm_hsde.py``: reliable
infeasible/unbounded detection for nonsymmetric (exp/pow) cone layouts,
whose neighbourhood safeguards in the main IPM (solvers/ipm.py) can keep an
infeasible instance from diverging until max_iter.  For the
linear-objective conic problem (P = 0)

    min q'x   s.t.  E x + f = 0,   G x + h = s,   s in K,

the homogeneous model of Ye-Todd-Mizuno finds (x, nu, z in K*, s in K,
tau >= 0, kappa >= 0), not all zero, with

    -E'nu - G'z + q tau = 0
     E x            + f tau = 0
     G x            + h tau = s
    -q'x - f'nu - h'z       = kappa

and s'z + tau kappa = 0.  tau > 0 recovers an optimal x/tau; kappa > 0
forces tau = 0 and the iterate is a Farkas certificate.  This module runs a
fixed-iteration path-following IPM on the embedding (batched pivoted LU on
the full KKT, as in the reference: it runs only on batches with
undetermined instances).  ipm.py re-checks the returned ray with its own
certificate tests, so a status -3/-4 is only committed on a verified
certificate.
"""
from __future__ import annotations

import torch

from .ipm import BatchNT, cone_e, jdiv, jprod, max_step_cone
from .ipm_cones import (ExoticScaling, exotic_centrality_alpha, exotic_init,
                        exotic_max_step)


def hsde_run(q, E, f, G, h, l_nonneg, socs, exo, iters=60,
             exotic_beta=2.0, exotic_shrink=0.7, exotic_backtracks=12,
             static_reg=1e-8, refine_steps=1):
    """Run the homogeneous-embedding IPM for ``iters`` iterations.

    q (B, n); E (B, mz, n) / f (B, mz); G (B, mc, n) / h (B, mc); cone
    layout as in ipm.ipm_solve (symmetric rows first, then exotic).
    Returns (x, nu, z, s, tau, kappa): a candidate solution when
    tau >> kappa, a candidate Farkas ray when kappa >> tau.  Data should be
    the Ruiz-scaled quantities; rays unscale to rays."""
    B, n = q.shape
    mz = E.shape[1] if E.dim() == 3 else 0
    mc = G.shape[1]
    dtype, dev = q.dtype, q.device
    ms = l_nonneg + int(sum(socs))
    kdeg = l_nonneg + len(socs) + exo.degree + 1     # + (tau, kappa) pair
    N = n + mz + mc
    e_sym = cone_e(B, l_nonneg, socs, dtype, dev)
    s0 = torch.cat([e_sym, exotic_init(B, exo, dtype, dev)], dim=1)
    ar = torch.arange(n, device=dev)
    fz = f if mz else q.new_zeros((B, 0))

    def mv(M, v):
        return torch.einsum('bij,bj->bi', M, v)

    def mtv(M, v):
        return torch.einsum('bij,bi->bj', M, v)

    x, nu = q.new_zeros((B, n)), q.new_zeros((B, mz))
    z, s = s0, s0
    tau, kappa = q.new_ones((B,)), q.new_ones((B,))
    sigma = 0.5
    for _ in range(iters):
        mu = (torch.sum(s * z, dim=1) + tau * kappa) / kdeg

        # residuals of the homogeneous system
        r_x = -mtv(G, z) + q * tau[:, None]
        if mz:
            r_x = r_x - mtv(E, nu)
            r_y = mv(E, x) + f * tau[:, None]
        else:
            r_y = q.new_zeros((B, 0))
        r_z = mv(G, x) + h * tau[:, None] - s
        r_tau = (-torch.sum(q * x, dim=1)
                 - (torch.sum(f * nu, dim=1) if mz else 0.0)
                 - torch.sum(h * z, dim=1) - kappa)

        sexo, zexo = s[:, ms:], z[:, ms:]
        W = BatchNT(s[:, :ms], z[:, :ms], l_nonneg, socs)
        lam = W.mul(z[:, :ms])
        ES = ExoticScaling(exo, sexo, zexo, mu,
                           strategy='dual') if exo else None

        # KKT with P = 0: full quasidefinite system, batched pivoted LU
        H = W.wtw_dense(B, mc, dtype)
        if exo:
            H = ES.set_H(H, ms)
        K = q.new_zeros((B, N, N))
        K[:, ar, ar] = static_reg
        if mz:
            K[:, :n, n:n + mz] = -E.transpose(1, 2)
            K[:, n:n + mz, :n] = E
        K[:, :n, n + mz:] = -G.transpose(1, 2)
        K[:, n + mz:, :n] = G
        K[:, n + mz:, n + mz:] = H
        lu, piv, _ = torch.linalg.lu_factor_ex(K)

        def applyH(dz):
            Hdz = W.mul(W.mul(dz[:, :ms]))
            if exo:
                Hdz = torch.cat([Hdz, ES.apply(dz[:, ms:])], dim=1)
            return Hdz

        def lu_apply(r1, r2, r3):
            rhs = torch.cat([r1, r2, r3], dim=1)
            sol = torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]
            return sol[:, :n], sol[:, n:n + mz], sol[:, n + mz:]

        def solve3(r1, r2, r3):
            dx, dnu, dz = lu_apply(r1, r2, r3)
            for _ in range(refine_steps):
                a1 = -mtv(G, dz)
                if mz:
                    a1 = a1 - mtv(E, dnu)
                    a2 = mv(E, dx)
                else:
                    a2 = q.new_zeros((B, 0))
                a3 = mv(G, dx) + applyH(dz)
                cx, cnu, cz = lu_apply(r1 - a1, r2 - a2, r3 - a3)
                dx, dnu, dz = dx + cx, dnu + cnu, dz + cz
            return dx, dnu, dz

        # centering RHS for the cone rows (no Mehrotra corrector)
        lam2 = jprod(lam, lam, l_nonneg, socs)
        dtv = sigma * mu[:, None] * e_sym - lam2
        rhs3 = -r_z[:, :ms] + W.mul(jdiv(lam, dtv, l_nonneg, socs))
        if exo:
            rhs3 = torch.cat([rhs3, -r_z[:, ms:] - sexo
                              + (sigma * mu)[:, None]
                              * ES.centering_rhs(zexo)], dim=1)

        # two-solve elimination of dtau
        dx1, dnu1, dz1 = solve3(-r_x, -r_y, rhs3)
        dx2, dnu2, dz2 = solve3(q, fz, h)

        def tau_coeff(dx_, dnu_, dz_):
            return (-torch.sum(q * dx_, dim=1)
                    - (torch.sum(f * dnu_, dim=1) if mz else 0.0)
                    - torch.sum(h * dz_, dim=1))

        c1 = tau_coeff(dx1, dnu1, dz1)
        c2 = tau_coeff(dx2, dnu2, dz2)
        tk_rhs = sigma * mu - tau * kappa
        # tau -> 0 on infeasible instances (the Farkas ray): clamp the tau
        # divisions so they stay finite in float32
        tau_s = torch.clamp(tau, min=float(torch.finfo(dtype).tiny) ** 0.5)
        denom = kappa / tau_s - c2
        # sign-preserving clamp of a vanishing denominator
        denom = torch.where(torch.abs(denom) > 1e-12, denom,
                            torch.where(denom < 0,
                                        torch.full_like(denom, -1e-12),
                                        torch.full_like(denom, 1e-12)))
        dtau = (-r_tau - c1 + tk_rhs / tau_s) / denom
        dx = dx1 - dtau[:, None] * dx2
        dnu = dnu1 - dtau[:, None] * dnu2 if mz else dnu1
        dz = dz1 - dtau[:, None] * dz2
        ds = mv(G, dx) + h * dtau[:, None] + r_z
        dkappa = (tk_rhs - kappa * dtau) / tau_s

        # step length: cones + tau/kappa positivity + exotic proximity
        a = torch.minimum(max_step_cone(s[:, :ms], ds[:, :ms], l_nonneg, socs),
                          max_step_cone(z[:, :ms], dz[:, :ms], l_nonneg, socs))
        if exo:
            a = torch.minimum(a, exotic_max_step(exo, sexo, ds[:, ms:], zexo,
                                                 dz[:, ms:]))
        for (v, dv) in ((tau, dtau), (kappa, dkappa)):
            neg = dv < 0
            a = torch.minimum(a, torch.where(
                neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                torch.full_like(dv, 1e20)))
        alpha = torch.clamp(0.9 * a, max=1.0)
        if exo:
            alpha = exotic_centrality_alpha(
                exo, s, ds, z, dz, kdeg, alpha, beta=exotic_beta,
                shrink=exotic_shrink, backtracks=exotic_backtracks)
        # guard NaN directions (degenerate scaling): skip the update
        fin = (torch.all(torch.isfinite(ds), dim=1)
               & torch.all(torch.isfinite(dz), dim=1)
               & torch.all(torch.isfinite(dx), dim=1)
               & torch.isfinite(dtau) & torch.isfinite(dkappa))
        alpha = torch.where(fin, alpha, torch.zeros_like(alpha))

        x = x + alpha[:, None] * dx
        nu = nu + alpha[:, None] * dnu if mz else nu
        z = z + alpha[:, None] * dz
        s = s + alpha[:, None] * ds
        tau = tau + alpha * dtau
        kappa = kappa + alpha * dkappa
        # the system is homogeneous: rescale the iterate back to O(1)
        # whenever a Farkas ray grows (unnormalized, the barrier Hessians
        # square its magnitude and overflow float32)
        mag = torch.maximum(torch.amax(torch.abs(s), dim=1),
                            torch.amax(torch.abs(z), dim=1))
        mag = torch.maximum(mag, torch.maximum(tau, kappa))
        scale = torch.where(mag > 10.0, 10.0 / mag, torch.ones_like(mag))
        x = x * scale[:, None]
        nu = nu * scale[:, None] if mz else nu
        z = z * scale[:, None]
        s = s * scale[:, None]
        tau = tau * scale
        kappa = kappa * scale
    return x, nu, z, s, tau, kappa
