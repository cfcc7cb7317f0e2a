"""A plain batched primal-dual interior-point method for convex QPs.

    minimize 0.5 x'Px + q'x   subject to   E x = f,   G x <= h

over a batch of independent instances (leading dimension S), in plain
PyTorch.  Mehrotra's predictor-corrector from an infeasible start (x = 0,
slacks and multipliers 1); each Newton system is reduced to the (n + p)
system [[P + G' diag(z/s) G, E'], [E, 0]], factored by a batched LU with a
small quasi-definite regularization (``delta``) and solved with one step of
iterative refinement against the unregularized system.  It is
the benchmark's yardstick: it shares no code, formulation or data with the
solver under test.  Run it in float64 for the reference answer; the
precision of the control is whatever dtype and matmul mode it is run in.
"""
import torch


def solve_qp(P, q, E, f, G, h, tol=1e-8, max_iter=100, delta=1e-10):
    """Solve the batch; every argument is a tensor with a leading batch
    dimension S (P (S, n, n), q (S, n), E (S, p, n), f (S, p), G (S, m, n),
    h (S, m)), all in one dtype on one device.

    Returns dict(x, y, z, s, obj, iters, converged): the primal point, the
    multipliers of the equalities and inequalities, the slacks, the
    objective 0.5 x'Px + q'x, the iterations taken and whether each
    instance met ``tol`` on the relative residuals and the duality gap.  An
    instance whose system cannot be factored, or whose next point would not
    be finite and positive, stops where it is, not converged."""
    S, n = q.shape
    p, m = f.shape[1], h.shape[1]
    dt, dev = q.dtype, q.device
    x = torch.zeros((S, n), dtype=dt, device=dev)
    y = torch.zeros((S, p), dtype=dt, device=dev)
    s = torch.ones((S, m), dtype=dt, device=dev)
    z = torch.ones((S, m), dtype=dt, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    stalled = torch.zeros(S, dtype=torch.bool, device=dev)
    iters = torch.zeros(S, dtype=torch.int64, device=dev)
    Et, Gt = E.transpose(1, 2), G.transpose(1, 2)
    scale_d = 1.0 + _norm(q)
    scale_p = 1.0 + torch.maximum(_norm(f), _norm(h))

    def mv(M, v):
        return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)

    for it in range(max_iter):
        r_d = mv(P, x) + q + mv(Et, y) + mv(Gt, z)
        r_p = mv(E, x) - f
        r_g = mv(G, x) + s - h
        mu = (s * z).sum(1) / max(m, 1)
        obj = 0.5 * (x * mv(P, x)).sum(1) + (q * x).sum(1)
        ok = ((_norm(r_d) <= tol * scale_d)
              & (_norm(r_p) <= tol * scale_p) & (_norm(r_g) <= tol * scale_p)
              & (mu * m <= tol * (1.0 + obj.abs())))
        done = done | ok
        if bool(done.all()):
            break
        iters = iters + (~done).long()
        # instances already done keep their point; their system is given
        # unit weights so that it stays well defined
        D = torch.where(done[:, None], torch.ones_like(s), z / s)
        H = P + Gt @ (D.unsqueeze(-1) * G)
        K = torch.cat([torch.cat([H, Et], 2),
                       torch.cat([E, torch.zeros((S, p, p), dtype=dt,
                                                 device=dev)], 2)], 1)
        # the factor is of the quasi-definite [[H + dI, E'], [E, -dI]],
        # which no pivot can make singular; the refinement below solves
        # with K itself
        reg = delta * torch.cat([torch.ones(n, dtype=dt, device=dev),
                                 -torch.ones(p, dtype=dt, device=dev)])
        LU, piv, info = torch.linalg.lu_factor_ex(K + torch.diag_embed(
            reg.expand(S, n + p)))
        bad_factor = info != 0

        def direction(r_c):
            # z*ds + s*dz = r_c;  G dx + ds = -r_g  =>
            # dz = D (G dx + r_g) + r_c / s
            rhs = torch.cat([-r_d - mv(Gt, D * r_g + r_c / s), -r_p], 1)
            sol = torch.linalg.lu_solve(LU, piv, rhs.unsqueeze(-1))[..., 0]
            # one step of iterative refinement: the system grows
            # ill-conditioned as the slacks of active rows go to 0
            sol = sol + torch.linalg.lu_solve(
                LU, piv, (rhs - mv(K, sol)).unsqueeze(-1))[..., 0]
            dx, dy = sol[:, :n], sol[:, n:]
            dz = D * (mv(G, dx) + r_g) + r_c / s
            ds = (r_c - s * dz) / z
            return dx, dy, dz, ds

        sz = s * z
        dx, dy, dz, ds = direction(-sz)
        a_aff = torch.clamp(torch.minimum(_step(s, ds), _step(z, dz)),
                            max=1.0)
        mu_aff = ((s + a_aff[:, None] * ds) * (z + a_aff[:, None] * dz)
                  ).sum(1) / max(m, 1)
        sigma = torch.clamp(mu_aff / torch.clamp(mu, min=torch.finfo(dt).tiny),
                            0, 1) ** 3
        dx, dy, dz, ds = direction(-sz + (sigma * mu)[:, None] - ds * dz)
        a = torch.clamp(0.99 * torch.minimum(_step(s, ds), _step(z, dz)),
                        max=1.0)
        xn, yn = x + a[:, None] * dx, y + a[:, None] * dy
        zn, sn = z + a[:, None] * dz, s + a[:, None] * ds
        # an instance whose step is no longer finite (the precision is
        # spent) stops at its last point, not converged
        bad = bad_factor | ~(torch.isfinite(xn).all(1)
                             & torch.isfinite(yn).all(1)
                             & torch.isfinite(zn).all(1)
                             & torch.isfinite(sn).all(1)
                             & (zn > 0).all(1) & (sn > 0).all(1))
        keep = (done | bad)[:, None]
        x = torch.where(keep, x, xn)
        y = torch.where(keep, y, yn)
        z = torch.where(keep, z, zn)
        s = torch.where(keep, s, sn)
        stalled = stalled | (bad & ~done)
        done = done | bad
    obj = 0.5 * (x * mv(P, x)).sum(1) + (q * x).sum(1)
    return dict(x=x, y=y, z=z, s=s, obj=obj, iters=iters,
                converged=done & ~stalled)


def _norm(v):
    return v.abs().amax(1) if v.shape[1] else torch.zeros(
        v.shape[0], dtype=v.dtype, device=v.device)


def _step(v, dv):
    """The largest step that keeps v + step*dv >= 0 (inf if dv >= 0)."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float('inf')))
    return ratio.amin(1)
