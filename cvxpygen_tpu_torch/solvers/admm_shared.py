"""Shared-KKT batched ADMM: P and A shared across the batch, in torch.

Port of the JAX package's ``solvers/admm_shared.py``.  When every instance
of a batch has the same canonical P and A (MPC varying only ``x_init``), the
ADMM KKT matrix ``M = P + sigma*I + A' diag(rho) A`` is batch-invariant:
it is factored once for the whole batch, and every per-iteration matvec is
a full-batch GEMM against one shared matrix.

Two engines run the same algorithm (OSQP alg. 1-3: Ruiz equilibration,
rho-scaled splitting, residual termination, infeasibility certificates):

- the whole-solve kernel K1 (ops/admm_shared_kernel.py), chosen by
  ``kkt_solver='ns'`` with ``use_pallas`` in auto/always/full: a hand-written
  CUDA kernel on the card, its plain torch version on the CPU or with
  ``use_pallas='full_interpret'``.  Adaptive rho there is chunk-shared.
- the torch loop below (``use_pallas='never'``, or the 'inv'/'chol' KKT
  modes): adaptive rho is batch-shared, and the warm refactorization has
  the residual-certificate rescue.
"""
from __future__ import annotations

import torch

from .admm import (ADMMSettings, _eye, _inf_norm, full_f32_matmul,
                   newton_schulz_inverse, newton_schulz_warm)

_INF = 1e30

_KERNEL_MODES = ('auto', 'always', 'full', 'full_interpret')


def ruiz_equilibrate_shared(P, A, q_batch, iters):
    """Ruiz scaling of the SHARED [[P, A'],[A, 0]] (OSQP paper alg. 2).

    The cost scaling ``c`` must stay a batch-shared scalar (it multiplies
    P), so the q-norm term uses the batch-max |q|."""
    m, n = A.shape
    c = torch.ones((), dtype=P.dtype, device=P.device)
    D = torch.ones((n,), dtype=P.dtype, device=P.device)
    E = torch.ones((m,), dtype=P.dtype, device=P.device)
    q_col = torch.amax(torch.abs(q_batch), dim=0)  # (n,) batch envelope

    def inv_sqrt(v):
        return torch.where(v > 1e-12,
                           1.0 / torch.sqrt(torch.clamp(v, min=1e-12)),
                           torch.ones_like(v))

    for _ in range(iters):
        nx_P = torch.amax(torch.abs(P), dim=0)
        nx_A = torch.amax(torch.abs(A), dim=0) if m else torch.zeros_like(nx_P)
        nx = torch.maximum(nx_P, nx_A)
        nc = torch.amax(torch.abs(A), dim=1) if m else E
        dx = torch.clamp(inv_sqrt(nx), 1e-4, 1e4)
        dc = torch.clamp(inv_sqrt(nc), 1e-4, 1e4)
        P = dx[:, None] * P * dx[None, :]
        A = dc[:, None] * A * dx[None, :]
        q_col = dx * q_col
        D = D * dx
        E = E * dc
        col = torch.mean(torch.amax(torch.abs(P), dim=0))
        col = torch.where(col < 1e-12, torch.ones_like(col), col)
        qn = torch.amax(q_col)
        qn = torch.where(qn < 1e-12, torch.ones_like(qn), qn)
        g = torch.clamp(1.0 / torch.maximum(col, qn), 1e-4, 1e4)
        P = P * g
        q_col = q_col * g
        c = c * g
    return P, A, c, D, E


def admm_solve_shared(P, q, A, l, u, n_eq, settings: ADMMSettings,
                      x0=None, y0=None, chunk=None):
    """Solve a batch of QPs sharing P (n, n) and A (m, n); q (B, n),
    l/u (B, m) batched.  Returns dict(x, y, z, obj, iters, pri_res,
    dua_res, solved, status) with y in OSQP sign convention.

    ``chunk`` fixes the kernel's instances per adaptive-rho group (default:
    ops/admm_shared_kernel.pick_shared_chunk)."""
    with full_f32_matmul():
        return _admm_solve_shared_impl(P, q, A, l, u, n_eq, settings,
                                       x0, y0, chunk)


def _form_M(Ps, As, sigma, rho_vec):
    n = Ps.shape[0]
    return Ps + sigma * _eye(n, Ps) + (As.T * rho_vec[None, :]) @ As


def _scale(P, q, A, l, u, n_eq, st, x0, y0):
    """Ruiz-scaled problem data, base rho and scaled starting point."""
    m, n = A.shape
    B = q.shape[0]
    dtype, dev = P.dtype, P.device
    l = torch.clamp(l, -_INF, _INF)
    u = torch.clamp(u, -_INF, _INF)
    Ps, As, c, D, E = ruiz_equilibrate_shared(P, A, q, st.scaling)
    s = dict(Ps=Ps, As=As, c=c, D=D, E=E, qs=(q * D) * c, ls=l * E,
             us=u * E, c_inv=1.0 / c, D_inv=1.0 / D, E_inv=1.0 / E)
    is_eq = torch.arange(m, device=dev) < n_eq
    s['rho_base'] = torch.where(
        is_eq, torch.full((m,), st.rho * st.rho_eq_scale, dtype=dtype,
                          device=dev),
        torch.full((m,), st.rho, dtype=dtype, device=dev))
    zeros = dict(dtype=dtype, device=dev)
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=dev).to(dtype)
        s['x_start'] = s['D_inv'] * x0
        s['z_start'] = E * (x0 @ A.T)
    else:
        s['x_start'] = torch.zeros((B, n), **zeros)
        s['z_start'] = torch.zeros((B, m), **zeros)
    s['y_start'] = (c * s['E_inv'] * torch.as_tensor(y0, device=dev).to(dtype)
                    if y0 is not None else torch.zeros((B, m), **zeros))
    return s


def _kernel_args(s, st):
    M0 = _form_M(s['Ps'], s['As'], st.sigma, s['rho_base'])
    Minv0 = newton_schulz_inverse(M0[None], st.ns_iters)[0]
    return (s['Ps'], s['qs'], s['As'], s['ls'], s['us'], s['rho_base'],
            s['D'], s['E'], s['c_inv'], M0, Minv0, s['x_start'],
            s['z_start'], s['y_start'])


def kernel_kwargs(st: ADMMSettings):
    """Keyword arguments of kernel K1 for these settings."""
    return dict(sigma=st.sigma, alpha=st.alpha, eps_abs=st.eps_abs,
                eps_rel=st.eps_rel, check_interval=st.check_interval,
                max_iter=st.max_iter, ns_adapt_iters=st.ns_adapt_iters,
                adaptive=st.adaptive_rho, rho_tol=st.adaptive_rho_tolerance,
                kkt_refine=st.kkt_refine, adapt_until=st.adaptive_rho_until)


def shared_kernel_args(P, q, A, l, u, n_eq, settings: ADMMSettings,
                       x0=None, y0=None):
    """The positional arguments that admm_solve_shared hands to kernel K1
    (ops/admm_shared_kernel.py) for this batch: the Ruiz-scaled data, M at
    the base rho and its cold Newton-Schulz inverse, the scaled start."""
    with full_f32_matmul():
        return _kernel_args(_scale(P, q, A, l, u, n_eq, settings, x0, y0),
                            settings)


def _admm_solve_shared_impl(P, q, A, l, u, n_eq, st: ADMMSettings,
                            x0=None, y0=None, chunk=None):
    m, n = A.shape
    B = q.shape[0]
    dtype, dev = P.dtype, P.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if m == 0:
        Lc = torch.linalg.cholesky(P + st.sigma * _eye(n, P))
        x = torch.cholesky_solve(-q.T, Lc).T
        obj = 0.5 * torch.einsum('bi,ij,bj->b', x, P, x) + torch.sum(q * x, 1)
        ones_i = torch.ones((B,), dtype=torch.int32, device=dev)
        return dict(x=x, y=zeros(B, 0), z=zeros(B, 0), obj=obj, iters=ones_i,
                    pri_res=zeros(B), dua_res=zeros(B),
                    solved=torch.ones((B,), dtype=torch.bool, device=dev),
                    status=ones_i)

    s = _scale(P, q, A, l, u, n_eq, st, x0, y0)
    Ps, As, qs, ls, us = s['Ps'], s['As'], s['qs'], s['ls'], s['us']
    D, E, c_inv, D_inv, E_inv = (s['D'], s['E'], s['c_inv'], s['D_inv'],
                                 s['E_inv'])
    rho_base = s['rho_base']

    kkt_mode = st.kkt_solver
    if kkt_mode == 'auto':
        kkt_mode = 'ns' if dev.type == 'cuda' else 'inv'
    use_chol = (kkt_mode == 'chol')

    def finish(x, z, y, it_vec, status, rp, rd):
        obj = c_inv * (0.5 * torch.einsum('bi,ij,bj->b', x, Ps, x)
                       + torch.sum(qs * x, dim=1))
        obj = torch.where(status == -3, torch.full_like(obj, float('inf')),
                          obj)
        obj = torch.where(status == -4, torch.full_like(obj, -float('inf')),
                          obj)
        return dict(x=D * x, y=c_inv * E * y, z=E_inv * z, obj=obj,
                    iters=it_vec, pri_res=rp, dua_res=rd,
                    solved=(status == 1), status=status)

    if st.use_pallas in _KERNEL_MODES and kkt_mode == 'ns':
        # the whole solve in kernel K1 (ops/admm_shared_kernel.py)
        from ..ops.admm_shared_kernel import (admm_shared_solve,
                                              admm_shared_solve_plain)
        solve = (admm_shared_solve_plain if st.use_pallas == 'full_interpret'
                 else admm_shared_solve)
        return finish(*solve(*_kernel_args(s, st), **kernel_kwargs(st),
                             chunk=chunk))

    def factor(rho_vec, Minv_warm=None):
        M = _form_M(Ps, As, st.sigma, rho_vec)
        if kkt_mode == 'ns':
            if Minv_warm is None:
                return newton_schulz_inverse(M[None], st.ns_iters)[0]
            return newton_schulz_warm(M[None], Minv_warm[None],
                                      st.ns_adapt_iters)[0]
        Lc = torch.linalg.cholesky(M)
        if use_chol:
            return Lc  # keep the factor; triangular solves every iteration
        return torch.cholesky_solve(_eye(n, M), Lc)

    def M_matvec(rho_vec, x):
        Ax = x @ As.T
        return x @ Ps.T + st.sigma * x + (rho_vec * Ax) @ As

    def kkt_apply(Minv, rho_vec, rhs):
        if use_chol:
            return torch.cholesky_solve(rhs.T, Minv).T
        xt = rhs @ Minv.T
        for _ in range(st.kkt_refine):
            xt = xt + (rhs - M_matvec(rho_vec, xt)) @ Minv.T
        return xt

    def residuals(z, Ax, Px, Aty):
        rp = _inf_norm(E_inv * (Ax - z))
        rp_den = torch.maximum(_inf_norm(E_inv * Ax), _inf_norm(E_inv * z))
        rd = c_inv * _inf_norm(D_inv * (Px + qs + Aty))
        rd_den = c_inv * torch.maximum(
            torch.maximum(_inf_norm(D_inv * Px), _inf_norm(D_inv * Aty)),
            _inf_norm(D_inv * qs))
        ok = ((rp <= st.eps_abs + st.eps_rel * rp_den)
              & (rd <= st.eps_abs + st.eps_rel * rd_den))
        return rp, rd, rp_den, rd_den, ok

    u_open = us >= _INF * 0.5
    l_open = ls <= -_INF * 0.5
    u_fin = torch.where(u_open, torch.zeros_like(us), us * E_inv)
    l_fin = torch.where(l_open, torch.zeros_like(ls), ls * E_inv)

    def infeasibility(dx, dy, Pdx, Adx, Atdy):
        eps = 1e-4
        dy_n = _inf_norm(E * dy) * c_inv
        cert_p1 = _inf_norm(D_inv * Atdy) * c_inv <= eps * dy_n
        Edy = E * dy
        sup = torch.sum(u_fin * torch.clamp(Edy, min=0.0)
                        + l_fin * torch.clamp(Edy, max=0.0), dim=1) * c_inv
        open_dir = (torch.any((dy > 1e-12) & u_open, dim=1)
                    | torch.any((dy < -1e-12) & l_open, dim=1))
        prim_inf = (dy_n > 1e-10) & cert_p1 & (sup <= -eps * dy_n) & ~open_dir

        dx_n = _inf_norm(D * dx)
        cert_d1 = _inf_norm(D_inv * Pdx) * c_inv <= eps * dx_n
        cert_d2 = (torch.sum(qs * dx, dim=1) * c_inv) <= -eps * dx_n
        up_ok = u_open | (E_inv * Adx <= eps * dx_n[:, None])
        lo_ok = l_open | (E_inv * Adx >= -eps * dx_n[:, None])
        dual_inf = ((dx_n > 1e-10) & cert_d1 & cert_d2
                    & torch.all(up_ok & lo_ok, dim=1))
        return prim_inf, dual_inf

    x, z, y = s['x_start'], s['z_start'], s['y_start']
    rho_scale = torch.ones((), dtype=dtype, device=dev)
    Minv = factor(rho_base)
    it = 0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    it_vec = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp = torch.full((B,), float('inf'), dtype=dtype, device=dev)
    rd = rp.clone()
    status = torch.zeros((B,), dtype=torch.int32, device=dev)

    while not bool(done.all()) and it < st.max_iter:
        rho_vec = rho_base * rho_scale
        xn, zn, yn = x, z, y
        for _ in range(st.check_interval):
            rhs = st.sigma * xn - qs + (rho_vec * zn - yn) @ As
            xt = kkt_apply(Minv, rho_vec, rhs)
            zt = xt @ As.T
            x1 = st.alpha * xt + (1 - st.alpha) * xn
            w = st.alpha * zt + (1 - st.alpha) * zn + yn / rho_vec
            z1 = torch.minimum(torch.maximum(w, ls), us)
            yn = rho_vec * (w - z1)
            xn, zn = x1, z1
        mask = done[:, None]
        dx = torch.where(mask, torch.zeros_like(x), xn - x)
        dy = torch.where(mask, torch.zeros_like(y), yn - y)
        x = torch.where(mask, x, xn)
        z = torch.where(mask, z, zn)
        y = torch.where(mask, y, yn)
        it += st.check_interval
        rp, rd, rp_den, rd_den, ok = residuals(z, x @ As.T, x @ Ps.T,
                                               y @ As)
        p_inf, d_inf = infeasibility(dx, dy, dx @ Ps.T, dx @ As.T, dy @ As)
        newly = ok & ~done
        it_vec = torch.where(newly, torch.full_like(it_vec, it), it_vec)
        status = torch.where(ok & (status == 0), 1, status)
        status = torch.where(p_inf & (status == 0), -3, status)
        status = torch.where(d_inf & (status == 0), -4, status)
        done = done | ok | p_inf | d_inf

        if st.adaptive_rho:
            # batch-shared adaptive rho: geometric mean of per-instance
            # OSQP residual ratios over still-active instances, so M stays
            # a single shared matrix (refactorization = one warm NS)
            ratio = torch.sqrt(
                (rp / torch.clamp(rp_den, min=1e-10))
                / torch.clamp(rd / torch.clamp(rd_den, min=1e-10), min=1e-10))
            active = ~done
            log_r = torch.where(active,
                                torch.log(torch.clamp(ratio, 1e-6, 1e6)),
                                torch.zeros_like(ratio))
            n_act = max(int(active.sum()), 1)
            comb = torch.exp(torch.sum(log_r) / n_act)
            tol = st.adaptive_rho_tolerance
            change = bool(((comb > tol) | (comb < 1.0 / tol)) & active.any())
            step_f = torch.clamp(comb if change else torch.ones_like(comb),
                                 0.1, 10.0)
            rho_scale = torch.clamp(rho_scale * step_f, 1e-6, 1e6)
            if change:
                Minv = factor(rho_base * rho_scale, Minv_warm=Minv)

    it_vec = torch.where(done, it_vec, torch.full_like(it_vec, it))
    return finish(x, z, y, it_vec, status, rp, rd)
