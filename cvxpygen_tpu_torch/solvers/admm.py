"""OSQP-style ADMM settings and the Newton-Schulz KKT inverse, in torch.

Port of the JAX package's ``solvers/admm.py``: ``ADMMSettings`` keeps the
same fields and defaults (the tests assert it), and the Newton-Schulz
helpers compute the same batched SPD inverse with ``torch.matmul``.

Problem form:  min 0.5 x'Px + q'x  s.t.  l <= A x <= u  (rows 0..n_eq are
equalities, l==u).  Default settings mirror reference osqp.py:102-115
(rho=0.1, sigma=1e-6, alpha=1.6, eps 1e-3, max_iter 4000) with adaptive_rho
off.

Precision: every matmul of a solve runs in full float32 (or float64), never
TF32; ``full_f32_matmul`` switches TF32 off for the duration of a solve and
restores the caller's setting.  The reference's bf16 bulk phase of the cold
Newton-Schulz start is specific to its TPU build; the port runs the full-
precision branch on every device.

``admm_solve`` is the per-instance batched solve (every instance has its own
P and A).  Three engines run it:

- kernel K2 (ops/admm_full_kernel.py), the whole solve, with
  ``use_pallas='full'``: the CUDA kernel on the card, its plain torch
  version on the CPU or with ``'full_interpret'``;
- the torch loop with kernel K3 (ops/admm_kernel.py) for each check
  interval's iterations, with 'auto' (CUDA, KKT mode 'ns') or 'always'
  (KKT mode 'ns' or 'inv'; K3's plain version on the CPU).  K3 applies
  M^-1 without the refinement sweep, as the reference's kernel does;
- the torch loop alone, with 'never' (and 'auto' off the card).

On CUDA, a shape a kernel cannot take raises; nothing drops to the loop.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

_INF = 1e30  # parity: reference replace_inf (utils.py:213-228)


@dataclass(frozen=True)
class ADMMSettings:
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    max_iter: int = 4000
    check_interval: int = 25
    scaling: int = 10
    warm_starting: bool = True
    # KKT application mode:
    #   'ns'   Newton-Schulz iterations for M^{-1}: pure batched matmuls;
    #   'inv'  Cholesky once + explicit inverse (good on CPU/float64);
    #   'chol' triangular solves every iteration (reference-like);
    #   'auto' 'ns' on CUDA, 'inv' on the CPU.
    kkt_solver: str = 'auto'
    kkt_refine: int = 1
    # cold Newton-Schulz sweeps from the diagonal start
    ns_iters: int = 16
    # hand-written kernel selection (the field keeps the reference's name).
    # Shared-KKT solve: 'auto'/'always'/'full' launch kernel K1 on CUDA
    # tensors (ops/admm_shared_kernel.py).  Per-instance solve: 'full'
    # launches kernel K2, 'auto' (CUDA) and 'always' launch kernel K3 once
    # per check interval.  'full_interpret' runs the whole-solve kernel's
    # plain torch version, 'never' runs the torch loop.
    use_pallas: str = 'auto'
    # reference: full-precision tail of its mixed-precision cold start; the
    # port is full precision throughout, and kernel K2 keeps only its
    # branch (the certificate rescue runs when ns_iters > ns_f32_iters)
    ns_f32_iters: int = 5
    # adaptive rho (OSQP section 5.2): rescale by the normalized residual
    # ratio at each check; re-"factorization" is a warm Newton-Schulz
    # restart.  Off by default (reference comparison settings pin it off).
    adaptive_rho: bool = False
    adaptive_rho_tolerance: float = 5.0
    ns_adapt_iters: int = 8
    # stop adapting rho after this many iterations (0 = never stop)
    adaptive_rho_until: int = 0


@contextlib.contextmanager
def full_f32_matmul():
    """Full-precision float32 matmuls (no TF32) inside the block; the
    caller's setting is restored on exit (the reference runs its solves
    under ``jax.default_matmul_precision('highest')``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _inf_norm(v, axis=-1):
    return torch.amax(torch.abs(v), dim=axis)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _ns_diag_start(M):
    """Diagonal-preconditioner NS start X0 = diag(M)^{-1} rescaled so
    eig(M X0) in (0, 1] -- monotone NS from any SPD M.  M is (B, n, n)."""
    n = M.shape[-1]
    dg = torch.diagonal(M, dim1=1, dim2=2)
    dg_inv = 1.0 / torch.clamp(dg, min=1e-12)
    ninf = torch.amax(torch.sum(torch.abs(M * dg_inv[:, None, :]), dim=2),
                      dim=1)
    scale = dg_inv / torch.clamp(ninf, min=1.0)[:, None]
    return _eye(n, M)[None] * scale[:, None, :]


def ns_residual_err(M, X):
    """Per-instance ||I - M X||_inf (entrywise): the NS convergence
    certificate.  NaN iterates compare as 'not < threshold', so err-based
    guards catch divergence AND overflow."""
    n = M.shape[-1]
    R = _eye(n, M)[None] - torch.matmul(M, X)
    return torch.amax(torch.abs(R), dim=(1, 2))


def _ns_sweeps(M, X, iters):
    I2 = 2.0 * _eye(M.shape[-1], M)
    for _ in range(iters):
        X = torch.matmul(X, I2 - torch.matmul(M, X))
    return X


def _ns_rescue(M, X, iters):
    """Recompute, from the monotone diagonal start, every instance whose
    residual certificate ||I - MX|| is not below 0.05."""
    bad = ~(ns_residual_err(M, X) < 0.05)
    if not bool(bad.any()):
        return X
    Xr = _ns_sweeps(M, _ns_diag_start(M), iters)
    return torch.where(bad[:, None, None], Xr, X)


def newton_schulz_inverse(M, iters):
    """Batched SPD inverse by Newton-Schulz, X <- X(2I - MX), from the
    diagonal preconditioner start: the reference's full-precision branch
    (its bf16 bulk phase, and with it ``ns_f32_iters``, exists only on its
    TPU build)."""
    return _ns_sweeps(M, _ns_diag_start(M), iters)


def newton_schulz_warm(M, X0, iters):
    """Newton-Schulz restarted from a previous inverse (adaptive-rho
    refactorization).  X0 is rescaled by ||M X0||_inf >= lambda_max so
    eig(M X0) lies in (0, 1] -- monotone convergence from any SPD warm
    start -- and the certificate rescue guards a contaminated X0."""
    ninf = torch.amax(torch.sum(torch.abs(torch.matmul(M, X0)), dim=2), dim=1)
    X0 = X0 / torch.clamp(ninf, min=1.0)[:, None, None]
    X = _ns_sweeps(M, X0, iters)
    return _ns_rescue(M, X, max(iters, 30))


def ruiz_equilibrate(P, q, A, l, u, iters):
    """Modified Ruiz scaling on [[P, A'],[A, 0]] + cost scaling c (OSQP
    paper alg. 2), batched over the leading axis.  Returns
    (P, q, A, l, u, c, D, E) scaled."""
    B, m, n = A.shape
    dtype, dev = P.dtype, P.device
    c = torch.ones((B,), dtype=dtype, device=dev)
    D = torch.ones((B, n), dtype=dtype, device=dev)
    E = torch.ones((B, m), dtype=dtype, device=dev)

    def inv_sqrt(v):
        return torch.where(v > 1e-12,
                           1.0 / torch.sqrt(torch.clamp(v, min=1e-12)),
                           torch.ones_like(v))

    for _ in range(iters):
        nx_P = torch.amax(torch.abs(P), dim=1)                   # (B, n)
        nx_A = torch.amax(torch.abs(A), dim=1) if m else torch.zeros_like(nx_P)
        nx = torch.maximum(nx_P, nx_A)
        nc = torch.amax(torch.abs(A), dim=2) if m else E
        dx = torch.clamp(inv_sqrt(nx), 1e-4, 1e4)
        dc = torch.clamp(inv_sqrt(nc), 1e-4, 1e4)
        P = dx[:, :, None] * P * dx[:, None, :]
        A = dc[:, :, None] * A * dx[:, None, :]
        q = dx * q
        D = D * dx
        E = E * dc
        # cost scaling (OSQP scaling.c: each zero norm is replaced by 1
        # before the max, so q == 0 cannot inflate the cost)
        col = torch.mean(torch.amax(torch.abs(P), dim=1), dim=1)
        col = torch.where(col < 1e-12, torch.ones_like(col), col)
        qn = _inf_norm(q)
        qn = torch.where(qn < 1e-12, torch.ones_like(qn), qn)
        g = torch.clamp(1.0 / torch.maximum(col, qn), 1e-4, 1e4)
        P = P * g[:, None, None]
        q = q * g[:, None]
        c = c * g
    return P, q, A, E * l, E * u, c, D, E


_USE_PALLAS = ('auto', 'always', 'never', 'full', 'full_interpret')


def _scale(P, q, A, l, u, n_eq, st, x0, y0):
    """Ruiz-scaled problem data, base rho and scaled starting point."""
    B, m, n = A.shape
    dtype, dev = P.dtype, P.device
    # clamp infinities (parity with generated C: +-1e30)
    l = torch.clamp(l, -_INF, _INF)
    u = torch.clamp(u, -_INF, _INF)
    Ps, qs, As, ls, us, c, D, E = ruiz_equilibrate(P, q, A, l, u, st.scaling)
    s = dict(Ps=Ps, qs=qs, As=As, ls=ls, us=us, c=c, D=D, E=E)
    # per-row rho: equalities get rho_eq_scale * rho (OSQP convention); a
    # per-instance scale factor carries adaptive rho
    is_eq = torch.arange(m, device=dev) < n_eq
    s['rho_base'] = torch.where(
        is_eq, torch.full((m,), st.rho * st.rho_eq_scale, dtype=dtype,
                          device=dev),
        torch.full((m,), st.rho, dtype=dtype, device=dev)
    ).expand(B, m).contiguous()
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=dev).to(dtype)
        s['x_start'] = (1.0 / D) * x0
        s['z_start'] = E * torch.matmul(A, x0[..., None])[..., 0]
    else:
        s['x_start'] = torch.zeros((B, n), dtype=dtype, device=dev)
        s['z_start'] = torch.zeros((B, m), dtype=dtype, device=dev)
    s['y_start'] = (c[:, None] * (1.0 / E)
                    * torch.as_tensor(y0, device=dev).to(dtype)
                    if y0 is not None
                    else torch.zeros((B, m), dtype=dtype, device=dev))
    return s


def _full_args(s):
    return (s['Ps'], s['qs'], s['As'], s['ls'], s['us'], s['rho_base'],
            s['D'], s['E'], 1.0 / s['c'], s['x_start'], s['z_start'],
            s['y_start'])


def full_kernel_kwargs(st: ADMMSettings):
    """Keyword arguments of kernel K2 for these settings."""
    return dict(sigma=st.sigma, alpha=st.alpha, eps_abs=st.eps_abs,
                eps_rel=st.eps_rel, check_interval=st.check_interval,
                max_iter=st.max_iter, ns_iters=st.ns_iters,
                ns_f32_iters=st.ns_f32_iters,
                ns_adapt_iters=st.ns_adapt_iters, adaptive=st.adaptive_rho,
                rho_tol=st.adaptive_rho_tolerance, kkt_refine=st.kkt_refine,
                adapt_until=st.adaptive_rho_until)


def full_kernel_args(P, q, A, l, u, n_eq, settings: ADMMSettings, x0=None,
                     y0=None):
    """The positional arguments that admm_solve hands to kernel K2
    (ops/admm_full_kernel.py) for this batch: the Ruiz-scaled data, the base
    rho, the scaling factors and the scaled start."""
    with full_f32_matmul():
        return _full_args(_scale(P, q, A, l, u, n_eq, settings, x0, y0))


def admm_solve(P, q, A, l, u, n_eq, settings: ADMMSettings, x0=None, y0=None):
    """Solve a batch of QPs, each with its own P (B, n, n) and A (B, m, n).

    Returns dict(x, y, z, obj, iters, pri_res, dua_res, solved, status)
    with y in the OSQP sign convention (Px + q + A'y = 0 at the optimum)."""
    with full_f32_matmul():
        return _admm_solve_impl(P, q, A, l, u, n_eq, settings, x0, y0)


def _admm_solve_impl(P, q, A, l, u, n_eq, st: ADMMSettings, x0, y0):
    B, m, n = A.shape
    dtype, dev = P.dtype, P.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if m == 0:
        Lc = torch.linalg.cholesky(P + st.sigma * _eye(n, P))
        x = torch.cholesky_solve(-q[..., None], Lc)[..., 0]
        obj = (0.5 * torch.einsum('bi,bij,bj->b', x, P, x)
               + torch.sum(q * x, dim=1))
        ones_i = torch.ones((B,), dtype=torch.int32, device=dev)
        return dict(x=x, y=zeros(B, 0), z=zeros(B, 0), obj=obj, iters=ones_i,
                    pri_res=zeros(B), dua_res=zeros(B),
                    solved=torch.ones((B,), dtype=torch.bool, device=dev),
                    status=ones_i)

    s = _scale(P, q, A, l, u, n_eq, st, x0, y0)
    Ps, qs, As, ls, us = s['Ps'], s['qs'], s['As'], s['ls'], s['us']
    c, D, E = s['c'], s['D'], s['E']
    c_inv, D_inv, E_inv = 1.0 / c, 1.0 / D, 1.0 / E
    rho_base = s['rho_base']

    if st.kkt_solver not in ('auto', 'ns', 'inv', 'chol'):
        raise ValueError(
            f"ADMMSettings.kkt_solver={st.kkt_solver!r}: expected one of "
            "'auto', 'ns', 'inv', 'chol'")
    if st.use_pallas not in _USE_PALLAS:
        raise ValueError(
            f"ADMMSettings.use_pallas={st.use_pallas!r}: expected one of "
            + ', '.join(repr(v) for v in _USE_PALLAS))
    kkt_mode = st.kkt_solver
    if kkt_mode == 'auto':
        kkt_mode = 'ns' if dev.type == 'cuda' else 'inv'
    adaptive = st.adaptive_rho and kkt_mode != 'chol'

    def finish(x, z, y, obj, it_vec, status, rp, rd):
        obj = torch.where(status == -3, torch.full_like(obj, float('inf')),
                          obj)
        obj = torch.where(status == -4, torch.full_like(obj, -float('inf')),
                          obj)
        return dict(x=D * x, y=c_inv[:, None] * E * y, z=E_inv * z, obj=obj,
                    iters=it_vec, pri_res=rp, dua_res=rd,
                    solved=(status == 1), status=status)

    if st.use_pallas in ('full', 'full_interpret'):
        # the whole solve in kernel K2 (ops/admm_full_kernel.py)
        from ..ops.admm_full_kernel import (admm_solve_full,
                                            admm_solve_full_plain)
        solve = (admm_solve_full_plain if st.use_pallas == 'full_interpret'
                 else admm_solve_full)
        return finish(*solve(*_full_args(s), **full_kernel_kwargs(st)))

    def form_M(rho_vec):
        return ((Ps + st.sigma * _eye(n, Ps))
                + torch.matmul(As.transpose(1, 2), As * rho_vec[:, :, None]))

    def factor(rho_vec, Minv_warm=None):
        M = form_M(rho_vec)
        if kkt_mode == 'ns':
            if Minv_warm is None:
                return newton_schulz_inverse(M, st.ns_iters)
            return newton_schulz_warm(M, Minv_warm, st.ns_adapt_iters)
        Lc = torch.linalg.cholesky(M)
        if kkt_mode == 'chol':
            return Lc  # keep the factor; triangular solves every iteration
        return torch.cholesky_solve(_eye(n, M).expand(B, n, n), Lc)

    def mv(W, v):
        return torch.matmul(W, v[..., None])[..., 0]

    def vm(v, W):
        return torch.matmul(v[:, None, :], W)[:, 0]

    def M_matvec(rho_vec, x):
        # M x without materializing M (used by iterative refinement)
        return mv(Ps, x) + st.sigma * x + vm(rho_vec * mv(As, x), As)

    def kkt_apply(Minv, rho_vec, rhs):
        if kkt_mode == 'chol':
            return torch.cholesky_solve(rhs[..., None], Minv)[..., 0]
        xt = mv(Minv, rhs)
        for _ in range(st.kkt_refine):
            xt = xt + mv(Minv, rhs - M_matvec(rho_vec, xt))
        return xt

    # the fused iteration kernel K3 applies M^-1 without refinement
    use_k3 = False
    if st.use_pallas == 'auto':
        use_k3 = kkt_mode == 'ns' and dev.type == 'cuda'
    elif st.use_pallas == 'always':
        use_k3 = kkt_mode in ('ns', 'inv')
    if use_k3:
        from ..ops.admm_kernel import admm_iterate, pick_iterate_block
        k3_block = pick_iterate_block(B, m, n)
        if k3_block is None:
            raise ValueError(f'fused iteration kernel: n={n}, m={m} does not '
                             'fit shared memory')

    u_open = us >= _INF * 0.5
    l_open = ls <= -_INF * 0.5
    u_fin = torch.where(u_open, torch.zeros_like(us), us * E_inv)
    l_fin = torch.where(l_open, torch.zeros_like(ls), ls * E_inv)

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

    def infeasibility(dx, dy, Pdx, Adx, Atdy):
        """OSQP section 3.4 certificates per instance (scaled space with the
        unscaling factors applied).  Returns (prim_inf, dual_inf)."""
        eps = 1e-4
        Edy = E * dy
        dy_n = _inf_norm(Edy) * c_inv
        cert_p1 = _inf_norm(D_inv * Atdy) * c_inv <= eps * dy_n
        sup = torch.sum(u_fin * torch.clamp(Edy, min=0.0)
                        + l_fin * torch.clamp(Edy, max=0.0), dim=1) * c_inv
        open_dir = (torch.any((dy > 1e-12) & u_open, dim=1)
                    | torch.any((dy < -1e-12) & l_open, dim=1))
        prim_inf = (dy_n > 1e-10) & cert_p1 & (sup <= -eps * dy_n) & ~open_dir
        dx_n = _inf_norm(D * dx)
        cert_d1 = _inf_norm(D_inv * Pdx) * c_inv <= eps * dx_n
        cert_d2 = torch.sum(qs * dx, dim=1) * c_inv <= -eps * dx_n
        up_ok = u_open | (E_inv * Adx <= eps * dx_n[:, None])
        lo_ok = l_open | (E_inv * Adx >= -eps * dx_n[:, None])
        dual_inf = ((dx_n > 1e-10) & cert_d1 & cert_d2
                    & torch.all(up_ok & lo_ok, dim=1))
        return prim_inf, dual_inf

    x, z, y = s['x_start'], s['z_start'], s['y_start']
    rho_scale = torch.ones((B,), dtype=dtype, device=dev)
    Minv = factor(rho_base)
    it = 0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    it_vec = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp = torch.full((B,), float('inf'), dtype=dtype, device=dev)
    rd = rp.clone()
    status = torch.zeros((B,), dtype=torch.int32, device=dev)

    while not bool(done.all()) and it < st.max_iter:
        rho_vec = rho_base * rho_scale[:, None]
        if use_k3:
            xn, zn, yn = admm_iterate(Minv, As, qs, ls, us, rho_vec, x, z, y,
                                      st.sigma, st.alpha, st.check_interval,
                                      block=k3_block)
        else:
            xn, zn, yn = x, z, y
            for _ in range(st.check_interval):
                rhs = st.sigma * xn - qs + vm(rho_vec * zn - yn, As)
                xt = kkt_apply(Minv, rho_vec, rhs)
                zt = mv(As, xt)
                x1 = st.alpha * xt + (1 - st.alpha) * xn
                w = st.alpha * zt + (1 - st.alpha) * zn + yn / rho_vec
                zn = torch.minimum(torch.maximum(w, ls), us)
                yn = rho_vec * (w - zn)
                xn = x1
        # freeze converged instances: batch result == single-instance result
        mask = done[:, None]
        dx = torch.where(mask, torch.zeros_like(x), xn - x)
        dy = torch.where(mask, torch.zeros_like(y), yn - y)
        x = torch.where(mask, x, xn)
        z = torch.where(mask, z, zn)
        y = torch.where(mask, y, yn)
        it += st.check_interval
        # fused check products: one pass over A/P for the residuals (x, y)
        # and the certificates (dx, dy)
        xs = torch.stack([x, dx], dim=1)                 # (B, 2, n)
        ys = torch.stack([y, dy], dim=1)                 # (B, 2, m)
        Axs = torch.matmul(xs, As.transpose(1, 2))       # (B, 2, m)
        Pxs = torch.matmul(xs, Ps.transpose(1, 2))       # (B, 2, n)
        Atys = torch.matmul(ys, As)                      # (B, 2, n)
        rp, rd, rp_den, rd_den, ok = residuals(z, Axs[:, 0], Pxs[:, 0],
                                               Atys[:, 0])
        p_inf, d_inf = infeasibility(dx, dy, Pxs[:, 1], Axs[:, 1],
                                     Atys[:, 1])
        it_vec = torch.where(ok & ~done, torch.full_like(it_vec, it), it_vec)
        status = torch.where(ok & (status == 0), 1, status)
        status = torch.where(p_inf & (status == 0), -3, status)
        status = torch.where(d_inf & (status == 0), -4, status)
        done = done | ok | p_inf | d_inf

        if adaptive:
            # OSQP adaptive rho per instance; any change refactors the
            # whole batch (a warm Newton-Schulz restart in 'ns' mode)
            ratio = torch.sqrt(
                (rp / torch.clamp(rp_den, min=1e-10))
                / torch.clamp(rd / torch.clamp(rd_den, min=1e-10), min=1e-10))
            tol = st.adaptive_rho_tolerance
            change = ((ratio > tol) | (ratio < 1.0 / tol)) & ~done
            step_f = torch.clamp(
                torch.where(change, ratio, torch.ones_like(ratio)), 0.1, 10.0)
            rho_scale = torch.clamp(rho_scale * step_f, 1e-6, 1e6)
            if bool(change.any()):
                Minv = factor(rho_base * rho_scale[:, None], Minv_warm=Minv)

    it_vec = torch.where(done, it_vec, torch.full_like(it_vec, it))
    obj = c_inv * (0.5 * torch.einsum('bi,bij,bj->b', x, Ps, x)
                   + torch.sum(qs * x, dim=1))
    return finish(x, z, y, obj, it_vec, status, rp, rd)
