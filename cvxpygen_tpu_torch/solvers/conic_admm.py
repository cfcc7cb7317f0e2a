"""Batched SCS-style conic ADMM, in torch (the SCS route).

Port of the JAX package's ``solvers/conic_admm.py``: an operator-splitting
conic solver that batches many instances and applies one dense KKT inverse
per instance (Newton-Schulz in ``torch.matmul`` on the card, a Cholesky
inverse on the CPU), kept across iterations.

Problem form (canon/canonicalizer.py convention):
    min 0.5 x'Px + q'x   s.t.  aff = A x + b,  aff in {0}^nz x K
    K = R+^l x SOC(d_i) x EXP^ne x PSD(s_j) x POW(a_k)  (ops/cones.py)

This is OSQP's general splitting (min f(x) s.t. Ax in C) with
C = {z : z + b in {0} x K}: the box projection of the QP engine becomes a
shifted cone projection; equilibration and Newton-Schulz come from
solvers/admm.py.  Cone blocks (SOC/EXP/PSD/POW) are non-separable, so Ruiz
row scaling is averaged within each block (as SCS does).

The loop checks every ``check_interval`` iterations with one host read per
check (the termination flag and the adaptive-rho refactor flag together);
the reference's ``lax.cond`` refactor becomes a host branch there.

Duals: y (OSQP sign: Px + q + A'y = 0) with -y in K^* on cone rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.cones import ConeLayout, project_cone
from .admm import (_eye, _inf_norm, full_f32_matmul, newton_schulz_inverse,
                   newton_schulz_warm)


@dataclass(frozen=True)
class ConicADMMSettings:
    """SCS-flavored settings (the reference's scs.py registry: normalize,
    scale, rho_x, max_iters, eps_abs, eps_rel, alpha, warm_start...)."""
    rho: float = 1.0
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6          # SCS rho_x role
    alpha: float = 1.5           # SCS default over-relaxation
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_infeas: float = 1e-7
    max_iter: int = 2500
    check_interval: int = 25
    scaling: int = 10            # Ruiz iterations (SCS 'normalize')
    warm_starting: bool = True
    kkt_solver: str = 'auto'     # 'ns' | 'inv' | 'auto' ('ns' on CUDA)
    kkt_refine: int = 1
    ns_iters: int = 30
    adaptive_rho: bool = True
    adaptive_rho_tolerance: float = 5.0
    ns_adapt_iters: int = 12


def _cone_row_blocks(n_zero: int, layout: ConeLayout):
    """Row blocks (start, length) within the FULL m rows that must share one
    equilibration scale (SOC/EXP/PSD/POW blocks; zero+nonneg rows stay
    per-row)."""
    blocks = []
    off = n_zero + layout.n_nonneg
    for d in layout.socs:
        blocks.append((off, d))
        off += d
    for _ in range(layout.n_exp):
        blocks.append((off, 3))
        off += 3
    for s in layout.psds:
        k = s * (s + 1) // 2
        blocks.append((off, k))
        off += k
    for _ in layout.pows:
        blocks.append((off, 3))
        off += 3
    return blocks


def _inv_sqrt(v):
    return torch.where(v > 1e-12, 1.0 / torch.sqrt(torch.clamp(v, min=1e-12)),
                       1.0)


def _block_geomean(dc, blocks):
    """Replace each block's row scales (last axis) by their geometric
    mean."""
    dc = dc.clone()
    for (o, L) in blocks:
        dc[..., o:o + L] = torch.exp(
            torch.mean(torch.log(dc[..., o:o + L]), dim=-1, keepdim=True))
    return dc


def ruiz_equilibrate_conic(P, q, A, b, iters, blocks):
    """Modified Ruiz scaling (admm.ruiz_equilibrate) with block-uniform row
    scales on non-separable cone blocks (geometric mean within block)."""
    B, m, n = A.shape
    dtype, dev = P.dtype, P.device
    c = torch.ones((B,), dtype=dtype, device=dev)
    D = torch.ones((B, n), dtype=dtype, device=dev)
    E = torch.ones((B, m), dtype=dtype, device=dev)
    for _ in range(iters):
        nx_P = torch.amax(torch.abs(P), dim=1)
        nx_A = torch.amax(torch.abs(A), dim=1) if m else torch.zeros_like(nx_P)
        nx = torch.maximum(nx_P, nx_A)
        nc = torch.amax(torch.abs(A), dim=2) if m else E
        dx = torch.clamp(_inv_sqrt(nx), 1e-4, 1e4)
        dc = _block_geomean(torch.clamp(_inv_sqrt(nc), 1e-4, 1e4), blocks)
        P = dx[:, :, None] * P * dx[:, None, :]
        A = dc[:, :, None] * A * dx[:, None, :]
        q = dx * q
        D = D * dx
        E = E * dc
        col = torch.mean(torch.amax(torch.abs(P), dim=1), dim=1)
        col = torch.where(col < 1e-12, 1.0, col)
        qn = _inf_norm(q)
        qn = torch.where(qn < 1e-12, 1.0, qn)
        g = torch.clamp(1.0 / torch.maximum(col, qn), 1e-4, 1e4)
        P = P * g[:, None, None]
        q = q * g[:, None]
        c = c * g
    return P, q, A, E * b, c, D, E


def base_rho(st, m, n_zero, dtype, dev):
    """(m,) base rho: equality rows get rho_eq_scale * rho."""
    rho = torch.full((m,), st.rho, dtype=dtype, device=dev)
    rho[:n_zero] = st.rho * st.rho_eq_scale
    return rho


def kkt_mode_of(st, dev):
    """The KKT mode a solve on ``dev`` runs: 'auto' is 'ns' on CUDA and
    'inv' on the CPU (decided by the tensors' device)."""
    if st.kkt_solver not in ('auto', 'ns', 'inv'):
        raise ValueError(f'ConicADMMSettings.kkt_solver={st.kkt_solver!r}: '
                         "expected one of 'auto', 'ns', 'inv'")
    if st.kkt_solver == 'auto':
        return 'ns' if dev.type == 'cuda' else 'inv'
    return st.kkt_solver


def shifted_projection(bs, n_zero, layout):
    """Projection onto C = {z : z + b in {0} x K} (scaled space)."""
    z_eq = -bs[:, :n_zero]
    if bs.shape[1] == n_zero:
        return lambda w: z_eq
    b_cone = bs[:, n_zero:]

    def proj_C(w):
        return torch.cat([z_eq, project_cone(w[:, n_zero:] + b_cone, layout)
                          - b_cone], dim=1)
    return proj_C


def certificates(st, layout, n_zero, b, c_inv, D, E, qs):
    """SCS-style infeasibility certificates for C = {z : z + b in {0} x K}
    (per-instance and shared scalings broadcast alike).

    primal infeasible: A'dy -> 0, support S_C(dy) < 0; for this C,
        S_C(dy) = -b'dy + (0 if dy_cone in K_polar else +inf).
    dual infeasible: P dx -> 0, q'dx < 0, A dx in recession(C)
        (= {0} on zero rows, K on cone rows).
    The products come from the caller, fused with the residual ones."""
    B = qs.shape[0]
    dtype, dev = qs.dtype, qs.device
    m = b.shape[1]
    mc = m - n_zero
    D_inv, E_inv = 1.0 / D, 1.0 / E
    c_col = c_inv[:, None] if c_inv.dim() else c_inv
    # scaled-space slack, rounded to the working type as in the reference
    eps = float(torch.tensor(st.eps_infeas, dtype=dtype) ** 0.5)
    true_b = torch.ones((B,), dtype=torch.bool, device=dev)

    def infeasibility(dx, dy, Pdx, Adx_s, Atdy):
        Edy = E * dy
        dy_n = _inf_norm(Edy) * c_inv
        cert_p1 = _inf_norm(D_inv * Atdy) * c_inv <= eps * dy_n
        # dy_cone must be (approximately) in the polar cone: the distance
        # is ||Pi_K(dy)|| by Moreau (v = Pi_K(v) + Pi_Ko(v))
        if mc:
            dist_pol = _inf_norm(project_cone(Edy[:, n_zero:] * c_col,
                                              layout))
        else:
            dist_pol = torch.zeros((B,), dtype=dtype, device=dev)
        sup = -torch.sum(b * Edy, dim=1) * c_inv
        prim_inf = ((dy_n > 1e-10) & cert_p1
                    & (dist_pol <= eps * dy_n) & (sup <= -eps * dy_n))

        dx_n = _inf_norm(D * dx)
        Adx = Adx_s * E_inv
        cert_d1 = _inf_norm(D_inv * Pdx) * c_inv <= eps * dx_n
        cert_d2 = torch.sum(qs * dx, dim=1) * c_inv <= -eps * dx_n
        zero_ok = (_inf_norm(Adx[:, :n_zero]) <= eps * dx_n
                   if n_zero else true_b)
        if mc:
            dist_K = _inf_norm(Adx[:, n_zero:]
                               - project_cone(Adx[:, n_zero:], layout))
            cone_ok = dist_K <= eps * dx_n
        else:
            cone_ok = true_b
        dual_inf = (dx_n > 1e-10) & cert_d1 & cert_d2 & zero_ok & cone_ok
        return prim_inf, dual_inf
    return infeasibility


def residual_check(st, c_inv, D, E, qs):
    """Scaled-space OSQP residuals and the termination test."""
    D_inv, E_inv = 1.0 / D, 1.0 / E

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
    return residuals


def rho_ratio(rp, rd, rp_den, rd_den):
    """The adaptive-rho ratio sqrt(normalized rp / normalized rd)."""
    return torch.sqrt(
        (rp / torch.clamp(rp_den, min=1e-10))
        / torch.clamp(rd / torch.clamp(rd_den, min=1e-10), min=1e-10))


def update_status(ok, p_inf, d_inf, done, status, it_vec, it):
    it_vec = torch.where(ok & ~done, it, it_vec)
    status = torch.where(ok & (status == 0), 1, status)
    status = torch.where(p_inf & (status == 0), -3, status)
    status = torch.where(d_inf & (status == 0), -4, status)
    return done | ok | p_inf | d_inf, status, it_vec


def finish(x, z, y, obj, it_vec, status, rp, rd, c_inv, D, E, it, done):
    """Unscale, mark the objective of certified instances, and package."""
    c_col = c_inv[:, None] if c_inv.dim() else c_inv
    it_vec = torch.where(done, it_vec, it)
    obj = torch.where(status == -3, float('inf'), obj)
    obj = torch.where(status == -4, -float('inf'), obj)
    return dict(x=D * x, y=c_col * E * y, z=(1.0 / E) * z, obj=obj,
                iters=it_vec, pri_res=rp, dua_res=rd, solved=(status == 1),
                status=status)


def _rho_per_instance(ratio, done, tol):
    """Per-instance adaptive rho: each instance moves by its own ratio."""
    return ratio, ((ratio > tol) | (ratio < 1.0 / tol)) & ~done


def admm_loop(st, kkt_mode, x, z, y, rho_scale, rho_of, factor, kkt_apply,
              A_fwd, A_adj, As, Ps, qs, proj_C, residuals, infeasibility,
              rho_combine):
    """The ADMM iteration of both engines in the scaled space, checked every
    ``check_interval`` iterations with one host read per check.

    The engines differ in the layout of the products (``A_fwd``: A x,
    ``A_adj``: y' A, and As/Ps, which broadcast in the check's batched
    products), in ``factor``/``kkt_apply``, and in how ``rho_combine`` turns
    the per-instance ratios into the rho step (per instance, or one for the
    batch).  ``rho_of(scale)`` is the rho vector at a scale.  Returns x, z,
    y, iterations, status, residuals, the iteration count and done."""
    B = x.shape[0]
    dev = x.device
    adaptive = st.adaptive_rho and kkt_mode == 'ns'
    Minv = factor(rho_of(rho_scale))
    it = 0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    it_vec = torch.zeros((B,), dtype=torch.int32, device=dev)
    status = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp = torch.full((B,), float('inf'), dtype=x.dtype, device=dev)
    rd = rp.clone()
    all_done = False
    while not all_done and it < st.max_iter:
        rho_vec = rho_of(rho_scale)
        xn, zn, yn = x, z, y
        for _ in range(st.check_interval):
            rhs = st.sigma * xn - qs + A_adj(rho_vec * zn - yn)
            xt = kkt_apply(Minv, rho_vec, rhs)
            zt = A_fwd(xt)
            x1 = st.alpha * xt + (1 - st.alpha) * xn
            w = st.alpha * zt + (1 - st.alpha) * zn + yn / rho_vec
            zn = proj_C(w)
            yn = rho_vec * (w - zn)
            xn = x1
        mask = done[:, None]
        dx = torch.where(mask, 0.0, xn - x)
        dy = torch.where(mask, 0.0, yn - y)
        x = torch.where(mask, x, xn)
        z = torch.where(mask, z, zn)
        y = torch.where(mask, y, yn)
        it += st.check_interval
        # fused check products: one pass over A/P for the residuals (x, y)
        # and the certificates (dx, dy)
        xs = torch.stack([x, dx], dim=1)
        ys = torch.stack([y, dy], dim=1)
        Axs = torch.matmul(xs, As.transpose(-2, -1))
        Pxs = torch.matmul(xs, Ps.transpose(-2, -1))
        Atys = torch.matmul(ys, As)
        rp, rd, rp_den, rd_den, ok = residuals(z, Axs[:, 0], Pxs[:, 0],
                                               Atys[:, 0])
        p_inf, d_inf = infeasibility(dx, dy, Pxs[:, 1], Axs[:, 1],
                                     Atys[:, 1])
        done, status, it_vec = update_status(ok, p_inf, d_inf, done, status,
                                             it_vec, it)
        if adaptive:
            r, change = rho_combine(rho_ratio(rp, rd, rp_den, rd_den), done,
                                    st.adaptive_rho_tolerance)
            step_f = torch.clamp(torch.where(change, r, 1.0), 0.1, 10.0)
            new_scale = torch.clamp(rho_scale * step_f, 1e-6, 1e6)
            all_done, refactor = torch.stack(
                [done.all(), change.any()]).tolist()
            if refactor:
                Minv = factor(rho_of(new_scale), Minv_warm=Minv)
            rho_scale = new_scale
        else:
            all_done = bool(done.all())
    return x, z, y, it_vec, status, rp, rd, it, done


def conic_admm_solve(P, q, A, b, n_zero: int, layout: ConeLayout,
                     settings: ConicADMMSettings = ConicADMMSettings(),
                     x0=None, y0=None):
    """Solve a batch of conic QPs, each with its own P (B, n, n) and
    A (B, m, n).

    Returns dict(x, y, z, obj, iters, pri_res, dua_res, solved, status)
    with y in OSQP sign (Px + q + A'y = 0); y_canon = -y."""
    with full_f32_matmul():
        return _conic_admm_impl(P, q, A, b, n_zero, layout, settings, x0, y0)


def _conic_admm_impl(P, q, A, b, n_zero, layout, st, x0, y0):
    B, m, n = A.shape
    dtype, dev = P.dtype, P.device
    assert layout.total == m - n_zero, (layout.total, m - n_zero)

    Ps, qs, As, bs, c, D, E = ruiz_equilibrate_conic(
        P, q, A, b, st.scaling, _cone_row_blocks(n_zero, layout))
    c_inv, E_inv = 1.0 / c, 1.0 / E

    rho_base = base_rho(st, m, n_zero, dtype, dev).expand(B, m)
    kkt_mode = kkt_mode_of(st, dev)

    def mv(W, v):
        return torch.matmul(W, v[..., None])[..., 0]

    def vm(v, W):
        return torch.matmul(v[:, None, :], W)[:, 0]

    def factor(rho_vec, Minv_warm=None):
        M = ((Ps + st.sigma * _eye(n, Ps))
             + torch.matmul(As.transpose(1, 2), As * rho_vec[:, :, None]))
        if kkt_mode == 'ns':
            if Minv_warm is None:
                return newton_schulz_inverse(M, st.ns_iters)
            return newton_schulz_warm(M, Minv_warm, st.ns_adapt_iters)
        Lc = torch.linalg.cholesky(M)
        return torch.cholesky_solve(_eye(n, M).expand(B, n, n), Lc)

    def kkt_apply(Minv, rho_vec, rhs):
        xt = mv(Minv, rhs)
        for _ in range(st.kkt_refine):
            r = rhs - (mv(Ps, xt) + st.sigma * xt
                       + vm(rho_vec * mv(As, xt), As))
            xt = xt + mv(Minv, r)
        return xt

    proj_C = shifted_projection(bs, n_zero, layout)
    residuals = residual_check(st, c_inv, D, E, qs)
    infeasibility = certificates(st, layout, n_zero, b, c_inv, D, E, qs)

    if x0 is not None:
        x0 = torch.as_tensor(x0, device=dev).to(dtype)
        x = (1.0 / D) * x0
        z = E * mv(A, x0)
    else:
        x = torch.zeros((B, n), dtype=dtype, device=dev)
        z = torch.zeros((B, m), dtype=dtype, device=dev)
    if y0 is not None:
        y = c[:, None] * E_inv * torch.as_tensor(y0, device=dev).to(dtype)
    else:
        y = torch.zeros((B, m), dtype=dtype, device=dev)

    x, z, y, it_vec, status, rp, rd, it, done = admm_loop(
        st, kkt_mode, x, z, y, torch.ones((B,), dtype=dtype, device=dev),
        lambda scale: rho_base * scale[:, None], factor, kkt_apply,
        lambda v: mv(As, v), lambda v: vm(v, As), As, Ps, qs, proj_C,
        residuals, infeasibility, _rho_per_instance)
    obj = c_inv * (0.5 * torch.einsum('bi,bij,bj->b', x, Ps, x)
                   + torch.sum(qs * x, dim=1))
    return finish(x, z, y, obj, it_vec, status, rp, rd, c_inv, D, E, it,
                  done)
