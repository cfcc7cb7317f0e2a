"""Shared-KKT batched conic ADMM: P and A shared across the batch, in torch.

Port of the JAX package's ``solvers/conic_admm_shared.py``, the conic
analogue of solvers/admm_shared.py (SCS role): when a batch of conic
instances differs only in vector parameters (entropy with varying c, ADP
with fixed G), the canonical P/A -- and so M = P + sigma I + A' diag(rho) A
-- are batch-invariant:

- one (n, n) M^-1 for the whole batch;
- every per-iteration product is a full-batch GEMM against it;
- the cone projection stays per instance (elementwise over the batch).

Math identical to solvers/conic_admm.py.  Adaptive rho is batch-global: the
geometric mean of the active instances' ratios (summed, then divided by
their count, the reference's order), so a batch's result depends on its
composition.
"""
from __future__ import annotations

import torch

from ..ops.cones import ConeLayout
from .admm import (_eye, full_f32_matmul, newton_schulz_inverse,
                   newton_schulz_warm)
from .conic_admm import (ConicADMMSettings, _block_geomean, _cone_row_blocks,
                         _inv_sqrt, admm_loop, base_rho, certificates, finish,
                         kkt_mode_of, residual_check, shifted_projection)


def ruiz_equilibrate_conic_shared(P, A, q_batch, iters, blocks):
    """Shared-matrix Ruiz with block-uniform row scales on cone blocks
    (admm_shared.ruiz_equilibrate_shared with conic_admm's block means).
    The q envelope is the batch max |q|."""
    m, n = A.shape
    dtype, dev = P.dtype, P.device
    c = torch.ones((), dtype=dtype, device=dev)
    D = torch.ones((n,), dtype=dtype, device=dev)
    E = torch.ones((m,), dtype=dtype, device=dev)
    q_col = torch.amax(torch.abs(q_batch), dim=0)
    for _ in range(iters):
        nx_P = torch.amax(torch.abs(P), dim=0)
        nx_A = torch.amax(torch.abs(A), dim=0) if m else torch.zeros_like(nx_P)
        nx = torch.maximum(nx_P, nx_A)
        nc = torch.amax(torch.abs(A), dim=1) if m else E
        dx = torch.clamp(_inv_sqrt(nx), 1e-4, 1e4)
        dc = _block_geomean(torch.clamp(_inv_sqrt(nc), 1e-4, 1e4), blocks)
        P = dx[:, None] * P * dx[None, :]
        A = dc[:, None] * A * dx[None, :]
        q_col = dx * q_col
        D = D * dx
        E = E * dc
        col = torch.mean(torch.amax(torch.abs(P), dim=0))
        col = torch.where(col < 1e-12, 1.0, col)
        qn = torch.amax(q_col)
        qn = torch.where(qn < 1e-12, 1.0, qn)
        g = torch.clamp(1.0 / torch.maximum(col, qn), 1e-4, 1e4)
        P = P * g
        q_col = q_col * g
        c = c * g
    return P, A, c, D, E


def _rho_batch_global(ratio, done, tol):
    """Batch-global adaptive rho: the geometric mean of the active
    instances' ratios (summed, then divided by their count)."""
    active = ~done
    log_r = torch.where(active, torch.log(torch.clamp(ratio, 1e-6, 1e6)),
                        0.0)
    n_act = torch.clamp(torch.sum(active), min=1)
    comb = torch.exp(torch.sum(log_r) / n_act)
    return comb, ((comb > tol) | (comb < 1.0 / tol)) & active.any()


def conic_admm_solve_shared(P, q, A, b, n_zero: int, layout: ConeLayout,
                            settings: ConicADMMSettings = None,
                            x0=None, y0=None):
    """Solve a batch of conic QPs sharing P (n, n) and A (m, n); q (B, n),
    b (B, m) batched.  Same contract and returns as
    conic_admm.conic_admm_solve."""
    with full_f32_matmul():
        return _impl(P, q, A, b, n_zero, layout,
                     settings or ConicADMMSettings(), x0, y0)


def _impl(P, q, A, b, n_zero, layout, st, x0, y0):
    m, n = A.shape
    B = q.shape[0]
    dtype, dev = P.dtype, P.device
    assert layout.total == m - n_zero, (layout.total, m - n_zero)

    Ps, As, c, D, E = ruiz_equilibrate_conic_shared(
        P, A, q, st.scaling, _cone_row_blocks(n_zero, layout))
    qs = (q * D) * c
    bs = E * b
    c_inv, E_inv = 1.0 / c, 1.0 / E
    rho_base = base_rho(st, m, n_zero, dtype, dev)
    kkt_mode = kkt_mode_of(st, dev)

    def factor(rho_vec, Minv_warm=None):
        M = Ps + st.sigma * _eye(n, Ps) + (As.T * rho_vec[None, :]) @ As
        if kkt_mode == 'ns':
            if Minv_warm is None:
                return newton_schulz_inverse(M[None], st.ns_iters)[0]
            return newton_schulz_warm(M[None], Minv_warm[None],
                                      st.ns_adapt_iters)[0]
        return torch.cholesky_solve(_eye(n, M), torch.linalg.cholesky(M))

    def kkt_apply(Minv, rho_vec, rhs):
        xt = rhs @ Minv.T
        for _ in range(st.kkt_refine):
            r = rhs - (xt @ Ps.T + st.sigma * xt + (rho_vec * (xt @ As.T)) @ As)
            xt = xt + r @ Minv.T
        return xt

    proj_C = shifted_projection(bs, n_zero, layout)
    residuals = residual_check(st, c_inv, D, E, qs)
    infeasibility = certificates(st, layout, n_zero, b, c_inv, D, E, qs)

    if x0 is not None:
        x0 = torch.as_tensor(x0, device=dev).to(dtype)
        x = (1.0 / D) * x0
        z = E * (x0 @ A.T)
    else:
        x = torch.zeros((B, n), dtype=dtype, device=dev)
        z = torch.zeros((B, m), dtype=dtype, device=dev)
    if y0 is not None:
        y = c * E_inv * torch.as_tensor(y0, device=dev).to(dtype)
    else:
        y = torch.zeros((B, m), dtype=dtype, device=dev)

    x, z, y, it_vec, status, rp, rd, it, done = admm_loop(
        st, kkt_mode, x, z, y, torch.ones((), dtype=dtype, device=dev),
        lambda scale: rho_base * scale, factor, kkt_apply,
        lambda v: v @ As.T, lambda v: v @ As, As, Ps, qs, proj_C, residuals,
        infeasibility, _rho_batch_global)
    obj = c_inv * (0.5 * torch.einsum('bi,ij,bj->b', x, Ps, x)
                   + torch.sum(qs * x, dim=1))
    return finish(x, z, y, obj, it_vec, status, rp, rd, c_inv, D, E, it,
                  done)
