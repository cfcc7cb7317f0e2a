"""Batched conic-QP interior-point solver, in torch.

Port of the JAX package's ``solvers/ipm.py``: the engine behind the
reference's embedded conic solvers (Clarabel, ECOS, QOCO).  One Mehrotra
predictor-corrector primal-dual IPM with Nesterov-Todd scalings over
zero/nonneg/SOC cones, and dual-barrier (or two-secant primal-dual)
scalings over exp/pow/PSD cones (solvers/ipm_cones.py), batched over
parameter instances: Ruiz equilibration with block-uniform scales on cone
rows, iterative refinement of every KKT solve against the unregularized
system, primal/dual infeasibility certificates, per-instance iteration
counts and instance freezing.

KKT solve modes (``kkt_solver``):
- ``'lu'``: batched LU on the full quasidefinite 3x3 system;
- ``'ldl'``: the full symmetrized quasidefinite K factored by the
  static-pivot blocked LDL^T (ops/ldl_kernel.py: kernel K6, then the
  explicit inverse K7, or the sweep solve K8 with ``ldl_inverse=False``;
  on CPU tensors their plain versions); ``ldl_two_level`` factors the
  fixed saddle block once and the cone-scaling Schur complement per
  iteration, through K6 and K7 as well;
- ``'schur'``: dz and dnu eliminated, the SPD Schur complement inverted by
  Newton-Schulz (``torch.matmul``, no factorization); ``'schur_chol'`` and
  ``'schur_lu'`` factor it by batched Cholesky or Jacobi-scaled LU;
- ``'auto'``: on CUDA the reference's TPU policy -- ``'ldl'`` for exotic
  layouts and P == 0 layouts (the condensed Schur system squares their
  conditioning), ``'schur'`` otherwise; elsewhere ``'lu'``.

Form (canon/canonicalizer.py convention):
    min 0.5 x'Px + q'x   s.t.  E x + f = 0,   G x + h = s,  s in K
    K = R+^l x SOC(d_1..d_k) x EXP^ne x PSD(s_1..) x POW(a_1..)
Duals: P x + q - E'nu - G'z = 0, z in K*.

The reference's ``lax.while_loop`` is a Python loop here: each iteration
ends with one host read of whether every instance has finished, and
finished instances are frozen as the reference's ``status``/``it_vec``
freeze them.  The reference's ``CPG_LDL_PALLAS`` switch (its XLA lowering
on a TPU) has no counterpart: on CUDA the 'ldl' mode always runs the
kernels.  The opt-in fused factor+inverse kernels of the reference
(``CPG_LDL_FUSED=1``, ``CPG_LDL_BM_FUSED=1``) are not ported yet and raise
on CUDA; off the TPU the reference ignores them, and so does the port off
CUDA.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.ldl_batched import default_delta
from ..ops.ldl_kernel import (ldl_factor_kernel, ldl_inverse_kernel,
                              ldl_solve_kernel)
from .admm import full_f32_matmul, newton_schulz_inverse
from .ipm_cones import (ExoticCones, ExoticScaling, exotic_centrality_alpha,
                        exotic_dual_dist, exotic_init, exotic_max_step,
                        exotic_primal_dist)

_FUSED_NOT_PORTED = ('{var}=1 selects the fused LDL factor+inverse kernel '
                     '{k}, which is not ported yet: ROADMAP.md queue 1 '
                     'item 9 (kernels K9 and K10)')


@dataclass(frozen=True)
class IPMSettings:
    max_iter: int = 50
    tol_feas: float = 1e-8
    tol_gap: float = 1e-8
    tol_infeas: float = 1e-8
    static_reg: float = 1e-10
    frac_to_boundary: float = 0.99
    refine_steps: int = 1
    scaling: int = 10            # Ruiz iterations (0 disables)
    kkt_solver: str = 'auto'  # 'lu'|'schur'|'schur_chol'|'schur_lu'|'auto'
    ns_iters: int = 24           # cold Newton-Schulz iterations ('schur')
    ns_warm_iters: int = 12      # warm restart across IPM iterations
    # nonsymmetric-cone (exp/pow) neighbourhood (solvers/ipm_cones.py)
    exotic_beta: float = 2.0
    exotic_shrink: float = 0.7
    exotic_backtracks: int = 12
    exotic_frac_to_boundary: float = 0.9
    exotic_scaling: str = 'pd'   # 'pd' (two-secant) | 'dual' (mu H*(z))
    # 'ldl' KKT mode: dynamic pivot-regularization floor (0 = dtype auto,
    # ~0.1 sqrt(eps); see ops/ldl_batched.py)
    ldl_dyn_delta: float = 0.0
    # 'ldl' mode: apply the explicit inverse of the regularized K (kernel
    # K7 once per factorization, then one batched product per solve)
    # instead of sweep solves (kernel K8)
    ldl_inverse: bool = True
    # 'ldl' mode: two-level fixed-Schur factorization (the (n+mz) saddle
    # block once per solve, the (mc, mc) Schur complement per iteration);
    # only sound when P > 0 (with P = 0 the fixed block's inverse carries
    # 1/reg-scale entries), hence opt-in
    ldl_two_level: bool = False
    # HSDE infeasibility post-pass iteration budget (exotic layouts only;
    # solvers/ipm_hsde.py); it runs when any instance is still status 0 at
    # max_iter.  0 disables the pass.
    hsde_iters: int = 50

    @classmethod
    def for_dtype(cls, dtype, **overrides):
        """Defaults reachable at the given precision: float32 KKT solves
        with refinement bottom out ~1e-5, so float32 takes 3e-5
        tolerances and two refinement sweeps."""
        if dtype == torch.float32:
            base = dict(tol_feas=3e-5, tol_gap=3e-5, tol_infeas=1e-6,
                        static_reg=1e-8, refine_steps=2)
        else:
            base = {}
        base.update(overrides)
        return cls(**base)


# ---------------------------------------------------------------------------
# batched cone calculus over the static layout (l, socs)
# ---------------------------------------------------------------------------

def _soc_slices(l, socs):
    off = l
    out = []
    for d in socs:
        out.append((off, d))
        off += d
    return out


def _norm(v, dim=1):
    return torch.linalg.vector_norm(v, dim=dim)


def cone_e(B, l, socs, dtype, device=None):
    parts = [torch.ones((B, l), dtype=dtype, device=device)]
    for d in socs:
        e = torch.zeros((B, d), dtype=dtype, device=device)
        e[:, 0] = 1.0
        parts.append(e)
    return torch.cat(parts, dim=1)


def jprod(u, v, l, socs):
    parts = [u[:, :l] * v[:, :l]]
    for (o, d) in _soc_slices(l, socs):
        u0, u1 = u[:, o], u[:, o + 1:o + d]
        v0, v1 = v[:, o], v[:, o + 1:o + d]
        top = u0 * v0 + torch.sum(u1 * v1, dim=1)
        rest = u0[:, None] * v1 + v0[:, None] * u1
        parts.append(torch.cat([top[:, None], rest], dim=1))
    return torch.cat(parts, dim=1)


def jdiv(lam, v, l, socs):
    """Solve lam o u = v (arrow-matrix inverse, closed form)."""
    parts = [v[:, :l] / lam[:, :l]]
    for (o, d) in _soc_slices(l, socs):
        l0, l1 = lam[:, o], lam[:, o + 1:o + d]
        v0, v1 = v[:, o], v[:, o + 1:o + d]
        det = l0 * l0 - torch.sum(l1 * l1, dim=1)
        l1v1 = torch.sum(l1 * v1, dim=1)
        u0 = (l0 * v0 - l1v1) / det
        u1 = (v1 - u0[:, None] * l1) / l0[:, None]
        parts.append(torch.cat([u0[:, None], u1], dim=1))
    return torch.cat(parts, dim=1)


def cone_dist(v, l, socs):
    """Per-instance violation of v vs K (inf norm of the negative part /
    SOC violation): the recession-cone test of the dual-infeasibility
    certificate."""
    out = None
    if l:
        out = torch.amax(torch.clamp(-v[:, :l], min=0.0), dim=1)
    for (o, d) in _soc_slices(l, socs):
        viol = torch.clamp(_norm(v[:, o + 1:o + d]) - v[:, o], min=0.0)
        out = viol if out is None else torch.maximum(out, viol)
    return v.new_zeros((v.shape[0],)) if out is None else out


class BatchNT:
    """Nesterov-Todd scaling W (W z = W^{-T} s = lambda), batched."""

    def __init__(self, s, z, l, socs):
        self.l, self.socs = l, socs
        tiny = torch.finfo(s.dtype).tiny
        self.d_nn = torch.sqrt(torch.clamp(s[:, :l], min=tiny)
                               / torch.clamp(z[:, :l], min=tiny))
        self.soc_params = []
        for (o, d) in _soc_slices(l, socs):
            ss, zz = s[:, o:o + d], z[:, o:o + d]
            # clamp the Jordan determinants to a positive floor: near the
            # boundary the float32 cancellation can reach 0 or below
            det_s = torch.clamp(ss[:, 0] ** 2 - torch.sum(ss[:, 1:] ** 2,
                                                          dim=1), min=tiny)
            det_z = torch.clamp(zz[:, 0] ** 2 - torch.sum(zz[:, 1:] ** 2,
                                                          dim=1), min=tiny)
            sb = ss / torch.sqrt(det_s)[:, None]
            zb = zz / torch.sqrt(det_z)[:, None]
            gamma = torch.sqrt(torch.clamp(
                (1.0 + torch.sum(sb * zb, dim=1)) / 2.0, min=tiny))
            wb0 = (sb[:, 0] + zb[:, 0]) / (2 * gamma)
            wb1 = (sb[:, 1:] - zb[:, 1:]) / (2 * gamma[:, None])
            eta = (det_s / det_z) ** 0.25
            self.soc_params.append((wb0, wb1, eta, o, d))

    def _soc_apply(self, wb0, wb1, eta, v, inv):
        v0, v1 = v[:, 0], v[:, 1:]
        sgn = -1.0 if inv else 1.0
        w1v1 = torch.sum(wb1 * v1, dim=1)
        out0 = wb0 * v0 + sgn * w1v1
        out1 = (sgn * v0[:, None] * wb1 + v1
                + (w1v1 / (1.0 + wb0))[:, None] * wb1)
        scale = (1.0 / eta) if inv else eta
        return torch.cat([out0[:, None], out1], dim=1) * scale[:, None]

    def mul(self, v, inv=False):
        parts = [v[:, :self.l] * (1.0 / self.d_nn if inv else self.d_nn)]
        for (wb0, wb1, eta, o, d) in self.soc_params:
            parts.append(self._soc_apply(wb0, wb1, eta, v[:, o:o + d], inv))
        return torch.cat(parts, dim=1)

    def wtw_dense(self, B, mc, dtype, inv=False):
        """Dense W^2 (or W^{-2}) block-diagonal (B, mc, mc) matrix.  SOC
        block: W^2 = eta^2 (2 wb wb' - J); W^{-2} = eta^{-2}
        (2 (J wb)(J wb)' - J)."""
        H = torch.zeros((B, mc, mc), dtype=dtype, device=self.d_nn.device)
        idx = torch.arange(self.l, device=H.device)
        H[:, idx, idx] = self.d_nn ** (-2 if inv else 2)
        for (wb0, wb1, eta, o, d) in self.soc_params:
            wb = torch.cat([wb0[:, None], wb1], dim=1)
            J = torch.ones((d,), dtype=dtype, device=H.device)
            J[1:] = -1.0
            if inv:
                wb = wb * J[None, :]
            blk = (2.0 * wb[:, :, None] * wb[:, None, :]
                   - torch.diag(J)[None])
            sc = eta ** (-2 if inv else 2)
            H[:, o:o + d, o:o + d] = blk * sc[:, None, None]
        return H


def max_step_cone(v, dv, l, socs):
    """Largest alpha in (0, inf] with v + alpha dv in the cone; batched."""
    big = 1e20
    out = torch.full((v.shape[0],), 1e20, dtype=v.dtype, device=v.device)

    def bigs(t):
        return torch.full_like(t, big)

    if l:
        neg = dv[:, :l] < 0
        cand = torch.where(neg, -v[:, :l] / torch.where(
            neg, dv[:, :l], -torch.ones_like(dv[:, :l])), bigs(v[:, :l]))
        out = torch.minimum(out, torch.amin(cand, dim=1))
    for (o, d) in _soc_slices(l, socs):
        t, x = v[:, o], v[:, o + 1:o + d]
        dt, dx = dv[:, o], dv[:, o + 1:o + d]
        a2 = dt * dt - torch.sum(dx * dx, dim=1)
        a1 = t * dt - torch.sum(x * dx, dim=1)
        a0 = t * t - torch.sum(x * x, dim=1)
        disc = a1 * a1 - a2 * a0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        quad = torch.abs(a2) > 1e-14
        # roots of a2 r^2 + 2 a1 r + a0 = 0
        r1 = torch.where(quad, (-a1 + sq) / a2, bigs(t))
        r2 = torch.where(quad, (-a1 - sq) / a2, bigs(t))
        rl = torch.where(~quad, torch.where(torch.abs(a1) > 1e-14,
                                            -a0 / (2 * a1), bigs(t)),
                         bigs(t))
        rt = torch.where(dt < 0, -t / torch.where(
            dt < 0, dt, -torch.ones_like(dt)), bigs(t))

        def pos_or_big(r):
            return torch.where((r > 1e-14) & torch.isfinite(r), r, bigs(r))

        r1, r2, rl, rt = map(pos_or_big, (r1, r2, rl, rt))
        no_cross = disc < 0
        rq = torch.where(no_cross, bigs(t), torch.minimum(r1, r2))
        alpha_soc = torch.minimum(rq, rt)
        out = torch.minimum(out, torch.where(no_cross & (dt >= 0), bigs(t),
                                             alpha_soc))
    return out


# ---------------------------------------------------------------------------
# Ruiz equilibration (block-uniform on cone rows)
# ---------------------------------------------------------------------------

def _inv_sqrt_clip(nrm):
    return torch.clamp(torch.where(nrm > 1e-12,
                                   1.0 / torch.sqrt(torch.clamp(nrm,
                                                                min=1e-12)),
                                   torch.ones_like(nrm)), 1e-4, 1e4)


def ruiz_equilibrate_ipm(P, q, E, f, G, h, blocks, iters):
    """Modified Ruiz on the stacked [E; G] rows + P columns + cost scaling,
    with one shared scale per cone block (cone invariance requires a
    uniform positive scale within each SOC/exp/PSD/pow block).  Returns the
    scaled data + (c, D, Ef, Eg) unscaling factors."""
    B, n = q.shape
    mz = E.shape[1]
    mc = G.shape[1]
    c = P.new_ones((B,))
    D = P.new_ones((B, n))
    Ef = P.new_ones((B, mz))
    Eg = P.new_ones((B, mc))
    for _ in range(iters):
        nx_P = torch.amax(torch.abs(P), dim=1)
        nx_E = torch.amax(torch.abs(E), dim=1) if mz else \
            torch.zeros_like(nx_P)
        nx_G = torch.amax(torch.abs(G), dim=1) if mc else \
            torch.zeros_like(nx_P)
        dx = _inv_sqrt_clip(torch.maximum(nx_P, torch.maximum(nx_E, nx_G)))
        de = _inv_sqrt_clip(torch.amax(torch.abs(E), dim=2)) if mz else \
            P.new_ones((B, 0))
        dg = _inv_sqrt_clip(torch.amax(torch.abs(G), dim=2))
        for (o, L) in blocks:
            gmean = torch.exp(torch.mean(torch.log(dg[:, o:o + L]), dim=1))
            dg = dg.clone()
            dg[:, o:o + L] = gmean[:, None]
        P = dx[:, :, None] * P * dx[:, None, :]
        if mz:
            E = de[:, :, None] * E * dx[:, None, :]
            f = de * f
        G = dg[:, :, None] * G * dx[:, None, :]
        h = dg * h
        q = dx * q
        D = D * dx
        Ef = Ef * de
        Eg = Eg * dg
        col = torch.mean(torch.amax(torch.abs(P), dim=1), dim=1)
        col = torch.where(col < 1e-12, torch.ones_like(col), col)
        qn = torch.amax(torch.abs(q), dim=1)
        qn = torch.where(qn < 1e-12, torch.ones_like(qn), qn)
        g = torch.clamp(1.0 / torch.maximum(col, qn), 1e-4, 1e4)
        P = P * g[:, None, None]
        q = q * g[:, None]
        c = c * g
    return P, q, E, f, G, h, c, D, Ef, Eg


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

def _mv(M, v):
    return torch.einsum('bij,bj->bi', M, v)


def _mtv(M, v):
    return torch.einsum('bij,bi->bj', M, v)


def _fused_opt_ins(device, names):
    """On CUDA, raise for the reference's opt-in fused LDL kernels (not
    ported yet); elsewhere the variables do nothing, as off the TPU in the
    reference."""
    if device.type != 'cuda':
        return
    for var, k in (('CPG_LDL_FUSED', 'K9'), ('CPG_LDL_BM_FUSED', 'K10')):
        if var in names and os.environ.get(var, '0') == '1':
            raise NotImplementedError(_FUSED_NOT_PORTED.format(var=var, k=k))


def _ldl_kinv(K, signs, st):
    """Explicit inverse of the pivot-regularized quasidefinite K: kernel K6
    then kernel K7 (their plain versions on CPU tensors).  Shared by the
    two levels of the two-level fixed-Schur path."""
    _fused_opt_ins(K.device, ('CPG_LDL_FUSED',))
    fac = ldl_factor_kernel(K, signs,
                            st.ldl_dyn_delta or default_delta(K.dtype))
    return ldl_inverse_kernel(fac)


def ipm_solve(P, q, E, f, G, h, l_nonneg: int, socs: Tuple[int, ...],
              settings: IPMSettings = IPMSettings(),
              n_exp: int = 0, psd_dims: Tuple[int, ...] = (),
              pow_alphas: Tuple[float, ...] = (), P_is_zero: bool = False):
    """Solve a batch of conic QPs.  Returns dict(x, nu, z, s, obj, iters,
    gap, res_primal, res_dual, solved, status).  Status codes match the
    ADMM engine (reference CPG_Info statuses, utils.py:977-985):
    1 solved, 0 max_iter, -3 primal infeasible, -4 dual infeasible.
    Full-precision float32 matmuls (no TF32) on the card.

    ``P_is_zero``: the caller asserts P == 0 structurally (linear-objective
    family); exotic layouts then get the homogeneous-self-dual-embedding
    post-pass for instances left undetermined at max_iter."""
    with full_f32_matmul():
        return _ipm_solve_impl(P, q, E, f, G, h, l_nonneg, tuple(socs),
                               settings, n_exp, tuple(psd_dims),
                               tuple(pow_alphas), P_is_zero)


def _ipm_solve_impl(P, q, E, f, G, h, l_nonneg, socs, st, n_exp, psd_dims,
                    pow_alphas, P_is_zero):
    B, n = q.shape
    mz = E.shape[1] if E.dim() == 3 else 0
    mc = G.shape[1]
    dtype, dev = P.dtype, P.device
    N = n + mz + mc
    exo = ExoticCones(int(n_exp), psd_dims, pow_alphas)
    ms = l_nonneg + int(sum(socs))          # symmetric rows come first
    if ms + exo.dim != mc:
        raise ValueError(f'cone layout covers {ms + exo.dim} rows, G has {mc}')

    # precision floor: float32 KKT solves + refinement bottom out ~1e-5
    eps_mach = float(torch.finfo(dtype).eps)
    tol_feas = max(st.tol_feas, 30 * eps_mach)
    tol_gap = max(st.tol_gap, 30 * eps_mach)
    tol_inf = max(st.tol_infeas, 10 * eps_mach)

    kkt_mode = st.kkt_solver
    if kkt_mode == 'auto':
        # the reference's TPU policy on the card: condensation squares the
        # conditioning of exotic layouts and of P == 0 layouts, so they
        # take the full-system LDL; symmetric layouts with P > 0 the
        # factorization-free Newton-Schulz Schur path.  Elsewhere LU.
        if dev.type == 'cuda':
            kkt_mode = 'ldl' if (exo or P_is_zero) else 'schur'
        else:
            kkt_mode = 'lu'

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    # keep unscaled data for honest termination / certificates
    P0, q0, E0, f0, G0, h0 = P, q, E, f, G, h
    if st.scaling > 0:
        eq_blocks = (_soc_slices(l_nonneg, socs)
                     + [(ms + o, L) for (o, L) in exo.blocks()])
        P, q, E, f, G, h, c_s, D_s, Ef_s, Eg_s = ruiz_equilibrate_ipm(
            P, q, E, f, G, h, eq_blocks, st.scaling)
    else:
        c_s = P.new_ones((B,))
        D_s = P.new_ones((B, n))
        Ef_s = P.new_ones((B, mz))
        Eg_s = P.new_ones((B, mc))
    c_inv = 1.0 / c_s

    e = cone_e(B, l_nonneg, socs, dtype, dev)   # symmetric central ray
    kdeg = l_nonneg + len(socs) + exo.degree

    x0 = zeros(B, n)
    nu0 = zeros(B, mz)
    s0 = torch.cat([e, exotic_init(B, exo, dtype, dev)], dim=1)
    z0 = s0
    s0_ray, z0_ray = s0, z0   # strictly interior ray (restoration lifts)
    I_n = torch.eye(n, dtype=dtype, device=dev)

    def unscale(x, nu, z, s):
        # x = D x^; nu = c^{-1} Ef nu^, z = c^{-1} Eg z^; s^ = Eg s
        return (D_s * x,
                c_inv[:, None] * Ef_s * nu if mz else nu,
                c_inv[:, None] * Eg_s * z,
                s / Eg_s)

    if mc == 0:
        # equality-constrained QP: one saddle KKT solve, no cone loop
        K = zeros(B, n + mz, n + mz)
        K[:, :n, :n] = P + st.static_reg * I_n
        if mz:
            K[:, :n, n:] = -E.transpose(1, 2)
            K[:, n:, :n] = E
        rhs = torch.cat([-q, -f], dim=1)
        sol = torch.linalg.solve(K, rhs[..., None])[..., 0]
        empty = zeros(B, 0)
        xu, nuu, _, _ = unscale(sol[:, :n], sol[:, n:], empty, empty)
        Px = _mv(P0, xu)
        obj = 0.5 * torch.sum(xu * Px, dim=1) + torch.sum(q0 * xu, dim=1)
        ry = _mv(E0, xu) + f0 if mz else zeros(B, 0)
        rp = _norm(ry)
        rd = _norm(Px + q0 - (_mtv(E0, nuu) if mz else zeros(B, n)))
        ones = torch.ones((B,), dtype=torch.int32, device=dev)
        return dict(x=xu, nu=nuu, z=empty, s=empty, obj=obj, iters=ones,
                    gap=zeros(B), res_primal=rp, res_dual=rd,
                    solved=torch.ones((B,), dtype=torch.bool, device=dev),
                    status=ones)

    # ---- 'ldl' two-level fixed-Schur precomputation ------------------
    # P/E/G are loop-invariant after equilibration: factor the (n+mz)
    # saddle block once; each iteration factors only the (mc, mc) Schur
    # complement S = H + C' Ktop^{-1} C, C = [[-G'], [0]].
    ldl_fixed = None
    if kkt_mode == 'ldl' and st.ldl_two_level and not st.ldl_inverse:
        import warnings
        warnings.warn('IPMSettings.ldl_two_level requires '
                      'ldl_inverse=True; falling back to the full-K '
                      'LDL factorization', stacklevel=3)
    if kkt_mode == 'ldl' and st.ldl_two_level and st.ldl_inverse:
        Nt = n + mz
        reg2f = max(st.static_reg, 1e-8)
        Ktop = zeros(B, Nt, Nt)
        Ktop[:, :n, :n] = P + st.static_reg * I_n
        if mz:
            Ktop[:, :n, n:] = -E.transpose(1, 2)
            Ktop[:, n:, :n] = -E
            idz = n + torch.arange(mz, device=dev)
            Ktop[:, idz, idz] = -reg2f
        signs_top = np.concatenate([np.ones(n), -np.ones(mz)])
        Ktop_inv = _ldl_kinv(Ktop, signs_top, st)
        Ct = zeros(B, Nt, mc)
        Ct[:, :n, :] = -G.transpose(1, 2)
        KiC = torch.matmul(Ktop_inv, Ct)
        T_fix = torch.matmul(Ct.transpose(1, 2), KiC)
        ldl_fixed = (Ktop_inv, KiC, T_fix)

    def residuals_unscaled(xu, nuu, zu, su):
        Px = _mv(P0, xu)
        rx = Px + q0 - _mtv(G0, zu)
        if mz:
            rx = rx - _mtv(E0, nuu)
            ry = _mv(E0, xu) + f0
        else:
            ry = zeros(B, 0)
        rz = _mv(G0, xu) + h0 - su
        return rx, ry, rz, Px

    def converged(rx, ry, rz, xu, zu, su, Px):
        obj = 0.5 * torch.sum(xu * Px, dim=1) + torch.sum(q0 * xu, dim=1)
        gap = torch.abs(torch.sum(su * zu, dim=1))
        rp = torch.maximum(_norm(ry) if mz else zeros(B), _norm(rz))
        rd = _norm(rx)
        fnorm = _norm(h0) + (_norm(f0) if mz else 0.0)
        ok = ((rp < tol_feas * torch.clamp(fnorm, min=1.0))
              & (rd < tol_feas * torch.clamp(_norm(q0), min=1.0))
              & (gap < tol_gap * torch.clamp(torch.abs(obj), min=1.0)))
        return ok, rp, rd, gap

    def infeasibility(xu, nuu, zu, membership=False):
        """Certificates on (unscaled) candidate rays: primal infeasible
        when y = (nu, z) approximately satisfies E'nu + G'z = 0, z in K*,
        f'nu + h'z < 0; dual infeasible when x approximately satisfies
        Px = 0, Ex = 0, Gx in -K, q'x < 0.  ``membership`` also requires
        z in K* (for step directions rather than iterates)."""
        y_n = torch.amax(torch.abs(zu), dim=1)
        if mz:
            y_n = torch.maximum(y_n, torch.amax(torch.abs(nuu), dim=1))
        else:
            y_n = torch.clamp(y_n, min=0.0)
        Aty = _mtv(G0, zu)
        by = torch.sum(h0 * zu, dim=1)
        if mz:
            Aty = Aty + _mtv(E0, nuu)
            by = by + torch.sum(f0 * nuu, dim=1)
        p_inf = ((y_n > 1e-8)
                 & (torch.amax(torch.abs(Aty), dim=1) <= tol_inf * y_n)
                 & (by <= -tol_inf * y_n))
        if membership:
            zdist = cone_dist(zu[:, :ms], l_nonneg, socs)
            if exo:
                zdist = torch.maximum(zdist,
                                      exotic_dual_dist(exo, zu[:, ms:]))
            p_inf = p_inf & (zdist <= tol_inf * y_n)

        x_n = torch.amax(torch.abs(xu), dim=1)
        Px = _mv(P0, xu)
        Gx = _mv(G0, xu)
        d_ok = torch.amax(torch.abs(Px), dim=1) <= tol_inf * x_n
        if mz:
            d_ok = d_ok & (torch.amax(torch.abs(_mv(E0, xu)), dim=1)
                           <= tol_inf * x_n)
        gx_dist = cone_dist(Gx[:, :ms], l_nonneg, socs)
        if exo:
            gx_dist = torch.maximum(gx_dist,
                                    exotic_primal_dist(exo, Gx[:, ms:]))
        d_ok = d_ok & (gx_dist <= tol_inf * x_n)
        d_inf = ((x_n > 1e-8) & d_ok
                 & (torch.sum(q0 * xu, dim=1) <= -tol_inf * x_n))
        return p_inf, d_inf

    # ---- KKT machinery (scaled space) ---------------------------------
    def applyH(W, ES, dz):
        """H dz over all cone rows: W(W .) on the symmetric part, dense
        block action on the exotic part."""
        Hdz = W.mul(W.mul(dz[:, :ms]))
        if exo:
            Hdz = torch.cat([Hdz, ES.apply(dz[:, ms:])], dim=1)
        return Hdz

    def apply_K(W, ES, dx, dnu, dz):
        """Unregularized KKT application for iterative refinement."""
        r1 = _mv(P, dx) - _mtv(G, dz)
        if mz:
            r1 = r1 - _mtv(E, dnu)
            r2 = _mv(E, dx)
        else:
            r2 = zeros(B, 0)
        r3 = _mv(G, dx) + applyH(W, ES, dz)
        return r1, r2, r3

    def cone_H(W, ES, inv=False):
        H = W.wtw_dense(B, mc, dtype, inv=inv)
        return ES.set_H(H, ms, inv=inv) if exo else H

    def make_solver(W, ES):
        """solve(r1, r2, r3) -> (dx, dnu, dz) for the current scalings,
        with st.refine_steps refinement sweeps."""
        if kkt_mode == 'lu':
            K = zeros(B, N, N)
            K[:, :n, :n] = P + st.static_reg * I_n
            if mz:
                K[:, :n, n:n + mz] = -E.transpose(1, 2)
                K[:, n:n + mz, :n] = E
            K[:, :n, n + mz:] = -G.transpose(1, 2)
            K[:, n + mz:, :n] = G
            K[:, n + mz:, n + mz:] = cone_H(W, ES)
            lu, piv, _ = torch.linalg.lu_factor_ex(K)

            def base_solve(r1, r2, r3):
                rhs = torch.cat([r1, r2, r3], dim=1)
                sol = torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]
                return sol[:, :n], sol[:, n:n + mz], sol[:, n + mz:]
        elif kkt_mode == 'ldl' and ldl_fixed is not None:
            # two-level fixed-Schur path: solve [[Ktop, C], [C', -H]]
            # [u; dz] = [b1; -r3]:  u0 = Ktop^{-1} b1,
            # dz = S^{-1} (r3 - G u0_x),  u = u0 - (Ktop^{-1} C) dz
            Ktop_inv, KiC, T_fix = ldl_fixed
            S_inv = _ldl_kinv(cone_H(W, ES) + T_fix, np.ones(mc), st)

            def base_solve(r1, r2, r3):
                u0 = _mv(Ktop_inv, torch.cat([r1, -r2], dim=1))
                dzv = _mv(S_inv, r3 - _mv(G, u0[:, :n]))
                u = u0 - _mv(KiC, dzv)
                return u[:, :n], u[:, n:], dzv
        elif kkt_mode == 'ldl':
            # full-system static-pivot blocked LDL': symmetrize by negating
            # rows 2-3 and the dz sign, giving the quasidefinite
            #   [[P + reg I, -E', -G'], [-E, -reg I, 0], [-G, 0, -H]],
            # which sees cond(H), not the Schur modes' cond(H)^2
            reg2 = max(st.static_reg, 1e-8)
            K = zeros(B, N, N)
            K[:, :n, :n] = P + st.static_reg * I_n
            if mz:
                K[:, :n, n:n + mz] = -E.transpose(1, 2)
                K[:, n:n + mz, :n] = -E
                idz = n + torch.arange(mz, device=dev)
                K[:, idz, idz] = -reg2
            K[:, :n, n + mz:] = -G.transpose(1, 2)
            K[:, n + mz:, :n] = -G
            K[:, n + mz:, n + mz:] = -cone_H(W, ES)
            signs = np.concatenate([np.ones(n), -np.ones(mz + mc)])
            if st.ldl_inverse:
                _fused_opt_ins(dev, ('CPG_LDL_FUSED', 'CPG_LDL_BM_FUSED'))
            fac = ldl_factor_kernel(K, signs,
                                    st.ldl_dyn_delta or default_delta(dtype))
            if st.ldl_inverse:
                # kernel K7 once per factorization; each solve one product
                Kinv = ldl_inverse_kernel(fac)

                def ldl_apply(rhs):
                    return _mv(Kinv, rhs)
            else:
                def ldl_apply(rhs):
                    return ldl_solve_kernel(fac, rhs)

            def base_solve(r1, r2, r3):
                sol = ldl_apply(torch.cat([r1, -r2, -r3], dim=1))
                return sol[:, :n], sol[:, n:n + mz], sol[:, n + mz:]
        else:
            # 'schur' / 'schur_chol' / 'schur_lu': eliminate dz, then dnu
            Hinv = cone_H(W, ES, inv=True)
            HiG = torch.matmul(Hinv, G)                       # (B, mc, n)
            S = (P + st.static_reg * I_n
                 + torch.matmul(G.transpose(1, 2), HiG))       # SPD (B, n, n)
            if kkt_mode in ('schur_chol', 'schur_lu'):
                if kkt_mode == 'schur_chol':
                    Lc = _cholesky_or_nan(S)

                    def S_solve(Xcols):
                        return torch.cholesky_solve(Xcols, Lc)

                    def small_factor(T):
                        Tc = _cholesky_or_nan(T)
                        return lambda r: torch.cholesky_solve(
                            r[..., None], Tc)[..., 0]
                else:
                    dSc = torch.sqrt(torch.clamp(torch.abs(
                        torch.diagonal(S, dim1=1, dim2=2)), min=1e-30))
                    lu_S, piv_S, _ = torch.linalg.lu_factor_ex(
                        S / dSc[:, :, None] / dSc[:, None, :])

                    def S_solve(Xcols):
                        sol = torch.linalg.lu_solve(lu_S, piv_S,
                                                    Xcols / dSc[..., None])
                        return sol / dSc[..., None]

                    def small_factor(T):
                        lu_T, piv_T, _ = torch.linalg.lu_factor_ex(T)
                        return lambda r: torch.linalg.lu_solve(
                            lu_T, piv_T, r[..., None])[..., 0]

                if mz:
                    SiEt = S_solve(E.transpose(1, 2))          # (B, n, mz)
                    T_solve = small_factor(torch.matmul(E, SiEt))

                def S_apply(rS):
                    return S_solve(rS[..., None])[..., 0]

                def T_apply(r):
                    return T_solve(r)
            else:
                Sinv = newton_schulz_inverse(S, st.ns_iters)
                if mz:
                    SiEt = torch.matmul(Sinv, E.transpose(1, 2))
                    Tinv = newton_schulz_inverse(torch.matmul(E, SiEt),
                                                 st.ns_iters)

                def S_apply(rS):
                    return _mv(Sinv, rS)

                def T_apply(r):
                    return _mv(Tinv, r)

            def base_solve(r1, r2, r3):
                rS = r1 + _mtv(HiG, r3)
                SirS = S_apply(rS)
                if mz:
                    dnu = T_apply(r2 - _mv(E, SirS))
                    dx = SirS + _mv(SiEt, dnu)
                else:
                    dnu = zeros(B, 0)
                    dx = SirS
                dz = _mv(Hinv, r3 - _mv(G, dx))
                return dx, dnu, dz

        def solve(r1, r2, r3):
            dx, dnu, dz = base_solve(r1, r2, r3)
            for _ in range(st.refine_steps):
                a1, a2, a3 = apply_K(W, ES, dx, dnu, dz)
                cx, cnu, cz = base_solve(r1 - a1, r2 - a2, r3 - a3)
                dx, dnu, dz = dx + cx, dnu + cnu, dz + cz
            return dx, dnu, dz

        return solve

    def residuals_scaled(x, nu, z, s):
        rx = _mv(P, x) + q - _mtv(G, z)
        if mz:
            rx = rx - _mtv(E, nu)
            ry = _mv(E, x) + f
        else:
            ry = zeros(B, 0)
        rz = _mv(G, x) + h - s
        return rx, ry, rz

    def res_norm(rx, ry, rz):
        return torch.sqrt(torch.sum(rx * rx, dim=1)
                          + (torch.sum(ry * ry, dim=1) if mz else 0.0)
                          + torch.sum(rz * rz, dim=1))

    if exo:
        rx0, ry0, rz0 = residuals_scaled(x0, nu0, z0, s0)
        mu00 = torch.sum(s0 * z0, dim=1) / kdeg
        inv_ratio0 = mu00 / torch.clamp(res_norm(rx0, ry0, rz0), min=1e-10)

    def step(x, nu, z, s, it, status, it_vec, streak_p, streak_d):
        done = status != 0
        rx, ry, rz = residuals_scaled(x, nu, z, s)
        mu = torch.sum(s * z, dim=1) / kdeg
        sexo, zexo = s[:, ms:], z[:, ms:]
        W = BatchNT(s[:, :ms], z[:, :ms], l_nonneg, socs)
        lam = W.mul(z[:, :ms])
        ES = ExoticScaling(exo, sexo, zexo, mu,
                           strategy=st.exotic_scaling) if exo else None
        solve = make_solver(W, ES)

        def with_ds(dx):
            return _mv(G, dx) + rz

        def max_step(v, dv):
            return torch.clamp(max_step_cone(v[:, :ms], dv[:, :ms],
                                             l_nonneg, socs), max=1e20)

        # affine direction: ds = -s - H dz for every cone type
        dx_a, dnu_a, dz_a = solve(-rx, -ry, -rz - s)
        ds_a = with_ds(dx_a)
        a_sym = torch.minimum(max_step(s, ds_a), max_step(z, dz_a))
        if exo:
            a_sym = torch.minimum(a_sym, exotic_max_step(
                exo, sexo, ds_a[:, ms:], zexo, dz_a[:, ms:]))
        alpha_aff = torch.clamp(a_sym, max=1.0)
        if exo:
            # the affine step's sigma must not pretend it can travel
            # further than the neighbourhood allows
            alpha_aff = exotic_centrality_alpha(
                exo, s, ds_a, z, dz_a, kdeg, alpha_aff,
                beta=st.exotic_beta, shrink=st.exotic_shrink,
                backtracks=st.exotic_backtracks)
        mu_aff = torch.sum((s + alpha_aff[:, None] * ds_a)
                           * (z + alpha_aff[:, None] * dz_a), dim=1) / kdeg
        sigma = torch.clamp((mu_aff / mu) ** 3, 1e-8, 1.0 - 1e-8)
        # a NaN affine direction must not poison the combined step
        sigma = torch.where(torch.isfinite(sigma), sigma,
                            torch.full_like(sigma, 0.5))
        if exo:
            # residual-balance floor: keep mu >= 0.1 res_k (mu_0/res_0)
            floor = (0.1 * res_norm(rx, ry, rz) * inv_ratio0
                     / torch.clamp(mu, min=1e-300))
            sigma = torch.maximum(sigma, torch.clamp(floor, max=1.0 - 1e-8))

        # combined direction: Mehrotra corrector on the symmetric blocks,
        # the sigma-weighted dual-barrier centering RHS on exotic blocks
        lam2 = jprod(lam, lam, l_nonneg, socs)
        corr = jprod(W.mul(ds_a[:, :ms], inv=True), W.mul(dz_a[:, :ms]),
                     l_nonneg, socs)
        dtv = sigma[:, None] * mu[:, None] * e - lam2 - corr
        rhs3 = -rz[:, :ms] + W.mul(jdiv(lam, dtv, l_nonneg, socs))
        if exo:
            rhs3 = torch.cat([rhs3, -rz[:, ms:] - sexo
                              + (sigma * mu)[:, None]
                              * ES.centering_rhs(zexo)], dim=1)
        dx, dnu, dz = solve(-rx, -ry, rhs3)
        ds = with_ds(dx)

        a_sym = torch.minimum(max_step(s, ds), max_step(z, dz))
        alpha = torch.clamp(st.frac_to_boundary * a_sym, max=1.0)
        if exo:
            a_exo = exotic_max_step(exo, sexo, ds[:, ms:], zexo, dz[:, ms:])
            alpha = torch.minimum(alpha, st.exotic_frac_to_boundary * a_exo)
            alpha = exotic_centrality_alpha(
                exo, s, ds, z, dz, kdeg, alpha, beta=st.exotic_beta,
                shrink=st.exotic_shrink, backtracks=st.exotic_backtracks)

        # freeze finished instances (where, not alpha = 0: their scaling
        # degenerates and 0 * NaN = NaN); an unfinished instance with a
        # non-finite direction or a vanishing step skips the step and is
        # lifted toward the interior ray by O(mu)
        fin = (torch.all(torch.isfinite(dx), dim=1)
               & torch.all(torch.isfinite(dz), dim=1)
               & torch.all(torch.isfinite(ds), dim=1)
               & torch.isfinite(alpha))
        if mz:
            fin = fin & torch.all(torch.isfinite(dnu), dim=1)
        bad = (~fin | (alpha < 1e-6)) & ~done
        lift = torch.clamp(mu, min=100 * eps_mach)
        s = torch.where(bad[:, None], s + lift[:, None] * s0_ray, s)
        z = torch.where(bad[:, None], z + lift[:, None] * z0_ray, z)
        msk = (done | ~fin)[:, None]
        x = torch.where(msk, x, x + alpha[:, None] * dx)
        nu = torch.where(msk, nu, nu + alpha[:, None] * dnu) if mz else nu
        z = torch.where(msk, z, z + alpha[:, None] * dz)
        s = torch.where(msk, s, s + alpha[:, None] * ds)
        it = it + 1

        xu, nuu, zu, su = unscale(x, nu, z, s)
        rxu, ryu, rzu, Pxu = residuals_unscaled(xu, nuu, zu, su)
        ok, _, _, _ = converged(rxu, ryu, rzu, xu, zu, su, Pxu)
        p_inf, d_inf = infeasibility(xu, nuu, zu)
        if exo:
            # direction-based certificates on the affine direction, held
            # on two consecutive iterations before a terminal status
            dxu, dnuu, dzu, _ = unscale(dx_a, dnu_a, dz_a, ds_a)
            p_dir, d_dir = infeasibility(dxu, dnuu, dzu, membership=True)
            streak_p = torch.where(p_dir, streak_p + 1,
                                   torch.zeros_like(streak_p))
            streak_d = torch.where(d_dir, streak_d + 1,
                                   torch.zeros_like(streak_d))
            p_inf = p_inf | (streak_p >= 2)
            d_inf = d_inf | (streak_d >= 2)
        status = torch.where(ok & ~done, torch.ones_like(status), status)
        status = torch.where(p_inf & (status == 0),
                             torch.full_like(status, -3), status)
        status = torch.where(d_inf & (status == 0),
                             torch.full_like(status, -4), status)
        it_vec = torch.where((status != 0) & ~done,
                             torch.full_like(it_vec, it), it_vec)
        return x, nu, z, s, it, status, it_vec, streak_p, streak_d

    izeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    state = (x0, nu0, z0, s0, 0, izeros, izeros, izeros, izeros)
    while state[4] < st.max_iter and not bool(torch.all(state[5] != 0)):
        state = step(*state)
    x, nu, z, s, it, status, it_vec, _, _ = state
    it_vec = torch.where(status != 0, it_vec, torch.full_like(it_vec, it))

    if exo and st.hsde_iters > 0 and bool(torch.any(status == 0)):
        # HSDE post-pass (solvers/ipm_hsde.py): instances still
        # undetermined after max_iter are classified through the
        # homogeneous embedding, whose final iterate is a Farkas ray for
        # infeasible/unbounded instances.  The ray must pass the same
        # certificate tests as the main loop, so -3/-4 is only committed
        # on a checked certificate.  Runs on the Ruiz-scaled data.
        status = _hsde_classify(
            status, P, q, E, f, G, h, l_nonneg, socs, exo, st, P_is_zero,
            mz, mc, ms, unscale, infeasibility)

    xu, nuu, zu, su = unscale(x, nu, z, s)
    rx, ry, rz, Px = residuals_unscaled(xu, nuu, zu, su)
    ok, rp, rd, gap = converged(rx, ry, rz, xu, zu, su, Px)
    obj = 0.5 * torch.sum(xu * Px, dim=1) + torch.sum(q0 * xu, dim=1)
    status = torch.where((status == 0) & ok, torch.ones_like(status), status)
    obj = torch.where(status == -3, torch.full_like(obj, float('inf')), obj)
    obj = torch.where(status == -4, torch.full_like(obj, -float('inf')), obj)
    return dict(x=xu, nu=nuu, z=zu, s=su, obj=obj, iters=it_vec, gap=gap,
                res_primal=rp, res_dual=rd, solved=(status == 1),
                status=status)


def _cholesky_or_nan(S):
    """Batched Cholesky factor, NaN for instances that are not numerically
    positive definite (the reference's jnp.linalg.cholesky semantics; the
    IPM then treats their directions as non-finite)."""
    Lc, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(Lc, float('nan')), Lc)


def _hsde_classify(status_in, P, q, E, f, G, h, l_nonneg, socs, exo, st,
                   P_is_zero, mz, mc, ms, unscale, infeasibility):
    """Classify undetermined instances through the homogeneous embedding.

    P != 0 layouts reduce to the P = 0 model through the epigraph form
        min q'x + 0.5 x'Px  ==  min_{x,t} q'x + t  s.t. x'Px <= 2t,
    encoded as the SOC  t+1 >= ||(sqrt(2) W x, t-1)||  with W'W = P from a
    batched eigendecomposition (exact for rank-deficient P)."""
    from .ipm_hsde import hsde_run
    B, n = q.shape
    kw = dict(iters=st.hsde_iters, exotic_beta=st.exotic_beta,
              exotic_shrink=st.exotic_shrink,
              exotic_backtracks=st.exotic_backtracks,
              static_reg=max(st.static_reg, 1e-8),
              refine_steps=st.refine_steps)
    if P_is_zero:
        xh, nuh, zh, sh, tau, kap = hsde_run(q, E, f, G, h, l_nonneg, socs,
                                             exo, **kw)
        x_r, z_r, s_r = xh, zh, sh
    else:
        w_eig, V = torch.linalg.eigh(P)
        W_fac = (torch.sqrt(torch.clamp(w_eig, min=0.0))[:, :, None]
                 * V.transpose(1, 2))                    # (B, n, n)
        sq2 = 2.0 ** 0.5
        q_t = torch.cat([q, q.new_ones((B, 1))], dim=1)
        E_t = torch.cat([E, E.new_zeros((B, mz, 1))], dim=2) if mz else E
        tcol = q.new_zeros((B, 1, n + 1))
        tcol[:, 0, n] = 1.0
        G_soc = torch.cat(
            [tcol, torch.cat([sq2 * W_fac, q.new_zeros((B, n, 1))], dim=2),
             tcol], dim=1)                               # (B, n+2, n+1)
        h_soc = torch.cat([q.new_ones((B, 1)), q.new_zeros((B, n)),
                           -q.new_ones((B, 1))], dim=1)
        G_e = torch.cat([G, G.new_zeros((B, mc, 1))], dim=2)
        G_t = torch.cat([G_e[:, :ms], G_soc, G_e[:, ms:]], dim=1)
        h_t = torch.cat([h[:, :ms], h_soc, h[:, ms:]], dim=1)
        xh, nuh, zh, sh, tau, kap = hsde_run(
            q_t, E_t, f, G_t, h_t, l_nonneg, socs + (n + 2,), exo, **kw)
        x_r = xh[:, :n]
        z_r = torch.cat([zh[:, :ms], zh[:, ms + n + 2:]], dim=1)
        s_r = torch.cat([sh[:, :ms], sh[:, ms + n + 2:]], dim=1)
    xu_r, nuu_r, zu_r, _ = unscale(x_r, nuh, z_r, s_r)
    p_inf, d_inf = infeasibility(xu_r, nuu_r, zu_r, membership=True)
    # a ray only exists when kappa dominates tau
    ray = kap > 10.0 * tau
    status = torch.where(ray & p_inf & (status_in == 0),
                         torch.full_like(status_in, -3), status_in)
    return torch.where(ray & d_inf & (status == 0),
                       torch.full_like(status, -4), status)
