"""Implicit differentiation of the conic-QP solution map, as a torch
autograd function.

Port of the JAX package's ``autodiff/conic_diff.py`` (its
``jax.custom_vjp`` becomes a ``torch.autograd.Function``).  The conic
solution map is differentiated directly, diffcp-style (Busseti et al.):
parameterize the cone complementarity by u = s - z with s = Proj_K(u),
z = Proj_K(u) - u; then ds = DP du, dz = (DP - I) du, DP = DProj_K(u).
The sensitivity system is
    K = [[P, -E', G'(I - DP)], [E, 0, 0], [G, 0, -DP]]
and with the adjoint w = K^{-T} [gx; 0; 0] = [wx; wnu; wu]:
    dL/dq = -wx                    dL/dP = -(wx x' + x wx')/2
    dL/dE = nu wx' - wnu x'        dL/df = -wnu
    dL/dG = z wx' - wu x'          dL/dh = -wu
(The IPM's NT-scaled KKT is not the correct linearization at an active
SOC boundary, so the backward builds K from the projection Jacobian.)

Forward, as the reference chooses it: families with exp/PSD/pow cones run
the conic ADMM (solvers/conic_admm.py), SOC-only families the IPM
(solvers/ipm.py; no ``P_is_zero``, so ``kkt_solver='auto'`` is 'schur' on
the card in float32 and 'lu' in float64, and ``IPMSettings(kkt_solver=
'ldl')`` reaches kernels K6 + K7).
Backward: K is factored by ``torch.linalg.lu_factor`` in the working dtype
(the reference's float32 factor with refinement is its TPU-only branch)
and its transpose solved once.  The upstream gradient of ``y`` is not
used, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cones import (ConeLayout, _proj_exp_block, _proj_pow_block,
                         svec_indices)
from ..runtime.torch_family import TorchFamily, canon_batch
from ..solvers.admm import full_f32_matmul
from ..solvers.ipm import IPMSettings, _soc_slices, ipm_solve

# the sensitivity matrix's regularizers (the reference's)
REG = 1e-12


def cone_layout(tf: TorchFamily) -> ConeLayout:
    return ConeLayout(n_nonneg=tf.n_nonneg, socs=tuple(tf.soc_dims),
                      n_exp=tf.n_exp, psds=tuple(tf.psd_dims),
                      pows=tuple(tf.pow_alphas))


def _forward_fn(tf: TorchFamily, settings):
    """The reference's engine choice: theta -> dict(x, obj, nu, z, s, P, q,
    E, G, d), y_canon = [nu; z]."""
    mz = tf.n_zero
    layout = cone_layout(tf)
    if tf.n_exp or tf.psd_dims or tf.pow_alphas:
        from ..solvers.conic_admm import ConicADMMSettings, conic_admm_solve
        settings = settings or ConicADMMSettings()

        def fwd(theta):
            data = canon_batch(tf, theta)
            A, b = data['A'], data['b']
            res = conic_admm_solve(data['P'], data['q'], A, b, mz, layout,
                                   settings)
            y_canon = -res['y']
            return dict(x=res['x'], obj=res['obj'], nu=y_canon[:, :mz],
                        z=y_canon[:, mz:], s=res['z'][:, mz:] + b[:, mz:],
                        P=data['P'], q=data['q'], E=A[:, :mz], G=A[:, mz:],
                        d=data['d'])
        return fwd, layout

    settings = settings or IPMSettings.for_dtype(tf.maps.dtype)

    def fwd(theta):
        data = canon_batch(tf, theta)
        A, b = data['A'], data['b']
        E, G = A[:, :mz], A[:, mz:]
        res = ipm_solve(data['P'], data['q'], E, b[:, :mz], G, b[:, mz:],
                        tf.n_nonneg, tf.soc_dims, settings)
        return dict(x=res['x'], obj=res['obj'], nu=res['nu'], z=res['z'],
                    s=res['s'], P=data['P'], q=data['q'], E=E, G=G,
                    d=data['d'])
    return fwd, layout


def conic_vjp(tf: TorchFamily, layout: ConeLayout, theta, x, nu, z, s, P, q,
              E, G, gx, gobj):
    """dL/dtheta (B, p) of the conic solution map at the solve (x, nu, z,
    s) for upstream gradients gx (B, n) and gobj (B,)."""
    B, n = x.shape
    mz, mc = nu.shape[1], z.shape[1]
    dtype, dev = x.dtype, x.device
    Px = torch.matmul(P, x[..., None])[..., 0]
    gx = gx + gobj[:, None] * (Px + q)

    DP = proj_jacobian(s - z, layout)                       # (B, mc, mc)
    I_mc = torch.eye(mc, dtype=dtype, device=dev)
    N = n + mz + mc
    K = torch.zeros((B, N, N), dtype=dtype, device=dev)
    K[:, :n, :n] = P + REG * torch.eye(n, dtype=dtype, device=dev)
    if mz:
        K[:, :n, n:n + mz] = -E.transpose(1, 2)
        K[:, n:n + mz, :n] = E
    K[:, :n, n + mz:] = torch.matmul(G.transpose(1, 2), I_mc - DP)
    K[:, n + mz:, :n] = G
    K[:, n + mz:, n + mz:] = -DP - REG * I_mc

    rhs = torch.cat([gx, torch.zeros((B, mz + mc), dtype=dtype, device=dev)],
                    dim=1)
    lu, piv = torch.linalg.lu_factor(K)
    w = torch.linalg.lu_solve(lu, piv, rhs[..., None], adjoint=True)[..., 0]
    wx, wnu, wu = w[:, :n], w[:, n:n + mz], w[:, n + mz:]

    dq = -wx + gobj[:, None] * x
    dP = (-0.5 * (wx[:, :, None] * x[:, None, :]
                  + x[:, :, None] * wx[:, None, :])
          + gobj[:, None, None] * 0.5 * (x[:, :, None] * x[:, None, :]))
    dE = nu[:, :, None] * wx[:, None, :] - wnu[:, :, None] * x[:, None, :]
    dG = z[:, :, None] * wx[:, None, :] - wu[:, :, None] * x[:, None, :]
    dA = torch.cat([dE, dG], dim=1)
    db = torch.cat([-wnu, -wu], dim=1)
    m = mz + mc
    if tf.dense_mode:
        dPv = dP.reshape(B, n * n)
        dAv = dA.reshape(B, m * n)
    else:
        dPv = dP[:, tf.P_ij[:, 0], tf.P_ij[:, 1]]
        dAv = dA[:, tf.A_ij[:, 0], tf.A_ij[:, 1]]
    dvals = torch.cat([dPv, dq, gobj[:, None], dAv, db], dim=1)
    dtt = dvals @ tf.maps          # (B, p1): transpose-map chain
    # theta-quadratic objective offset: d += tt' Dq tt
    tt = torch.cat([theta, torch.ones((B, 1), dtype=dtype, device=dev)],
                   dim=1)
    dtt = dtt + gobj[:, None] * (tt @ (tf.d_quad + tf.d_quad.T))
    return dtt[:, :-1]


def make_conic_diff_solve(tf: TorchFamily, settings=None):
    """Differentiable batched conic solve: theta (B, p) -> dict(x, y, obj)
    whose tensors carry autograd through the solve; y is the canonical dual
    [nu; z] (the Family convention).  ``settings`` are the forward engine's
    (ConicADMMSettings for exp/PSD/pow families, IPMSettings for SOC-only
    ones; by default the engine's, the IPM's for the family's dtype)."""
    fwd, layout = _forward_fn(tf, settings)

    class _Solve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, theta):
            out = fwd(theta)
            ctx.save_for_backward(theta, out['x'], out['nu'], out['z'],
                                  out['s'], out['P'], out['q'], out['E'],
                                  out['G'])
            y = torch.cat([out['nu'], out['z']], dim=1)
            return out['x'], y, out['obj'] + out['d']

        @staticmethod
        def backward(ctx, gx, gy, gobj):
            theta, x, nu, z, s, P, q, E, G = ctx.saved_tensors
            gx = torch.zeros_like(x) if gx is None else gx
            gobj = torch.zeros_like(x[:, 0]) if gobj is None else gobj
            with full_f32_matmul():
                return conic_vjp(tf, layout, theta, x, nu, z, s, P, q, E, G,
                                 gx, gobj)

    def solve(theta):
        theta = torch.atleast_2d(torch.as_tensor(theta)).to(
            device=tf.maps.device, dtype=tf.maps.dtype)
        x, y, obj = _Solve.apply(theta)
        return dict(x=x, y=y, obj=obj)

    return solve


# ---------------------------------------------------------------------------
# projection Jacobians
# ---------------------------------------------------------------------------

def proj_jacobian(u, layout: ConeLayout):
    """Derivative of Proj_K at u, block diagonal (B, mc, mc).

    nonneg: diag(u > 0).
    SOC (t, w): identity if ||w|| <= t; zero if ||w|| <= -t; else
        DP = 0.5 [[1, wb'], [wb, (1 + t/||w||) I - (t/||w||) wb wb']].
    EXP and POW: implicit differentiation of the boundary-projection KKT.
    PSD (svec): Daleckii-Krein divided differences of ReLU on the spectrum.
    """
    B, mc = u.shape
    dtype, dev = u.dtype, u.device
    DP = torch.zeros((B, mc, mc), dtype=dtype, device=dev)
    l_nn = layout.n_nonneg
    if l_nn:
        idx = torch.arange(l_nn, device=dev)
        DP[:, idx, idx] = (u[:, :l_nn] > 0).to(dtype)
    for (o, d) in _soc_slices(l_nn, layout.socs):
        DP[:, o:o + d, o:o + d] = _soc_proj_jacobian(u[:, o:o + d])
    off = l_nn + int(sum(layout.socs))
    if layout.n_exp:
        ne = layout.n_exp
        blk = _exp_proj_jacobian(
            u[:, off:off + 3 * ne].reshape(B * ne, 3)).reshape(B, ne, 3, 3)
        for k in range(ne):
            o = off + 3 * k
            DP[:, o:o + 3, o:o + 3] = blk[:, k]
        off += 3 * ne
    for s_dim in layout.psds:
        k = s_dim * (s_dim + 1) // 2
        DP[:, off:off + k, off:off + k] = _psd_proj_jacobian(
            u[:, off:off + k], s_dim)
        off += k
    for a in layout.pows:
        DP[:, off:off + 3, off:off + 3] = _pow_proj_jacobian(
            u[:, off:off + 3], a)
        off += 3
    return DP


def _soc_proj_jacobian(v):
    """DProj_SOC(v) for blocks v (B, d), t first."""
    B, d = v.shape
    dtype, dev = v.dtype, v.device
    t, w = v[:, 0], v[:, 1:]
    nw = torch.linalg.vector_norm(w, dim=1)
    nw_safe = torch.clamp(nw, min=1e-30)
    wb = w / nw_safe[:, None]
    ratio = (t / nw_safe)[:, None, None]
    blk = torch.zeros((B, d, d), dtype=dtype, device=dev)
    blk[:, 0, 0] = 0.5
    blk[:, 0, 1:] = 0.5 * wb
    blk[:, 1:, 0] = 0.5 * wb
    eye = torch.eye(d - 1, dtype=dtype, device=dev)
    blk[:, 1:, 1:] = 0.5 * ((1 + ratio) * eye
                            - ratio * wb[:, :, None] * wb[:, None, :])
    interior = (nw <= t)[:, None, None]
    polar = (nw <= -t)[:, None, None]
    blk = torch.where(interior, torch.eye(d, dtype=dtype, device=dev), blk)
    return torch.where(polar, torch.zeros_like(blk), blk)


def _boundary_jacobian(g, S):
    """DP = S^-1 - (S^-1 g g' S^-1) / (g' S^-1 g) of the implicit function
    theorem on the projection KKT x - u + mu grad f(x) = 0, f(x) = 0.  S is
    inverted without a singularity check: the masked cases may make it
    singular, and torch.where drops them."""
    Sinv = torch.linalg.inv_ex(S)[0]
    Sg = torch.matmul(Sinv, g[..., None])[..., 0]
    denom = torch.clamp(torch.sum(g * Sg, dim=1), min=1e-30)
    return Sinv - Sg[:, :, None] * Sg[:, None, :] / denom[:, None, None]


def _exp_proj_jacobian(u):
    """DProj_{K_exp}(u) for triples u (N, 3).

    Boundary case by the implicit function theorem with f(x) = x2 e^{x1/x2}
    - x3, S = I + mu H(x), g = grad f.  Interior -> I, polar -> 0, face
    cases -> the diagonal mask of the face.  Every case is computed and
    the cases are selected by masks; the clip of alpha and the 1e-30
    floors keep the unselected ones finite."""
    N = u.shape[0]
    dtype, dev = u.dtype, u.device
    x = _proj_exp_block(u)
    t = u[:, 2]
    x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2]
    mu = x3 - t                                  # multiplier >= 0

    tol = 1e-7
    nrm = torch.clamp(torch.linalg.vector_norm(u, dim=1), min=1e-30)
    interior = torch.linalg.vector_norm(x - u, dim=1) <= tol * nrm
    polar = torch.linalg.vector_norm(x, dim=1) <= tol * nrm
    face = x2 <= tol * nrm                       # on the x2 = 0 face

    x2s = torch.clamp(x2, min=1e-30)
    alpha = x1 / x2s
    ea = torch.exp(torch.clamp(alpha, -60.0, 60.0))
    g = torch.stack([ea, ea * (1.0 - alpha), -torch.ones_like(ea)], dim=1)
    # hess f = (e^a / x2) [[1, -a, 0], [-a, a^2, 0], [0, 0, 0]]
    hcoef = mu * ea / x2s
    S = torch.zeros((N, 3, 3), dtype=dtype, device=dev)
    S[:, 0, 0] = 1.0 + hcoef
    S[:, 0, 1] = -hcoef * alpha
    S[:, 1, 0] = -hcoef * alpha
    S[:, 1, 1] = 1.0 + hcoef * alpha * alpha
    S[:, 2, 2] = 1.0
    DP = _boundary_jacobian(g, S)

    I3 = torch.eye(3, dtype=dtype, device=dev).expand(N, 3, 3)
    face_mask = torch.stack([(x1 < -tol * nrm).to(dtype),
                             torch.zeros_like(x1),
                             (x3 > tol * nrm).to(dtype)], dim=1)
    DP = torch.where(face[:, None, None], I3 * face_mask[:, :, None], DP)
    DP = torch.where(polar[:, None, None], torch.zeros_like(DP), DP)
    return torch.where(interior[:, None, None], I3, DP)


def _pow_proj_jacobian(u, a):
    """DProj_{K_pow(a)}(u) for triples u (B, 3): the exp cone's
    construction with f(x) = |x3| - x1^a x2^(1-a).  Interior -> I, polar
    -> 0, the u3 ~ 0 face (projection (u1+, u2+, 0)) -> diag(u1 > 0, u2 >
    0, 0)."""
    B = u.shape[0]
    dtype, dev = u.dtype, u.device
    x = _proj_pow_block(u, a)
    u1, u2, u3 = u[:, 0], u[:, 1], u[:, 2]
    x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2]
    mu = torch.abs(u3) - torch.abs(x3)           # multiplier >= 0 off-cone

    tol = 1e-7
    nrm = torch.clamp(torch.linalg.vector_norm(u, dim=1), min=1e-30)
    interior = torch.linalg.vector_norm(x - u, dim=1) <= tol * nrm
    polar = torch.linalg.vector_norm(x, dim=1) <= tol * nrm
    degenerate = torch.abs(u3) <= tol * nrm

    x1s = torch.clamp(x1, min=1e-30)
    x2s = torch.clamp(x2, min=1e-30)
    pw = x1s ** a * x2s ** (1.0 - a)
    g = torch.stack([-a * pw / x1s, -(1.0 - a) * pw / x2s, torch.sign(x3)],
                    dim=1)
    h11 = a * (1.0 - a) * pw / (x1s * x1s)
    h12 = -a * (1.0 - a) * pw / (x1s * x2s)
    h22 = a * (1.0 - a) * pw / (x2s * x2s)
    S = torch.zeros((B, 3, 3), dtype=dtype, device=dev)
    S[:, 0, 0] = 1.0 + mu * h11
    S[:, 0, 1] = mu * h12
    S[:, 1, 0] = mu * h12
    S[:, 1, 1] = 1.0 + mu * h22
    S[:, 2, 2] = 1.0
    DP = _boundary_jacobian(g, S)

    I3 = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
    face_mask = torch.stack([(u1 > tol * nrm).to(dtype),
                             (u2 > tol * nrm).to(dtype),
                             torch.zeros_like(u1)], dim=1)
    DP = torch.where(degenerate[:, None, None], I3 * face_mask[:, :, None],
                     DP)
    DP = torch.where(polar[:, None, None], torch.zeros_like(DP), DP)
    return torch.where(interior[:, None, None], I3, DP)


def _svec_basis(s_dim):
    """The svec basis tensor U (k, s, s): U_a is the symmetric matrix whose
    svec is the a-th unit vector."""
    r, c, sc = svec_indices(s_dim)
    k = len(r)
    U = np.zeros((k, s_dim, s_dim))
    for a in range(k):
        U[a, r[a], c[a]] += 1.0 / sc[a]
        if r[a] != c[a]:
            U[a, c[a], r[a]] += 1.0 / sc[a]
    return U


def _psd_proj_jacobian(w, s_dim):
    """DProj_PSD(w) in svec coordinates (B, k, k)."""
    r, c, sc = svec_indices(s_dim)
    r = torch.as_tensor(r, device=w.device)
    c = torch.as_tensor(c, device=w.device)
    vals = w / torch.as_tensor(sc, dtype=w.dtype, device=w.device)
    X = torch.zeros((w.shape[0], s_dim, s_dim), dtype=w.dtype,
                    device=w.device)
    X[:, r, c] = vals
    X[:, c, r] = vals
    lam, Q = torch.linalg.eigh(X)
    return daleckii_krein(lam, Q, s_dim)


def daleckii_krein(lam, Q, s_dim):
    """DP[H] = Q (Gamma o (Q' H Q)) Q' in svec coordinates, Gamma the
    divided differences of ReLU on the spectrum lam (B, s) with
    eigenvectors Q (B, s, s).  Each eigenvector enters twice, so a flip of
    its sign leaves DP as it is, and so does any basis of a repeated
    eigenvalue's eigenspace (Gamma is constant on its block)."""
    dtype, dev = lam.dtype, lam.device
    r, c, sc = svec_indices(s_dim)
    scj = torch.as_tensor(sc, dtype=dtype, device=dev)
    lp = torch.clamp(lam, min=0.0)
    li, lj = lam[:, :, None], lam[:, None, :]
    dl = li - lj
    same = torch.abs(dl) <= 1e-10 * torch.clamp(torch.abs(li) + torch.abs(lj),
                                                min=1.0)
    gamma = torch.where(same, (li > 0).to(dtype),
                        (lp[:, :, None] - lp[:, None, :])
                        / torch.where(same, torch.ones_like(dl), dl))
    U = torch.as_tensor(_svec_basis(s_dim), dtype=dtype, device=dev)
    # columns of DP: svec( Q (gamma o (Q' U_a Q)) Q' )
    T1 = torch.einsum('bpi,apq,bqj->baij', Q, U, Q)
    T3 = torch.einsum('bip,bapq,bjq->baij', Q, gamma[:, None] * T1, Q)
    DP = T3[:, :, r, c] * scj                       # (B, a_col, row)
    return DP.transpose(1, 2)
