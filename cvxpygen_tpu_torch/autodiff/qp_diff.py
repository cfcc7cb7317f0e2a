"""Implicit differentiation of the QP solution map, as a torch autograd
function.

Port of the JAX package's ``autodiff/qp_diff.py`` (its ``jax.custom_vjp``
becomes a ``torch.autograd.Function``).  Forward: the port's batched ADMM
(``admm_solve``: kernel K3 or K2 on the card per ``use_pallas``; or
``admm_solve_shared``, kernel K1, when the batch shares P and A).
Backward: active-set detection from the dual and the slack, one reduced
KKT solve with static regularization and three refinement sweeps against
the unregularized KKT, assembly of dP, dq, dA, dl, du, then the chain
through the canonicalization maps' transpose back to theta.  The KKT is
factored by LU in the solve's own dtype.

Derivation (box QP, rows l <= Ax <= u, active rows A_a x = c_a):
    stationarity  P x + q + A_a' y_a = 0     (y in OSQP sign convention)
    K = [[P, A_a'], [A_a, 0]],  K [rx; ry] = [g; 0]  (g = dL/dx)
    dL/dq = -rx ;  dL/dc_a = ry ;  dL/dP = -(rx x' + x rx')/2
    dL/dA_a = -(y_a rx' + ry x')
"""
from __future__ import annotations

import torch

from ..runtime.solver import use_shared_path
from ..runtime.torch_family import (TorchFamily, canon_batch,
                                    canon_batch_shared, qp_bounds_batch)
from ..solvers.admm import ADMMSettings, admm_solve
from ..solvers.admm_shared import admm_solve_shared

ACT_EPS = 1e-7
REG = 1e-6


def _forward(tf: TorchFamily, theta, settings, shared):
    """The batched solve plus the canonical data the backward needs."""
    if shared:
        data = canon_batch_shared(tf, theta)
        l, u = qp_bounds_batch(tf, data['b'])
        res = admm_solve_shared(data['P'], data['q'], data['A'], l, u,
                                tf.n_zero, settings)
        B = data['q'].shape[0]
        P = data['P'].expand(B, *data['P'].shape)
        A = data['A'].expand(B, *data['A'].shape)
    else:
        data = canon_batch(tf, theta)
        l, u = qp_bounds_batch(tf, data['b'])
        res = admm_solve(data['P'], data['q'], data['A'], l, u, tf.n_zero,
                         settings)
        P, A = data['P'], data['A']
    return res, P, A, data['q'], data['d'], l, u


def qp_vjp(tf: TorchFamily, theta, x, y, z, P, q, A, l, u, gx, gy, gobj):
    """dL/dtheta (B, p) of the QP solution map at the solve (x, y, z) for
    upstream gradients gx (B, n), gy (B, m) and gobj (B,)."""
    B, n = x.shape
    m = A.shape[1]
    dtype, dev = x.dtype, x.device
    # objective term: obj(theta) = 0.5 x'Px + q'x + d with x(theta); the
    # indirect part via dobj/dx = Px + q joins gx, the explicit parts join
    # dP, dq, dd below
    Px = torch.matmul(P, x[..., None])[..., 0]
    gx = gx + gobj[:, None] * (Px + q)

    act_low = (y < -ACT_EPS) | (torch.abs(z - l) < ACT_EPS)
    act_up = (y > ACT_EPS) | (torch.abs(z - u) < ACT_EPS)
    act = act_low | act_up
    mask = act.to(dtype)

    Am = A * mask[:, :, None]
    N = n + m
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    diag_m = torch.arange(n, N, device=dev)
    K = torch.zeros((B, N, N), dtype=dtype, device=dev)
    K[:, :n, :n] = P + REG * eye_n
    K[:, :n, n:] = Am.transpose(1, 2)
    K[:, n:, :n] = Am
    def pick(on, off):
        return torch.where(act, torch.tensor(on, dtype=dtype, device=dev),
                           torch.tensor(off, dtype=dtype, device=dev))
    K[:, diag_m, diag_m] = pick(-REG, -1.0 / REG)

    rhs = torch.cat([gx, gy * mask], dim=1)
    lu, piv = torch.linalg.lu_factor(K)

    def kkt_solve(r):
        return torch.linalg.lu_solve(lu, piv, r[..., None])[..., 0]

    sol = kkt_solve(rhs)
    # refinement against the unregularized KKT (3 sweeps, as the reference's
    # grad template cpg_osqp_grad_compute.c.jinja2:456-490)
    K_true = K.clone()
    K_true[:, :n, :n] -= REG * eye_n
    K_true[:, diag_m, diag_m] = pick(0.0, -1.0 / REG)
    for _ in range(3):
        r = rhs - torch.matmul(K_true, sol[..., None])[..., 0]
        sol = sol + kkt_solve(r)
    rx = sol[:, :n]
    ry = sol[:, n:] * mask

    dq = -rx
    dP = -0.5 * (rx[:, :, None] * x[:, None, :]
                 + x[:, :, None] * rx[:, None, :])
    dA = -(y[:, :, None] * rx[:, None, :] + ry[:, :, None] * x[:, None, :])
    dl = torch.where(act_low & ~act_up, ry, 0.0)
    du = torch.where(act_up & ~act_low, ry, 0.0)
    deq = torch.where(act_low & act_up, ry, 0.0)

    dP = dP + gobj[:, None, None] * 0.5 * (x[:, :, None] * x[:, None, :])
    dq = dq + gobj[:, None] * x
    db = -(dl + du + deq)   # l = -b (all rows), u = -b (zero rows)
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


def make_diff_solve(tf: TorchFamily, settings: ADMMSettings = None,
                    shared_PA=False, pa_mask=None):
    """Build a differentiable batched solve: theta (B, p) -> dict(x, y, obj)
    whose tensors carry autograd through the solve (cvxpylayers-compatible;
    reference cpg_solver.py.jinja2:176-213).

    ``shared_PA=True``: the caller asserts every batch row shares the
    canonical P/A (only vector parameters vary), and the forward runs the
    shared-KKT path (solvers/admm_shared.py, kernel K1 on the card).
    ``'auto'`` decides per call from theta and ``pa_mask`` (runtime/
    solver.py::pa_theta_mask and use_shared_path): the port can always
    inspect theta, where the reference's traced theta cannot be."""
    settings = settings or ADMMSettings()
    if shared_PA == 'auto' and pa_mask is None:
        raise ValueError("shared_PA='auto' needs the family's pa_mask")

    class _Solve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, theta, shared):
            res, P, A, q, d, l, u = _forward(tf, theta, settings, shared)
            ctx.save_for_backward(theta, res['x'], res['y'], res['z'], P, q,
                                  A, l, u)
            return res['x'], res['y'], res['obj'] + d

        @staticmethod
        def backward(ctx, gx, gy, gobj):
            theta, x, y, z, P, q, A, l, u = ctx.saved_tensors
            gx = torch.zeros_like(x) if gx is None else gx
            gy = torch.zeros_like(y) if gy is None else gy
            gobj = (torch.zeros_like(x[:, 0]) if gobj is None else gobj)
            return qp_vjp(tf, theta, x, y, z, P, q, A, l, u, gx, gy,
                          gobj), None

    def solve(theta):
        theta = torch.atleast_2d(torch.as_tensor(theta)).to(
            device=tf.maps.device, dtype=tf.maps.dtype)
        shared = use_shared_path(pa_mask, theta, shared_PA)
        x, y, obj = _Solve.apply(theta, shared)
        return dict(x=x, y=y, obj=obj)

    return solve
