"""Implicit differentiation for block-banded QP families (charging T ~
1440), as a torch autograd function.

Port of the JAX package's ``autodiff/qp_diff_banded.py``.  The dense
backward (autodiff/qp_diff.py) forms the (B, n+m, n+m) reduced KKT: at
charging T=1440 (n + m = 14405) that is about 830 MB per instance in
float32.  Here the regularized reduced KKT is eliminated to the
block-tridiagonal normal form

    H rx = gx + A_a' gy_a / eps,   H = P + eps I + A_a' A_a / eps
    ry   = (A_a rx - gy_a) / eps           (active rows a)

where H has the banded pattern of the solver's M = P + sigma I + A' rho A:
it is assembled by ``assemble_banded_M`` with rho = act / eps and factored
by block cyclic reduction (``cr_factor``/``cr_solve``), with no dense n x n
object anywhere.  Three refinement sweeps against the unregularized saddle
KKT remove the eps bias (the schedule of qp_diff.py).  Active-set logic,
gradient assembly and the transpose-map chain to theta are qp_diff.py's,
evaluated only at the family's stored P/A nonzero coordinates.  Every
segment sum is the solver's order-fixed ``_seg_sum`` (no atomics), so the
backward repeats bitwise on the card.

The elimination scales the active rows by 1 / eps = 1e6, so H is far worse
conditioned than the saddle KKT: solved in float32 it gives gradients off
by factors of 1e3 and more (ROADMAP.md A8; the reference solves it in the
working dtype and shows the same in float32).  So the backward runs in
float64 whatever the working dtype, up to the transpose-map chain, which
runs in the working dtype.

Forward: the per-instance banded ADMM (solvers/admm_banded.py).
"""
from __future__ import annotations

import torch

from ..ops.block_tridiag import cr_factor, cr_solve
from ..runtime.torch_family import (TorchFamily, canon_batch_sparse,
                                    qp_bounds_batch)
from ..solvers.admm import ADMMSettings
from ..solvers.admm_banded import (BandedIndex, BandedStructure, _seg_sum,
                                   admm_solve_banded, assemble_banded_M,
                                   banded_index)
from .qp_diff import ACT_EPS, REG


def banded_vjp(tf: TorchFamily, st: BandedStructure, ix: BandedIndex, theta,
               x, y, z, pvals, avals, q, l, u, gx, gy, gobj):
    """dL/dtheta (B, p) of the banded QP solution map at the solve (x, y,
    z) for upstream gradients gx (B, n), gy (B, m) and gobj (B,); ``tf``
    in the scatter layout, ``ix`` the structure's index on the data's
    device."""
    B = x.shape[0]
    dtype, dev = x.dtype, x.device
    n, m, n_pad = st.n, st.m, st.n_pad
    wd = torch.float64                # the solve's dtype (module docstring)
    x, y, z, pvals, avals, q, l, u, gx, gy, gobj = (
        v.to(wd) for v in (x, y, z, pvals, avals, q, l, u, gx, gy, gobj))

    def Av(xp):                       # (B, n_pad) -> (B, m)
        return _seg_sum(avals * xp[:, ix.a_col], ix.a_row, m, ix.av_table)

    def Atv(v):                       # (B, m) -> (B, n_pad)
        return _seg_sum(avals * v[:, ix.a_row], ix.a_col, n_pad,
                        ix.atv_table)

    def Pv(xp):
        return _seg_sum(pvals * xp[:, ix.p_col], ix.p_row, n_pad,
                        ix.pv_table)

    def pad_perm(v):                  # original (B, n) -> permuted + pad
        return torch.cat([v[:, ix.order],
                          torch.zeros((B, n_pad - n), dtype=wd,
                                      device=dev)], dim=1)

    # the objective seed folds through dobj/dx = Px + q
    gx = gx + gobj[:, None] * (Pv(pad_perm(x))[:, ix.pos] + q)

    act_low = (y < -ACT_EPS) | (torch.abs(z - l) < ACT_EPS)
    act_up = (y > ACT_EPS) | (torch.abs(z - u) < ACT_EPS)
    mask = (act_low | act_up).to(wd)

    # banded H = P + REG I + A_a' A_a / REG through the solver's assembler
    # (rho = mask / REG zeroes the inactive rows), factored by CR
    Db, Lb = assemble_banded_M(st, pvals, avals, mask / REG, REG, wd, ix)
    fac = cr_factor(Db, Lb)

    def Hsolve(r):
        return cr_solve(fac, r.reshape(B, st.nb, st.s)).reshape(B, n_pad)

    gxp = pad_perm(gx)
    gyv = gy * mask
    rx = Hsolve(gxp + Atv(gyv) / REG)
    ry = mask * (Av(rx) - gyv) / REG
    # refinement against the unregularized saddle KKT (3 sweeps, as
    # qp_diff.py): each sweep solves the regularized system on the true
    # residual
    for _ in range(3):
        r1 = gxp - (Pv(rx) + Atv(mask * ry))
        r2 = mask * (gyv - Av(rx))
        crx = Hsolve(r1 + Atv(r2) / REG)
        cry = mask * (Av(crx) - r2) / REG
        rx = rx + crx
        ry = ry + cry
    rxo = rx[:, ix.pos]               # original order, (B, n)

    # gradient assembly only at the stored nonzero coordinates
    dq = -rxo + gobj[:, None] * x
    Pi, Pj = tf.P_ij[:, 0], tf.P_ij[:, 1]
    dPv = (-0.5 * (rxo[:, Pi] * x[:, Pj] + x[:, Pi] * rxo[:, Pj])
           + gobj[:, None] * 0.5 * x[:, Pi] * x[:, Pj])
    Ai, Aj = tf.A_ij[:, 0], tf.A_ij[:, 1]
    dAv = -(y[:, Ai] * rxo[:, Aj] + ry[:, Ai] * x[:, Aj])
    db = -ry                          # l = -b; u = -b on zero rows
    dvals = torch.cat([dPv, dq, gobj[:, None], dAv, db], dim=1).to(dtype)
    dtt = dvals @ tf.maps             # (B, p1): transpose-map chain
    tt = torch.cat([theta, torch.ones((B, 1), dtype=dtype, device=dev)],
                   dim=1)
    dtt = dtt + gobj.to(dtype)[:, None] * (tt @ (tf.d_quad + tf.d_quad.T))
    return dtt[:, :-1]


def make_diff_solve_banded(tf: TorchFamily, struct: BandedStructure,
                           settings: ADMMSettings = None):
    """Differentiable batched banded solve: theta (B, p) -> dict(x, y,
    obj), whose backward never forms a dense KKT (see the module
    docstring).  ``tf`` must be in the scatter layout
    (``TorchFamily.from_family(..., force_scatter=True)``); ``struct`` from
    ``build_banded_structure``."""
    if tf.dense_mode:
        raise ValueError('make_diff_solve_banded needs a scatter-mode '
                         'TorchFamily')
    settings = settings or ADMMSettings()
    st = struct
    ix = banded_index(st, tf.maps.device)

    class _Solve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, theta):
            data = canon_batch_sparse(tf, theta)
            l, u = qp_bounds_batch(tf, data['b'])
            res = admm_solve_banded(st, data['pvals'], data['q'],
                                    data['avals'], l, u, tf.n_zero,
                                    settings, index=ix)
            ctx.save_for_backward(theta, res['x'], res['y'], res['z'],
                                  data['pvals'], data['avals'], data['q'],
                                  l, u)
            return res['x'], res['y'], res['obj'] + data['d']

        @staticmethod
        def backward(ctx, gx, gy, gobj):
            theta, x, y, z, pvals, avals, q, l, u = ctx.saved_tensors
            gx = torch.zeros_like(x) if gx is None else gx
            gy = torch.zeros_like(y) if gy is None else gy
            gobj = torch.zeros_like(x[:, 0]) if gobj is None else gobj
            return banded_vjp(tf, st, ix, theta, x, y, z, pvals, avals, q,
                              l, u, gx, gy, gobj)

    def solve(theta):
        theta = torch.atleast_2d(torch.as_tensor(theta)).to(
            device=tf.maps.device, dtype=tf.maps.dtype)
        x, y, obj = _Solve.apply(theta)
        return dict(x=x, y=y, obj=obj)

    return solve
