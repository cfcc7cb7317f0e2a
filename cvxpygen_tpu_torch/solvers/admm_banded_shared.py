"""Shared-KKT block-banded batched ADMM (long-horizon families), in torch.

Port of the JAX package's ``solvers/admm_banded_shared.py``.  When the
batch shares canonical P and A (the charging family varying only prices,
MPC varying only the initial state), the banded KKT matrix
M = P + sigma I + A' diag(rho) A is ONE shared block-tridiagonal matrix:

- the cyclic-reduction factorization runs once per rho configuration at
  B = 1 (torch: ops/block_tridiag.cr_factor, packed by
  ops/banded_grouped.pack_cr_levels);
- adaptive rho is batch-shared (geometric mean over active instances, as
  in solvers/admm_shared.py), so the factorization stays shared;
- there is no solve-time refinement: CR is a direct factorization.

Two engines, picked by the block count as in the reference
(``nb <= 96``), so the port takes the same engine as the JAX package:

- ``_impl``: kernel K5 (ops/banded_shared_kernel.banded_shared_chunk)
  runs every ``check_interval`` iterations, residuals and certificates in
  one launch;
- ``_impl_crk``: K5's plain version in torch (ops/banded_shared_kernel.
  banded_shared_chunk_plain) with kernel K4 (ops/banded_shared_kernel.
  cr_solve) as its CR solve, one launch per iteration; the grouped
  A/A'/P products around it are batched ``torch.matmul`` (the reference
  leaves them to XLA outside any Pallas kernel).

Both run the same solve loop (``_run``) around their chunk function.

On CUDA tensors the kernels launch; on CPU tensors their plain versions
run.  The per-instance banded engine (solvers/admm_banded.py) covers
batches whose P or A vary.  Math follows OSQP alg. 1-3.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.banded_grouped import (GroupedA, group_rows, pack_cr_levels,
                                  scatter_grouped, ungroup_rows)
from ..ops.banded_shared_kernel import (banded_shared_chunk,
                                        banded_shared_chunk_plain, cr_solve,
                                        grouped_av)
from ..ops.block_tridiag import cr_factor
from .admm import ADMMSettings, full_f32_matmul
from .admm_banded import (BandedStructure, _resolve_index,
                          assemble_banded_M)

_INF = 1e30


def _seg_max1(vals, ids, num):
    """Segment max of NONNEGATIVE values; empty segments give 0."""
    out = torch.zeros((num,), dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids, vals, 'amax', include_self=True)


def ruiz_banded_shared(st: BandedStructure, pvals, avals, q_env, iters,
                       index=None):
    """Shared Ruiz scaling on the sparse values (single shared instance;
    same math as solvers/admm_banded.py's batched loop at B=1, with the
    batch-envelope |q| for the cost scaling as in
    solvers/admm_shared.ruiz_equilibrate_shared)."""
    ix = _resolve_index(st, index, pvals.device)
    n_pad, m = st.n_pad, st.m
    dtype, dev = pvals.dtype, pvals.device
    p_row, p_col, a_row, a_col = ix.p_row, ix.p_col, ix.a_row, ix.a_col
    c = torch.ones((), dtype=dtype, device=dev)
    D = torch.ones((n_pad,), dtype=dtype, device=dev)
    E = torch.ones((m,), dtype=dtype, device=dev)
    q_col = q_env
    n_real = st.n

    def inv_sqrt(v):
        return torch.where(v > 1e-12,
                           1.0 / torch.sqrt(torch.clamp(v, min=1e-12)),
                           torch.ones_like(v))

    for _ in range(iters):
        nx_P = _seg_max1(torch.abs(pvals), p_col, n_pad)
        nx_A = _seg_max1(torch.abs(avals), a_col, n_pad)
        nx = torch.maximum(nx_P, nx_A)
        nc = _seg_max1(torch.abs(avals), a_row, m)
        dx = torch.clamp(inv_sqrt(nx), 1e-4, 1e4)
        dc = torch.clamp(inv_sqrt(nc), 1e-4, 1e4)
        pvals = pvals * dx[p_row] * dx[p_col]
        avals = avals * dc[a_row] * dx[a_col]
        q_col = q_col * dx
        D = D * dx
        E = E * dc
        col = torch.sum(_seg_max1(torch.abs(pvals), p_col, n_pad)) / n_real
        col = torch.where(col < 1e-12, torch.ones_like(col), col)
        qn = torch.amax(torch.abs(q_col))
        qn = torch.where(qn < 1e-12, torch.ones_like(qn), qn)
        g = torch.clamp(1.0 / torch.maximum(col, qn), 1e-4, 1e4)
        pvals = pvals * g
        q_col = q_col * g
        c = c * g
    return pvals, avals, c, D, E


def admm_solve_banded_shared(st: BandedStructure, ga: GroupedA,
                             pvals, q, avals, l, u, n_eq,
                             settings: ADMMSettings, x0=None, y0=None,
                             index=None):
    """Solve a batch sharing canonical P/A.  pvals/avals (nnz,) SHARED
    values; q (B, n), l/u (B, m) batched.  Same contract as
    admm_banded.admm_solve_banded.  Kernel K5 serves nb <= 96, the loop
    around kernel K4 larger nb (the reference's switch)."""
    ix = _resolve_index(st, index, q.device, ga)
    with full_f32_matmul():
        if st.nb <= 96:
            return _impl(st, ga, pvals, q, avals, l, u, n_eq, settings,
                         x0, y0, ix)
        return _impl_crk(st, ga, pvals, q, avals, l, u, n_eq, settings,
                         x0, y0, ix)


def _setup(st, ga, pvals, q, avals, l, u, n_eq, stg, ix):
    """What both engines share: the Ruiz-scaled data, the grouped A, the
    banded P, the factorization at a given rho and the grouped layouts."""
    B = q.shape[0]
    dtype, dev = q.dtype, q.device
    n, m, n_pad, s, nb = st.n, st.m, st.n_pad, st.s, st.nb
    l = torch.clamp(l, -_INF, _INF)
    u = torch.clamp(u, -_INF, _INF)
    qp = torch.cat([q[:, ix.order],
                    torch.zeros((B, n_pad - n), dtype=dtype, device=dev)],
                   dim=1)
    q_env = torch.amax(torch.abs(qp), dim=0)
    pvals, avals, c, D, E = ruiz_banded_shared(st, pvals, avals, q_env,
                                               stg.scaling, ix)
    is_eq = torch.as_tensor(np.arange(m) < n_eq, device=dev)
    rho_base = torch.where(
        is_eq, torch.full((m,), stg.rho * stg.rho_eq_scale, dtype=dtype,
                          device=dev),
        torch.full((m,), stg.rho, dtype=dtype, device=dev))
    B0, B1 = scatter_grouped(ga, avals, ix.b0_pos, ix.b1_pos)
    D_P, L_P = assemble_banded_M(st, pvals[None], avals[None],
                                 torch.zeros((1, m), dtype=dtype, device=dev),
                                 0.0, dtype, ix)

    def factor(rho_vec):
        D_M, L_M = assemble_banded_M(st, pvals[None], avals[None],
                                     rho_vec[None], stg.sigma, dtype, ix)
        packed, meta = pack_cr_levels(cr_factor(D_M, L_M))
        return packed, meta, D_M[0], L_M[0]

    def to_x_layout(v):                  # (B, n_pad) -> (nb, s, B)
        return v.reshape(-1, nb, s).permute(1, 2, 0).contiguous()

    def to_r_layout(v, fill):            # (B, m) -> (nb, r_max, B)
        return group_rows(ga, v, fill, ix.row_slot).permute(
            1, 2, 0).contiguous()

    return dict(
        ix=ix, pvals=pvals, c=c, D=D, E=E,
        # c is a 0-d tensor: one host read per solve
        c_inv=1.0 / float(c), D_inv=1.0 / D, E_inv=1.0 / E,
        qp=qp * D[None, :] * c, ls=l * E[None, :], us=u * E[None, :],
        rho_base=rho_base, B0=B0, B1=B1, D_P=D_P[0], L_P=L_P[0],
        factor=factor, to_x_layout=to_x_layout, to_r_layout=to_r_layout)


def _finish(st, ga, S, x, z, y, it_vec, status, rp, rd):
    """Unscale, unpermute and ungroup the final state; the objective."""
    ix = S['ix']
    B = x.shape[-1]
    xf = x.permute(2, 0, 1).reshape(B, st.n_pad)           # scaled
    c_inv = S['c_inv']
    x_u = (S['D'][None, :] * xf)[:, ix.pos]
    z_u = S['E_inv'][None, :] * ungroup_rows(ga, z.permute(2, 0, 1),
                                            ix.row_slot)
    y_u = c_inv * S['E'][None, :] * ungroup_rows(ga, y.permute(2, 0, 1),
                                                ix.row_slot)
    pv = S['pvals']
    obj = c_inv * (0.5 * torch.sum(pv[None] * xf[:, ix.p_row]
                                   * xf[:, ix.p_col], dim=1)
                   + torch.sum(S['qp'] * xf, dim=1))
    obj = torch.where(status == -3, torch.full_like(obj, float('inf')), obj)
    obj = torch.where(status == -4, torch.full_like(obj, -float('inf')), obj)
    return dict(x=x_u, y=y_u, z=z_u, obj=obj, iters=it_vec, pri_res=rp,
                dua_res=rd, solved=(status == 1), status=status)


def _adapt(stg, rp, rd, rp_den, rd_den, active, rho_scale):
    """Batch-shared adaptive rho: the geometric mean of the active
    instances' OSQP residual ratios.  Returns (new scale, change); one
    host read per check interval."""
    ratio = torch.sqrt(
        (rp / torch.clamp(rp_den, min=1e-10))
        / torch.clamp(rd / torch.clamp(rd_den, min=1e-10), min=1e-10))
    log_r = torch.where(active, torch.log(torch.clamp(ratio, 1e-6, 1e6)),
                        torch.zeros_like(ratio))
    n_act = torch.clamp(torch.sum(active), min=1)
    comb = torch.exp(torch.sum(log_r) / n_act)
    tol = stg.adaptive_rho_tolerance
    change = bool(((comb > tol) | (comb < 1.0 / tol)) & active.any())
    step_f = torch.clamp(comb if change else torch.ones_like(comb), 0.1,
                         10.0)
    return torch.clamp(rho_scale * step_f, 1e-6, 1e6), change


def _start(st, ga, S, x0, y0, B, dtype, dev):
    """Scaled starting state in the grouped layouts."""
    nb, s, r_max, n, n_pad = st.nb, st.s, ga.r_max, st.n, st.n_pad
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=dev).to(dtype)
        x0p = torch.cat([x0[:, S['ix'].order],
                         torch.zeros((B, n_pad - n), dtype=dtype,
                                     device=dev)], dim=1)
        x = S['to_x_layout'](S['D_inv'][None, :] * x0p)
        # the reference forms z0 = A x0 with a segment sum over the
        # nonzeros; the grouped product is the same sum
        z = grouped_av(S['B0'], S['B1'], x)
    else:
        x = torch.zeros((nb, s, B), dtype=dtype, device=dev)
        z = torch.zeros((nb, r_max, B), dtype=dtype, device=dev)
    if y0 is not None:
        y0 = torch.as_tensor(y0, device=dev).to(dtype)
        y = S['to_r_layout'](S['c'] * S['E_inv'][None, :] * y0, 0.0)
    else:
        y = torch.zeros((nb, r_max, B), dtype=dtype, device=dev)
    return x, z, y


def _impl_crk(st, ga, pvals, q, avals, l, u, n_eq, stg, x0, y0, ix):
    """Shared-P/A banded ADMM for large nb: each check interval runs K5's
    plain version in torch with kernel K4 as its CR solve, one K4 launch
    per iteration."""
    return _run(st, ga, pvals, q, avals, l, u, n_eq, stg, x0, y0, ix,
                functools.partial(banded_shared_chunk_plain, solve=cr_solve))


def _chunk_setup(st, ga, pvals, q, avals, l, u, n_eq, stg, x0, y0, ix):
    """The scaled data and the arguments of kernel K5 at the start state:
    (S, args) with args in ``banded_shared_chunk``'s positional order up to
    ``y`` (the solve loop adds ``done``)."""
    B = q.shape[0]
    dtype, dev = q.dtype, q.device
    S = _setup(st, ga, pvals, q, avals, l, u, n_eq, stg, ix)
    ix = S['ix']
    to_x, to_r = S['to_x_layout'], S['to_r_layout']
    fac, meta, D_M, L_M = S['factor'](S['rho_base'])
    x, z, y = _start(st, ga, S, x0, y0, B, dtype, dev)
    args = [fac, meta, S['B0'], S['B1'], S['D_P'], S['L_P'], D_M, L_M,
            S['D'].reshape(st.nb, st.s),
            group_rows(ga, S['E_inv'][None], 0.0, ix.row_slot)[0],
            group_rows(ga, S['E'][None], 0.0, ix.row_slot)[0],
            group_rows(ga, S['rho_base'][None], 1.0, ix.row_slot)[0],
            S['c_inv'], to_x(S['qp']), to_r(S['ls'], -_INF),
            to_r(S['us'], _INF), x, z, y]
    return S, args


def banded_kernel_args(st, ga, pvals, q, avals, l, u, n_eq,
                       settings: ADMMSettings, x0=None, y0=None, index=None):
    """The arguments that the shared banded engine hands to its kernels on
    this batch at the start state, in ``banded_shared_chunk``'s positional
    order up to ``y`` (rho at its base value): the packed CR factor and its
    metadata (K4's and K5's), the grouped A, the banded P and M, the
    scaling and the grouped data and state."""
    ix = _resolve_index(st, index, q.device, ga)
    with full_f32_matmul():
        return _chunk_setup(st, ga, pvals, q, avals, l, u, n_eq, settings,
                            x0, y0, ix)[1]


def _impl(st, ga, pvals, q, avals, l, u, n_eq, stg, x0, y0, ix):
    """Shared-P/A banded ADMM with kernel K5 running each check interval's
    iterations, residuals and certificates."""
    return _run(st, ga, pvals, q, avals, l, u, n_eq, stg, x0, y0, ix,
                banded_shared_chunk)


def _run(st, ga, pvals, q, avals, l, u, n_eq, stg, x0, y0, ix, chunk):
    """The solve loop of both engines: ``chunk`` (K5, or K5's plain version
    around K4) runs one check interval's iterations and checks; done,
    status and the batch-shared adaptive rho are decided here."""
    B = q.shape[0]
    dtype, dev = q.dtype, q.device
    S, args = _chunk_setup(st, ga, pvals, q, avals, l, u, n_eq, stg, x0, y0,
                           ix)
    (fac, meta, B0, B1, D_P, L_P, D_M, L_M, D_x, Einv_g, E_g, rho_g0, c_inv,
     qx, lg, ug, x, z, y) = args

    check = stg.check_interval
    max_iter = (stg.max_iter // check) * check
    rho_scale = torch.ones((), dtype=dtype, device=dev)
    it = 0
    done = torch.zeros((B,), dtype=torch.int32, device=dev)
    it_vec = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp = torch.full((B,), float('inf'), dtype=dtype, device=dev)
    rd = rp.clone()
    status = torch.zeros((B,), dtype=torch.int32, device=dev)
    while not bool((done > 0).all()) and it < max_iter:
        rho_g = rho_g0 * rho_scale
        # x, z, y are updated in place by the kernel
        x, z, y, rp, rd, rp_den, rd_den, flags = chunk(
            fac, meta, B0, B1, D_P, L_P, D_M, L_M, D_x, Einv_g, E_g, rho_g,
            c_inv, qx, lg, ug, x, z, y, done.reshape(1, 1, B),
            sigma=stg.sigma, alpha=stg.alpha, eps_abs=stg.eps_abs,
            eps_rel=stg.eps_rel, check_interval=check, kkt_refine=0)
        it += check
        ok = (flags & 1) > 0
        p_inf = (flags & 2) > 0
        d_inf = (flags & 4) > 0
        it_vec = torch.where(ok & (done == 0), torch.full_like(it_vec, it),
                             it_vec)
        status = torch.where(ok & (status == 0), 1, status)
        status = torch.where(p_inf & (status == 0), -3, status)
        status = torch.where(d_inf & (status == 0), -4, status)
        done = torch.maximum(done, (ok | p_inf | d_inf).to(torch.int32))
        if stg.adaptive_rho:
            rho_scale, change = _adapt(stg, rp, rd, rp_den, rd_den,
                                       done == 0, rho_scale)
            if change:
                fac, meta, D_M, L_M = S['factor'](S['rho_base'] * rho_scale)

    it_vec = torch.where(done > 0, it_vec, torch.full_like(it_vec, it))
    return _finish(st, ga, S, x, z, y, it_vec, status, rp, rd)
