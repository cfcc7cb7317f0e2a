"""Block-banded batched ADMM QP solver (long-horizon families), in torch.

Port of the JAX package's ``solvers/admm_banded.py``.  Long-horizon QP
families (MPC with large H, battery charging with T ~ 1440) have KKT
matrices M = P + sigma I + A' diag(rho) A that are block-tridiagonal after
a bandwidth-reducing variable permutation: dense (B, n, n) storage and
O(n^2) iteration matvecs are prohibitive at n ~ 4000.

- OFFLINE (family compile time, NumPy, copied from the JAX package): the
  structural pattern of M, a reverse-Cuthill-McKee permutation, the block
  bandwidth s, the sparse A/P index sets and the A-row nonzero PAIR
  products that assemble A' diag(rho) A directly into banded (D, L) block
  storage (``BandedStructure``, ``analyze_banded``,
  ``build_banded_structure``).
- ONLINE (torch): canonicalization emits only the nonzero values; matvecs
  are gathers + segment sums, the banded M is one segment sum over the
  precomputed pair slots, and the KKT solve is the block cyclic reduction
  of ops/block_tridiag.py, per instance.

``admm_solve_banded`` is the per-instance engine (every instance has its
own P and A values): the JAX package runs it as plain XLA, and the port as
plain torch; no hand-written kernel is on this path.  Batches that share P
and A take solvers/admm_banded_shared.py (kernels K4 and K5).

Math is that of solvers/admm.py (OSQP alg. 1-3 with Ruiz equilibration,
per-row rho, residual termination, infeasibility certificates).  Every
segment sum reads a padded gather table (``seg_table``) and adds each
segment's contributions in one fixed order, on every device: no atomics,
so a float32 set-up or solve repeats bitwise from call to call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..ops.block_tridiag import bt_matvec, cr_factor, cr_solve
from .admm import ADMMSettings, full_f32_matmul

_INF = 1e30


# ---------------------------------------------------------------------------
# offline structure analysis (NumPy, family compile time)
# ---------------------------------------------------------------------------

@dataclass
class BandedStructure:
    """Static index structure for one block-banded QP family."""
    n: int                 # original variable count
    m: int                 # constraint rows
    s: int                 # block size
    nb: int                # number of blocks (n_pad = nb * s)
    order: np.ndarray      # permuted position p holds original var order[p]
    pos: np.ndarray        # pos[v] = permuted position of original var v
    # sparse A (row, permuted col) and P (permuted row/col) indices
    a_row: np.ndarray
    a_col: np.ndarray
    p_row: np.ndarray
    p_col: np.ndarray
    # A-row nonzero pairs assembling A' diag(rho) A into banded slots
    pr_k1: np.ndarray      # index into A nnz
    pr_k2: np.ndarray
    pr_row: np.ndarray     # constraint row of the pair
    pr_slot: np.ndarray    # banded slot id
    p_slot: np.ndarray     # banded slot id per P nonzero
    diag_slot: np.ndarray  # banded slot of (i, i) for i in range(n_pad)
    n_slots: int

    @property
    def n_pad(self):
        return self.nb * self.s

    @property
    def d_size(self):
        return self.nb * self.s * self.s


def _banded_slot(i, j, s, nb):
    """Slot id for entry (i, j) in (D, L) block storage; -1 if the entry
    falls in the upper off-diagonal block (implied by symmetry) or out of
    band."""
    bi, bj = i // s, j // s
    d_size = nb * s * s
    slot = np.where(
        bi == bj, bi * s * s + (i % s) * s + (j % s),
        np.where(bi == bj + 1,
                 d_size + (bi - 1) * s * s + (i % s) * s + (j % s),
                 -1))
    return slot


def analyze_banded(P_idx, A_idx, n, m,
                   s_candidates=(4, 8, 16, 32, 48, 64),
                   min_blocks=4, density_gain=2.0) -> Optional[dict]:
    """RCM-permute the KKT pattern and find the smallest block size s that
    makes it block-tridiagonal.  Returns dict(order, pos, s, nb) or None
    (family not (usefully) banded)."""
    import scipy.sparse as spa
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    pr, pc = (np.asarray(P_idx[0], np.int64),
              np.asarray(P_idx[1], np.int64)) if len(P_idx[0]) else \
        (np.zeros(0, np.int64), np.zeros(0, np.int64))
    ar, ac = np.asarray(A_idx[0], np.int64), np.asarray(A_idx[1], np.int64)
    ones = np.ones
    Astruct = spa.coo_matrix((ones(len(ar)), (ar, ac)), shape=(m, n)).tocsr()
    Mpat = (spa.coo_matrix((ones(len(pr)), (pr, pc)), shape=(n, n))
            + Astruct.T @ Astruct + spa.eye(n)).tocsr()
    Mpat.data[:] = 1.0
    order = np.asarray(reverse_cuthill_mckee(Mpat, symmetric_mode=True),
                       dtype=np.int64)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    Mp = Mpat[order][:, order].tocoo()
    r, c = Mp.row, Mp.col
    for s in s_candidates:
        nb = -(-n // s)
        if nb < min_blocks:
            continue
        if not np.all(np.abs(r // s - c // s) <= 1):
            continue
        # only worthwhile when banded matvec/factor beats dense by a margin
        if nb * 3 * s * s * density_gain > n * n:
            return None
        return dict(order=order, pos=pos, s=int(s), nb=int(nb))
    return None


def build_banded_structure(P_idx, A_idx, n, m, **kw) -> \
        Optional[BandedStructure]:
    """Full offline analysis: permutation + pair-product slot structure."""
    info = analyze_banded(P_idx, A_idx, n, m, **kw)
    if info is None:
        return None
    order, pos, s, nb = (info['order'], info['pos'], info['s'], info['nb'])
    a_row = np.asarray(A_idx[0], np.int64)
    a_col = pos[np.asarray(A_idx[1], np.int64)]
    p_row = pos[np.asarray(P_idx[0], np.int64)] if len(P_idx[0]) else \
        np.zeros(0, np.int64)
    p_col = pos[np.asarray(P_idx[1], np.int64)] if len(P_idx[1]) else \
        np.zeros(0, np.int64)

    # A-row nonzero pairs: for each constraint row, every ordered pair of
    # nonzeros (k1, k2) contributes vals[k1]*vals[k2]*rho[row] to
    # M[col(k1), col(k2)].  Keep pairs landing in D or L (lower) slots.
    rows_order = np.argsort(a_row, kind='stable')
    sorted_rows = a_row[rows_order]
    starts = np.searchsorted(sorted_rows, np.arange(m), side='left')
    ends = np.searchsorted(sorted_rows, np.arange(m), side='right')
    k1l, k2l, rowl = [], [], []
    for rr in range(m):
        ks = rows_order[starts[rr]:ends[rr]]
        if len(ks) == 0:
            continue
        g1, g2 = np.meshgrid(ks, ks, indexing='ij')
        k1l.append(g1.ravel())
        k2l.append(g2.ravel())
        rowl.append(np.full(g1.size, rr, np.int64))
    if k1l:
        pr_k1 = np.concatenate(k1l)
        pr_k2 = np.concatenate(k2l)
        pr_row = np.concatenate(rowl)
    else:
        pr_k1 = pr_k2 = pr_row = np.zeros(0, np.int64)
    pr_slot = _banded_slot(a_col[pr_k1], a_col[pr_k2], s, nb)
    keep = pr_slot >= 0
    pr_k1, pr_k2, pr_row, pr_slot = (pr_k1[keep], pr_k2[keep],
                                     pr_row[keep], pr_slot[keep])
    p_slot = _banded_slot(p_row, p_col, s, nb)
    if np.any(p_slot < -1):
        raise AssertionError('P entry out of band')
    pk = p_slot >= 0
    # P upper off-diagonal-block entries are implied by symmetry: they are
    # dropped from the banded assembly but kept in the matvec index set
    diag = np.arange(nb * s)
    diag_slot = _banded_slot(diag, diag, s, nb)
    n_slots = nb * s * s + max(nb - 1, 0) * s * s
    return BandedStructure(
        n=n, m=m, s=s, nb=nb, order=order, pos=pos,
        a_row=a_row, a_col=a_col, p_row=p_row, p_col=p_col,
        pr_k1=pr_k1, pr_k2=pr_k2, pr_row=pr_row, pr_slot=pr_slot,
        p_slot=np.where(pk, p_slot, n_slots),  # dropped -> overflow slot
        diag_slot=diag_slot, n_slots=n_slots)


@dataclass
class BandedIndex:
    """The index arrays of a BandedStructure (and of its GroupedA, when
    given) as int64 tensors on one device: built once per compiled solver,
    not per solve."""
    device: Any
    order: Any
    pos: Any
    a_row: Any
    a_col: Any
    p_row: Any
    p_col: Any
    pr_k1: Any
    pr_k2: Any
    pr_row: Any
    slots: Any            # [pr_slot, p_slot, diag_slot]: assemble_banded_M
    # segment-sum gather tables (seg_table): M's slots, A x by row, A' y and
    # P x by column of the padded space
    m_table: Any = None
    av_table: Any = None
    atv_table: Any = None
    pv_table: Any = None
    row_slot: Any = None  # grouped layout (shared path)
    b0_pos: Any = None
    b1_pos: Any = None


def seg_table(ids, num):
    """Gather table of an order-fixed segment sum over ``num`` segments:
    (num, max_count) int64, row k the positions of the entries whose id is
    k in ascending order (the order in which ``jax.ops.segment_sum`` adds
    them on the CPU), padded with ``len(ids)``, the position of a zero
    column appended to the values.  Entries with an id >= num are left
    out.  max_count is the largest segment (at least 1); at the charging
    family's T=1440 it is 7 for M's slots, 3 for A's rows, 5 for its
    columns and 1 for P's rows."""
    ids = np.asarray(ids, np.int64)
    keep = np.nonzero(ids < num)[0]
    order = np.argsort(ids[keep], kind='stable')
    seg, pos = ids[keep][order], keep[order]
    counts = np.bincount(seg, minlength=num)
    starts = np.cumsum(counts) - counts
    table = np.full((num, max(int(counts.max(initial=0)), 1)), len(ids),
                    np.int64)
    table[seg, np.arange(len(seg)) - starts[seg]] = pos
    return table


def banded_index(st: BandedStructure, device, ga=None) -> BandedIndex:
    """Device index tensors of ``st`` (and of the grouped layout ``ga``),
    with the gather tables of its four segment sums."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    order = t(st.order)
    slots = np.concatenate([st.pr_slot, st.p_slot, st.diag_slot])
    idx = BandedIndex(
        device=order.device, order=order, pos=t(st.pos),
        a_row=t(st.a_row), a_col=t(st.a_col), p_row=t(st.p_row),
        p_col=t(st.p_col), pr_k1=t(st.pr_k1), pr_k2=t(st.pr_k2),
        pr_row=t(st.pr_row), slots=t(slots),
        # the overflow slot n_slots (dropped P entries) is never read
        m_table=t(seg_table(slots, st.n_slots)),
        av_table=t(seg_table(st.a_row, st.m)),
        atv_table=t(seg_table(st.a_col, st.n_pad)),
        pv_table=t(seg_table(st.p_row, st.n_pad)))
    if ga is not None:
        from ..ops.banded_grouped import grouped_positions
        idx.row_slot = t(ga.row_slot)
        idx.b0_pos, idx.b1_pos = grouped_positions(ga, device)
    return idx


def _resolve_index(st, index, device, ga=None):
    """``index`` when it lies on ``device`` (and carries the grouped layout
    when ``ga`` is given), else a new one."""
    if (index is None or index.device != torch.device(device)
            or (ga is not None and index.row_slot is None)):
        return banded_index(st, device, ga)
    return index


# ---------------------------------------------------------------------------
# online (torch) pieces
# ---------------------------------------------------------------------------

def _seg_sum(vals, ids, num, table=None):
    """Batched segment sum: vals (B, K), ids (K,) -> (B, num), each
    segment's contributions added in one fixed order (no atomics), so the
    result repeats bitwise on every device.  ``table`` is
    ``seg_table(ids, num)`` on the values' device, built here when not
    given."""
    if table is None:
        table = torch.as_tensor(
            seg_table(torch.as_tensor(ids).cpu().numpy(), num),
            device=vals.device)
    return torch.nn.functional.pad(vals, (0, 1))[:, table].sum(dim=-1)


def _seg_max(vals, ids, num):
    """Batched segment max of NONNEGATIVE values: empty segments give 0
    (the reference's -inf clamped to 0)."""
    out = torch.zeros((vals.shape[0], num), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_reduce_(1, ids.expand(vals.shape[0], -1), vals,
                               'amax', include_self=True)


def assemble_banded_M(st: BandedStructure, pvals, avals, rho, sigma, dtype,
                      index: BandedIndex = None):
    """(D, L) blocks of M = P + sigma I + A' diag(rho) A."""
    ix = _resolve_index(st, index, avals.device)
    B = avals.shape[0]
    pairs = (avals[:, ix.pr_k1] * avals[:, ix.pr_k2]
             * rho[:, ix.pr_row])                      # (B, npairs)
    sig = torch.full((B, st.n_pad), sigma, dtype=dtype, device=avals.device)
    vals = torch.cat([pairs, pvals.to(dtype), sig], dim=1)
    flat = _seg_sum(vals, ix.slots, st.n_slots, ix.m_table)
    s, nb = st.s, st.nb
    D = flat[:, :nb * s * s].reshape(B, nb, s, s)
    L = flat[:, nb * s * s:].reshape(B, max(nb - 1, 0), s, s)
    return D, L


def admm_solve_banded(st: BandedStructure, pvals, q, avals, l, u, n_eq,
                      settings: ADMMSettings, x0=None, y0=None,
                      index: BandedIndex = None):
    """Solve a batch of banded QPs.  pvals (B, nP) / avals (B, nA) are the
    canonical nonzero values (theta-affine images); q (B, n), l/u (B, m).
    Same return contract as solvers/admm.admm_solve.  ``index`` is the
    family's BandedIndex on the data's device (built here when not
    given)."""
    with full_f32_matmul():
        return _banded_impl(st, pvals, q, avals, l, u, n_eq, settings,
                            x0, y0, _resolve_index(st, index, q.device))


def _banded_impl(st, pvals, q, avals, l, u, n_eq, stg, x0, y0, ix):
    B = avals.shape[0]
    dtype, dev = q.dtype, q.device
    n, m, n_pad = st.n, st.m, st.n_pad
    a_row, a_col, p_row, p_col = ix.a_row, ix.a_col, ix.p_row, ix.p_col

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    l = torch.clamp(l, -_INF, _INF)
    u = torch.clamp(u, -_INF, _INF)

    # q in permuted + padded space
    qp = torch.cat([q[:, ix.order], zeros(B, n_pad - n)], dim=1)

    def Av(x):                       # (B, n_pad) -> (B, m)
        return _seg_sum(avals * x[:, a_col], a_row, m, ix.av_table)

    def Atv(y):                      # (B, m) -> (B, n_pad)
        return _seg_sum(avals * y[:, a_row], a_col, n_pad, ix.atv_table)

    def Pv(x):
        return _seg_sum(pvals * x[:, p_col], p_row, n_pad, ix.pv_table)

    # ---- Ruiz equilibration on the sparse values (admm.ruiz_equilibrate
    # math on [[P, A'],[A, 0]] + cost scaling) ----
    c = torch.ones((B,), dtype=dtype, device=dev)
    D = torch.ones((B, n_pad), dtype=dtype, device=dev)
    E = torch.ones((B, m), dtype=dtype, device=dev)

    def inv_sqrt(v):
        return torch.where(v > 1e-12,
                           1.0 / torch.sqrt(torch.clamp(v, min=1e-12)),
                           torch.ones_like(v))

    for _ in range(stg.scaling):
        nx_P = _seg_max(torch.abs(pvals), p_col, n_pad)
        nx_A = _seg_max(torch.abs(avals), a_col, n_pad)
        nx = torch.maximum(nx_P, nx_A)
        nc = _seg_max(torch.abs(avals), a_row, m)
        dx = torch.clamp(inv_sqrt(nx), 1e-4, 1e4)
        dc = torch.clamp(inv_sqrt(nc), 1e-4, 1e4)
        pvals = pvals * dx[:, p_row] * dx[:, p_col]
        avals = avals * dc[:, a_row] * dx[:, a_col]
        qp = qp * dx
        D = D * dx
        E = E * dc
        col = torch.sum(_seg_max(torch.abs(pvals), p_col, n_pad),
                        dim=1) / n                      # mean over real cols
        col = torch.where(col < 1e-12, torch.ones_like(col), col)
        qn = torch.amax(torch.abs(qp), dim=1)
        qn = torch.where(qn < 1e-12, torch.ones_like(qn), qn)
        g = torch.clamp(1.0 / torch.maximum(col, qn), 1e-4, 1e4)
        pvals = pvals * g[:, None]
        qp = qp * g[:, None]
        c = c * g
    ls = E * l
    us = E * u
    c_inv = 1.0 / c
    D_inv = 1.0 / D
    E_inv = 1.0 / E

    is_eq = torch.arange(m, device=dev) < n_eq
    rho_base = torch.where(
        is_eq, torch.full((m,), stg.rho * stg.rho_eq_scale, dtype=dtype,
                          device=dev),
        torch.full((m,), stg.rho, dtype=dtype, device=dev)).expand(B, m)

    def factor(rho_vec):
        # block cyclic reduction (ops/block_tridiag.cr_factor), per instance
        Db, Lb = assemble_banded_M(st, pvals, avals, rho_vec, stg.sigma,
                                   dtype, ix)
        return cr_factor(Db, Lb), (Db, Lb)

    fac, DL = factor(rho_base)

    def kkt_apply(fac, DL, rhs):
        xt = cr_solve(fac, rhs.reshape(B, st.nb, st.s)).reshape(B, n_pad)
        for _ in range(stg.kkt_refine):
            r = rhs - bt_matvec(*DL, xt.reshape(B, st.nb, st.s)
                                ).reshape(B, n_pad)
            xt = xt + cr_solve(fac, r.reshape(B, st.nb, st.s)
                               ).reshape(B, n_pad)
        return xt

    if x0 is not None:
        x0 = torch.as_tensor(x0, device=dev).to(dtype)
        x0p = torch.cat([x0[:, ix.order], zeros(B, n_pad - n)], dim=1)
        x = D_inv * x0p
        # scaled avals = E_i A_ij D_j, so Av(D^{-1} x0) == E * (A_orig x0)
        z = Av(x)
    else:
        x = zeros(B, n_pad)
        z = zeros(B, m)
    y = (c[:, None] * E_inv * torch.as_tensor(y0, device=dev).to(dtype)
         if y0 is not None else zeros(B, m))

    def _inf_norm(v):
        return torch.amax(torch.abs(v), dim=-1)

    def residuals(z, Ax, Px, Aty):
        rp = _inf_norm(E_inv * (Ax - z))
        rp_den = torch.maximum(_inf_norm(E_inv * Ax), _inf_norm(E_inv * z))
        rd = c_inv * _inf_norm(D_inv * (Px + qp + Aty))
        rd_den = c_inv * torch.maximum(
            torch.maximum(_inf_norm(D_inv * Px), _inf_norm(D_inv * Aty)),
            _inf_norm(D_inv * qp))
        ok = ((rp <= stg.eps_abs + stg.eps_rel * rp_den)
              & (rd <= stg.eps_abs + stg.eps_rel * rd_den))
        return rp, rd, rp_den, rd_den, ok

    u_open = us >= _INF * 0.5
    l_open = ls <= -_INF * 0.5
    u_fin = torch.where(u_open, torch.zeros_like(us), us * E_inv)
    l_fin = torch.where(l_open, torch.zeros_like(ls), ls * E_inv)

    def infeasibility(dx, dy, Pdx, Adx, Atdy):
        eps = 1e-4
        Edy = E * dy
        dy_n = _inf_norm(Edy) * c_inv
        cert_p1 = _inf_norm(D_inv * Atdy) * c_inv <= eps * dy_n
        sup = torch.sum(u_fin * torch.clamp(Edy, min=0.0)
                        + l_fin * torch.clamp(Edy, max=0.0), dim=1) * c_inv
        open_dir = (torch.any((dy > 1e-12) & u_open, dim=1)
                    | torch.any((dy < -1e-12) & l_open, dim=1))
        prim_inf = ((dy_n > 1e-10) & cert_p1 & (sup <= -eps * dy_n)
                    & ~open_dir)
        dx_n = _inf_norm(D * dx)
        cert_d1 = _inf_norm(D_inv * Pdx) * c_inv <= eps * dx_n
        cert_d2 = torch.sum(qp * dx, dim=1) * c_inv <= -eps * dx_n
        up_ok = u_open | (E_inv * Adx <= eps * dx_n[:, None])
        lo_ok = l_open | (E_inv * Adx >= -eps * dx_n[:, None])
        dual_inf = ((dx_n > 1e-10) & cert_d1 & cert_d2
                    & torch.all(up_ok & lo_ok, dim=1))
        return prim_inf, dual_inf

    rho_scale = torch.ones((B,), dtype=dtype, device=dev)
    it = 0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    it_vec = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp = torch.full((B,), float('inf'), dtype=dtype, device=dev)
    rd = rp.clone()
    status = torch.zeros((B,), dtype=torch.int32, device=dev)

    # max_iter is not rounded to the check interval (reference
    # admm_banded.py:385): the last check may run past it
    while not bool(done.all()) and it < stg.max_iter:
        rho_vec = rho_base * rho_scale[:, None]
        xn, zn, yn = x, z, y
        for _ in range(stg.check_interval):
            rhs = stg.sigma * xn - qp + Atv(rho_vec * zn - yn)
            xt = kkt_apply(fac, DL, rhs)
            zt = Av(xt)
            x1 = stg.alpha * xt + (1 - stg.alpha) * xn
            w = stg.alpha * zt + (1 - stg.alpha) * zn + yn / rho_vec
            zn = torch.minimum(torch.maximum(w, ls), us)
            yn = rho_vec * (w - zn)
            xn = x1
        mask = done[:, None]
        dx = torch.where(mask, torch.zeros_like(x), xn - x)
        dy = torch.where(mask, torch.zeros_like(y), yn - y)
        x = torch.where(mask, x, xn)
        z = torch.where(mask, z, zn)
        y = torch.where(mask, y, yn)
        it += stg.check_interval
        rp, rd, rp_den, rd_den, ok = residuals(z, Av(x), Pv(x), Atv(y))
        p_inf, d_inf = infeasibility(dx, dy, Pv(dx), Av(dx), Atv(dy))
        it_vec = torch.where(ok & ~done, torch.full_like(it_vec, it), it_vec)
        status = torch.where(ok & (status == 0), 1, status)
        status = torch.where(p_inf & (status == 0), -3, status)
        status = torch.where(d_inf & (status == 0), -4, status)
        done = done | ok | p_inf | d_inf

        if stg.adaptive_rho:
            # per-instance OSQP adaptive rho; any change refactors the
            # whole batch
            ratio = torch.sqrt(
                (rp / torch.clamp(rp_den, min=1e-10))
                / torch.clamp(rd / torch.clamp(rd_den, min=1e-10), min=1e-10))
            tol = stg.adaptive_rho_tolerance
            change = ((ratio > tol) | (ratio < 1.0 / tol)) & ~done
            step_f = torch.clamp(
                torch.where(change, ratio, torch.ones_like(ratio)), 0.1, 10.0)
            rho_scale = torch.clamp(rho_scale * step_f, 1e-6, 1e6)
            if bool(change.any()):
                fac, DL = factor(rho_base * rho_scale[:, None])

    it_vec = torch.where(done, it_vec, torch.full_like(it_vec, it))

    # unscale + unpermute back to original variable order
    x_u = (D * x)[:, ix.pos]
    obj = c_inv * (0.5 * torch.sum(pvals * x[:, p_row] * x[:, p_col], dim=1)
                   + torch.sum(qp * x, dim=1))
    obj = torch.where(status == -3, torch.full_like(obj, float('inf')), obj)
    obj = torch.where(status == -4, torch.full_like(obj, -float('inf')), obj)
    return dict(x=x_u, y=c_inv[:, None] * E * y, z=E_inv * z, obj=obj,
                iters=it_vec, pri_res=rp, dua_res=rd, solved=(status == 1),
                status=status)
