"""Batched static-pivot blocked LDL^T for quasidefinite KKT systems.

Port of the JAX package's ``ops/ldl_batched.py``: the panel math that the
plain versions of kernels K6-K8 (ops/ldl_kernel.py) are built from.

Symmetric quasidefinite matrices K = [[P + reg I, B'], [B, -H - reg I]]
(P PSD, H PD) admit an LDL^T factorization under any symmetric permutation
(Vanderbei), so no pivot search is needed and the factorization is a fixed
sequence of batched operations.  Blocked right-looking factorization with
panel size p:

  for each panel k:  A11 = L11 D1 L11'   (p rank-1 steps on the (B, p, p)
                                          diagonal block)
                     L21 = A21 (D1 L11')^{-1}        (one (B, m, p) GEMM)
                     A22 -= L21 D1 L21'              (one (B, m, m) GEMM)

Solves are two panel sweeps using the unit-lower panel inverses.  No
pivoting means accuracy rests on quasidefiniteness, the dynamic pivot
regularization and the caller's iterative refinement against the true
system (the QDLDL/OSQP recipe).
"""
from __future__ import annotations

import numpy as np
import torch


def default_delta(dtype):
    """The dynamic pivot-regularization floor: 0.1 sqrt(eps) of ``dtype``."""
    return float(torch.finfo(dtype).eps) ** 0.5 * 0.1


def padded_signs(signs, N, Np):
    """Length-Np float64 NumPy sign vector: ``signs`` (all +1 when None)
    followed by +1 for the identity tail."""
    if signs is None:
        signs = np.ones(N)
    return np.concatenate([np.asarray(signs, float), np.ones(Np - N)])


def pad_identity(K, Np):
    """(B, N, N) -> (B, Np, Np) with an identity tail: decoupled trivial
    pivots."""
    B, N, _ = K.shape
    if Np == N:
        return K
    Kp = K.new_zeros((B, Np, Np))
    Kp[:, :N, :N] = K
    idx = torch.arange(N, Np, device=K.device)
    Kp[:, idx, idx] = 1.0
    return Kp


def _tri_unit_inv(L):
    """Inverse of a batched unit-lower-triangular (B, p, p) by forward
    substitution: row i of L^{-1} is e_i - sum_{j<i} L[i, j] X[j]."""
    B, p, _ = L.shape
    eye = torch.eye(p, dtype=L.dtype, device=L.device)
    rows = []
    for i in range(p):
        acc = eye[i].expand(B, p)
        if i:
            prev = torch.stack(rows, dim=1)             # (B, i, p)
            acc = acc - torch.einsum('bj,bjk->bk', L[:, i, :i], prev)
        rows.append(acc)
    return torch.stack(rows, dim=1)


def _ldl_panel(A, signs, delta):
    """Unblocked LDL^T of a batched (B, p, p) symmetric block.

    Returns (L unit-lower, d (B, p)).  Pivot j is clamped to
    signs[j] * max(signs[j] * d_j, delta): a tiny or wrong-signed pivot
    becomes a bounded perturbation the caller's refinement removes."""
    B, p, _ = A.shape
    L = torch.eye(p, dtype=A.dtype, device=A.device).repeat(B, 1, 1)
    d = A.new_zeros((B, p))
    below = torch.arange(p, device=A.device)
    for j in range(p):
        sj = float(signs[j])
        dj = sj * torch.clamp(sj * A[:, j, j], min=delta)
        col = A[:, :, j] / dj[:, None]
        col = torch.where(below[None, :] > j, col, torch.zeros_like(col))
        L[:, :, j] = L[:, :, j] + col
        d[:, j] = dj
        A = A - dj[:, None, None] * col[:, :, None] * col[:, None, :]
    return L, d


def ldl_factor(K, panel: int = 16, signs=None, dyn_delta=None):
    """Blocked LDL^T of batched symmetric quasidefinite K (B, N, N).

    ``signs``: length-N +-1 array of expected pivot signs (+1 on the
    primal block, -1 on the dual blocks); all +1 by default.
    ``dyn_delta``: pivot-regularization floor (default ``default_delta``).
    Returns a dict: L (B, Np, Np) unit-lower, d (B, Np), Linv
    (B, nbp, p, p) panel inverses, panel, N, Np."""
    B, N, _ = K.shape
    p = min(panel, N)
    nbp = -(-N // p)
    Np = nbp * p
    signs = padded_signs(signs, N, Np)
    delta = default_delta(K.dtype) if dyn_delta is None else float(dyn_delta)
    A = pad_identity(K, Np)
    L = torch.eye(Np, dtype=K.dtype, device=K.device).repeat(B, 1, 1)
    d = K.new_zeros((B, Np))
    Linvs = []
    for k in range(nbp):
        o = k * p
        L11, d1 = _ldl_panel(A[:, o:o + p, o:o + p], signs[o:o + p], delta)
        Linv = _tri_unit_inv(L11)
        Linvs.append(Linv)
        L[:, o:o + p, o:o + p] = L11
        d[:, o:o + p] = d1
        if o + p < Np:
            # Minv = (D1 L11')^{-1} = L11'^{-1} D1^{-1}
            Minv = Linv.transpose(1, 2) / d1[:, None, :]
            L21 = torch.matmul(A[:, o + p:, o:o + p], Minv)
            L[:, o + p:, o:o + p] = L21
            W = L21 * d1[:, None, :]                   # L21 D1
            A = A.clone()
            A[:, o + p:, o + p:] -= torch.matmul(W, L21.transpose(1, 2))
    return dict(L=L, d=d, Linv=torch.stack(Linvs, dim=1), panel=p, N=N,
                Np=Np)


def _panel_inv(Linv, k, p):
    """Panel k's unit-lower inverse from either layout: (B, nbp, p, p)
    (``ldl_factor``) or flat (B, nbp * p, p) (ops/ldl_kernel.py)."""
    if Linv.dim() == 4:
        return Linv[:, k]
    return Linv[:, k * p:(k + 1) * p, :]


def _safe_d(d):
    tiny = torch.finfo(d.dtype).tiny
    return torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)


def ldl_inverse(fac):
    """Explicit inverse of the (regularized) factored matrix: the panel
    sweeps of ``ldl_solve`` applied to all columns of the identity at once,
    so each panel step is a (B, ., p) x (B, p, Np) GEMM.  Returns
    (B, N, N).  Applying it has relative error ~ eps cond(K'), and cond(K')
    is capped by the dynamic pivot regularization, so the caller's
    refinement against the true K contracts as with the sweep solve."""
    L, d, Linv = fac['L'], fac['d'], fac['Linv']
    p, N, Np = fac['panel'], fac['N'], fac['Np']
    B = L.shape[0]
    nbp = Np // p
    # forward: L Z = I
    R = torch.eye(Np, dtype=L.dtype, device=L.device).repeat(B, 1, 1)
    zs = []
    for k in range(nbp):
        o = k * p
        Zk = torch.matmul(_panel_inv(Linv, k, p), R[:, o:o + p, :])
        zs.append(Zk)
        if o + p < Np:
            R = R.clone()
            R[:, o + p:, :] -= torch.matmul(L[:, o + p:, o:o + p], Zk)
    Z = torch.cat(zs, dim=1)
    R = Z / _safe_d(d)[:, :, None]
    # backward: L' X = W
    xs = [None] * nbp
    for k in reversed(range(nbp)):
        o = k * p
        Xk = torch.matmul(_panel_inv(Linv, k, p).transpose(1, 2),
                          R[:, o:o + p, :])
        xs[k] = Xk
        if o:
            R = R.clone()
            R[:, :o, :] -= torch.matmul(L[:, o:o + p, :o].transpose(1, 2), Xk)
    X = torch.cat(xs, dim=1)
    return X[:, :N, :N]


def ldl_solve(fac, b):
    """Solve K x = b given a factorization; b (B, N) -> x (B, N)."""
    L, d, Linv = fac['L'], fac['d'], fac['Linv']
    p, N, Np = fac['panel'], fac['N'], fac['Np']
    B = b.shape[0]
    nbp = Np // p
    if Np != N:
        b = torch.cat([b, b.new_zeros((B, Np - N))], dim=1)
    # forward: L z = b (right-looking panel sweep)
    r = b
    zs = []
    for k in range(nbp):
        o = k * p
        zk = torch.einsum('bij,bj->bi', _panel_inv(Linv, k, p), r[:, o:o + p])
        zs.append(zk)
        if o + p < Np:
            r = r.clone()
            r[:, o + p:] -= torch.einsum('bij,bj->bi', L[:, o + p:, o:o + p],
                                         zk)
    z = torch.cat(zs, dim=1)
    r = z / _safe_d(d)
    # backward: L' x = w (panel sweep from the bottom)
    xs = [None] * nbp
    for k in reversed(range(nbp)):
        o = k * p
        xk = torch.einsum('bji,bj->bi', _panel_inv(Linv, k, p), r[:, o:o + p])
        xs[k] = xk
        if o:
            r = r.clone()
            r[:, :o] -= torch.einsum('bij,bi->bj', L[:, o:o + p, :o], xk)
    x = torch.cat(xs, dim=1)
    return x[:, :N]
