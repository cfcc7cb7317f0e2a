"""Block-tridiagonal SPD solver, in torch (core of the long-horizon KKT).

Port of the JAX package's ``ops/block_tridiag.py``.  Long-horizon families
(MPC with H >> 10, charging with T ~ 1440) have block-tridiagonal KKT
matrices M = P + sigma I + A' R A after a bandwidth-reducing permutation,
where dense n x n storage and O(n^2) matvecs are prohibitive.

- ``cr_factor`` / ``cr_solve``: block cyclic reduction, the path every
  banded solver takes.  Each level eliminates the odd blocks and halves the
  block count, so the factor is O(nb s^3) and a solve O(nb s^2) per
  right-hand side.
- ``bt_factor`` / ``bt_solve``: the block-Cholesky Schur recurrence and its
  substitution sweeps.  The reference evaluates the sweeps as affine
  recurrences with ``lax.associative_scan``; here they are plain loops over
  the blocks (no solver path calls them).
- ``bt_matvec``, ``dense_to_bt``, ``detect_block_bandwidth``: helpers.

Blocks are stored dense, (B, nb, s, s); s is the (padded) block bandwidth.
"""
from __future__ import annotations

import torch


def bt_factor(D, L):
    """Block-Cholesky Schur recurrence.

    D: (B, nb, s, s) diagonal blocks (symmetric), L: (B, nb-1, s, s)
    sub-diagonal blocks (block i couples x_i to x_{i-1}).
    Returns dict with S_inv (B, nb, s, s): inverses of the Schur diagonal
    blocks, and L (as given) -- everything bt_solve needs.
    """
    nb = D.shape[1]
    S_inv = [torch.linalg.inv(D[:, 0])]
    for i in range(1, nb):
        # S_i = D_i - L_i S_{i-1}^{-1} L_i'
        LSi = torch.matmul(L[:, i - 1], S_inv[-1])
        Si = D[:, i] - torch.matmul(LSi, L[:, i - 1].transpose(-1, -2))
        S_inv.append(torch.linalg.inv(Si))
    return dict(S_inv=torch.stack(S_inv, dim=1), L=L)


def _affine_sweep(Ms, vs, reverse=False):
    """x_i = Ms_i x_{i-1} + vs_i for all i (x_0 = vs_0), or with
    ``reverse`` x_i = Ms_i x_{i+1} + vs_i from the last block down.
    Ms (B, nb-1, s, s) holds the transitions in sweep order; vs (B, nb, s).
    """
    nb = vs.shape[1]
    order = range(nb - 1, -1, -1) if reverse else range(nb)
    out = [None] * nb
    prev = None
    for i in order:
        if prev is None:
            out[i] = vs[:, i]
        else:
            out[i] = (torch.matmul(Ms[:, i if reverse else i - 1],
                                   prev[..., None])[..., 0] + vs[:, i])
        prev = out[i]
    return torch.stack(out, dim=1)


def bt_solve(fac, b):
    """Solve M x = b for block-tridiagonal SPD M given bt_factor output.

    b: (B, nb, s).  Returns x: (B, nb, s).
    Forward:  y_i = b_i - L_i S_{i-1}^{-1} y_{i-1}   (y_1 = b_1)
    Backward: x_i = S_i^{-1} (y_i - L_{i+1}' x_{i+1})
    """
    S_inv, L = fac['S_inv'], fac['L']
    # forward transitions T_i = -L_i S_{i-1}^{-1}
    T_fwd = -torch.matmul(L, S_inv[:, :-1])
    y = _affine_sweep(T_fwd, b)
    # backward: x_i = S_i^{-1} y_i - S_i^{-1} L_{i+1}' x_{i+1}
    Sy = torch.matmul(S_inv, y[..., None])[..., 0]
    T_bwd = -torch.matmul(S_inv[:, :-1], L.transpose(-1, -2))
    return _affine_sweep(T_bwd, Sy, reverse=True)


def _mv(M, v):
    """Block matvec: M (..., s, s) x v (..., s)."""
    return torch.matmul(M, v[..., None])[..., 0]


def _mvT(M, v):
    """Transposed block matvec: M' v."""
    return torch.matmul(M.transpose(-1, -2), v[..., None])[..., 0]


def bt_matvec(D, L, x):
    """M x for block-tridiagonal M (D diagonal, L sub-diagonal blocks)."""
    y = _mv(D, x).clone()
    y[:, 1:] += _mv(L, x[:, :-1])             # L_i x_{i-1}
    y[:, :-1] += _mvT(L, x[:, 1:])            # L_{i+1}' x_{i+1}
    return y


def cr_factor(D, L):
    """Block cyclic-reduction factorization of the block-tridiagonal SPD
    system (D, L): each level halves the block count, so the factor is
    O(nb s^3) and each solve O(nb s^2).

    Level construction (0-based blocks; equation i is
    L[i-1] x_{i-1} + D_i x_i + L[i]' x_{i+1} = b_i): eliminate ODD
    blocks; for the kept even blocks j,
        D'_j = D_j - L[j-1] Dinv_{j-1} L[j-1]' - L[j]' Dinv_{j+1} L[j]
        L'_{j/2-1} (coupling j to j-2) = -L[j-1] Dinv_{j-1} L[j-2]
        b'_j = b_j - A_j b_{j-1} - C_j b_{j+1},
    with A_j = L[j-1] Dinv_{j-1}, C_j = L[j]' Dinv_{j+1}.  Blocks are
    padded to an even count per level with identity D / zero L
    (decoupled trivial equations).  Returns dict(levels=[per-level dicts],
    root_inv).
    """
    levels = []
    while D.shape[1] > 1:
        B, nb, s, _ = D.shape
        if nb % 2:
            # pad one trailing identity block
            eye = torch.eye(s, dtype=D.dtype, device=D.device).expand(
                B, 1, s, s)
            D = torch.cat([D, eye], dim=1)
            L = torch.cat([L, torch.zeros((B, 1, s, s), dtype=D.dtype,
                                          device=D.device)], dim=1)
        Dinv_odd = torch.linalg.inv(D[:, 1::2])      # (B, n2, s, s)
        # L[2t+1] couples 2t+2 to 2t+1; L[2t] couples 2t+1 to 2t
        L_left = L[:, 1::2]
        L_even = L[:, 0::2]
        # A_t (even block 2t, t >= 1): L[2t-1] Dinv[2t-1]
        A = torch.matmul(L_left, Dinv_odd[:, :L_left.shape[1]])
        # C_t: L[2t]' Dinv[2t+1]
        C = torch.matmul(L_even.transpose(-1, -2), Dinv_odd)
        # D'_t = D_2t - A_t L[2t-1]' - C_t L[2t]
        Dp = D[:, 0::2].clone()
        Dp[:, 1:] += -torch.matmul(A, L_left.transpose(-1, -2))
        Dp = Dp - torch.matmul(C, L_even)
        # L'_{t-1} couples 2t to 2t-2: -A_t L[2t-2]
        Lp = -torch.matmul(A, L_even[:, :A.shape[1]])
        levels.append(dict(Dinv_odd=Dinv_odd, A=A, C=C, L_left=L_left,
                           L_even=L_even))
        D, L = Dp, Lp
    return dict(levels=levels, root_inv=torch.linalg.inv(D[:, 0]))


def cr_solve(fac, b):
    """Solve M x = b given cr_factor output; b (B, nb, s)."""
    levels = fac['levels']
    nb0 = b.shape[1]
    stack = []
    for lv in levels:
        B, nb_l, s = b.shape
        if nb_l % 2:
            b = torch.cat([b, torch.zeros((B, 1, s), dtype=b.dtype,
                                          device=b.device)], dim=1)
        b_even = b[:, 0::2]
        b_odd = b[:, 1::2]
        bp = b_even.clone()
        nA = lv['A'].shape[1]
        bp[:, 1:] += -_mv(lv['A'], b_odd[:, :nA])
        bp = bp - _mv(lv['C'], b_odd)
        stack.append(b_odd)
        b = bp
    x = _mv(fac['root_inv'], b[:, 0])[:, None]
    for lv, b_odd in zip(reversed(levels), reversed(stack)):
        # back-substitute odd blocks between the solved even blocks:
        # x_{2t+1} = Dinv[2t+1] (b_{2t+1} - L[2t] x_{2t} - L[2t+1]' x_{2t+2})
        n2 = lv['Dinv_odd'].shape[1]
        x = x[:, :n2]              # drop a deeper level's pad block
        r = b_odd - _mv(lv['L_even'], x)
        nL = lv['L_left'].shape[1]
        r[:, :nL] += -_mvT(lv['L_left'], x[:, 1:1 + nL])
        x_odd = _mv(lv['Dinv_odd'], r)
        # interleave even/odd back to the level's block count
        x = torch.stack([x, x_odd], dim=2).reshape(x.shape[0], 2 * n2,
                                                    x.shape[-1])
    return x[:, :nb0]


def dense_to_bt(M, s):
    """Partition a dense (B, n, n) block-tridiagonal matrix into (D, L)
    with block size s (n divisible by s).  Off-band content is DROPPED --
    callers must validate bandedness (see detect_block_bandwidth)."""
    B, n, _ = M.shape
    nb = n // s
    Mb = M.reshape(B, nb, s, nb, s)
    idx = torch.arange(nb, device=M.device)
    D = Mb[:, idx, :, idx, :]                    # (nb, B, s, s)
    L = Mb[:, idx[1:], :, idx[:-1], :]
    return D.transpose(0, 1), L.transpose(0, 1)


def detect_block_bandwidth(pattern, s_candidates=(1, 2, 3, 4, 6, 8, 12,
                                                  16, 24, 32)):
    """Smallest block size s such that the (n, n) sparsity pattern is
    block-tridiagonal with s x s blocks; None if none fits.  Offline
    (NumPy) -- family-compile-time analysis."""
    import numpy as np
    pat = np.asarray(pattern) != 0
    n = pat.shape[0]
    r, c = np.nonzero(pat)
    if len(r) == 0:
        return int(s_candidates[0])
    for s in s_candidates:
        if n % s:
            continue
        # require >= 4 blocks: with nb <= 3 every matrix is trivially
        # "block-tridiagonal" and the banded path saves nothing
        if n // s < 4:
            continue
        if np.all(np.abs(r // s - c // s) <= 1):
            return int(s)
    return None
