"""Device-side family: canonicalization as one GEMM (+ scatters).

Port of the JAX package's ``runtime/jax_family.py``.  All theta-affine maps
of a Family are stacked into one dense matrix, so a parameter batch theta
(B, p) is canonicalized with ONE ``torch.matmul``,  vals = [theta, 1] @ MAPS',
and the values are reshaped (dense layout) or scattered (scatter layout)
into canonical tensors P (B, n, n), A (B, m, n), q (B, n), b (B, m), d (B,).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..canon.canonicalizer import Family


def resolve_device(device=None) -> torch.device:
    """The port's device rule: CUDA unless the caller asks for another
    device; with no card and no explicit device, refuse rather than drop to
    the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            'port on the CPU')
    return torch.device('cuda')


def default_dtype(device: torch.device):
    """float32 on CUDA (the working type on the card), float64 elsewhere."""
    return torch.float32 if device.type == 'cuda' else torch.float64


@dataclass
class TorchFamily:
    """Static structure + device tensors for one problem family."""

    n: int
    m: int
    p: int
    n_zero: int
    n_nonneg: int
    soc_dims: tuple
    is_maximization: bool

    maps: Any           # (N_total, p1) stacked map; layout depends on mode
    d_quad: Any = None  # (p1, p1) theta-quadratic objective offset
    P_ij: Any = None    # scatter indices (scatter mode only)
    A_ij: Any = None
    dense_mode: bool = True
    nP: int = 0
    nA: int = 0
    n_exp: int = 0
    psd_dims: tuple = ()
    pow_alphas: tuple = ()

    DENSE_LIMIT = 3e7  # max dense-map entries (~120MB f32)

    @classmethod
    def from_family(cls, fam: Family, dtype=None, device=None,
                    force_scatter=False):
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        n, m, p1 = fam.n, fam.m, fam.p1

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        d_quad = (t(fam.d_quad.toarray())
                  if getattr(fam, 'd_quad', None) is not None
                  else torch.zeros((p1, p1), dtype=dtype, device=device))
        common = dict(
            n=n, m=m, p=fam.p, n_zero=fam.n_zero, n_nonneg=fam.n_nonneg,
            soc_dims=tuple(fam.soc_dims),
            is_maximization=fam.is_maximization, d_quad=d_quad,
            n_exp=getattr(fam, 'n_exp', 0),
            psd_dims=tuple(getattr(fam, 'psd_dims', ()) or ()),
            pow_alphas=tuple(getattr(fam, 'pow_alphas', ()) or ()))
        dense_entries = (n * n + m * n + n + m + 1) * p1
        if dense_entries <= cls.DENSE_LIMIT and not force_scatter:
            # scatter-free layout: P and A rows cover EVERY dense entry
            # (row i*n + j), so canonicalization is one GEMM + reshape
            stacked = np.vstack([
                _expand_rows(fam.P_map, fam.P_idx, n * n, n),
                fam.q_map.toarray(),
                fam.d_map.toarray(),
                _expand_rows(fam.A_map, fam.A_idx, m * n, n),
                fam.b_map.toarray(),
            ])
            return cls(maps=t(stacked), dense_mode=True, **common)
        # scatter layout for large families: map rows only for nonzeros
        stacked = np.vstack([
            fam.P_map.toarray(), fam.q_map.toarray(), fam.d_map.toarray(),
            fam.A_map.toarray(), fam.b_map.toarray()])

        def ij(idx):
            return torch.as_tensor(np.stack(idx, 1).astype(np.int64),
                                   device=device)

        return cls(maps=t(stacked), P_ij=ij(fam.P_idx), A_ij=ij(fam.A_idx),
                   dense_mode=False, nP=len(fam.P_idx[0]),
                   nA=len(fam.A_idx[0]), **common)


def _expand_rows(map_csr, idx, total_rows, n):
    """Place map rows at dense positions i*n + j."""
    import scipy.sparse as spa
    rows = idx[0] * n + idx[1]
    nr = len(rows)
    S = spa.coo_matrix((np.ones(nr), (rows, np.arange(nr))),
                       shape=(total_rows, nr))
    return np.asarray((S @ map_csr).todense())


def _theta_t(tf: TorchFamily, theta):
    """[theta, 1] as a (B, p1) tensor on the family's device and dtype."""
    theta = torch.as_tensor(theta, device=tf.maps.device).to(tf.maps.dtype)
    theta = torch.atleast_2d(theta)
    ones = torch.ones((theta.shape[0], 1), dtype=theta.dtype,
                      device=theta.device)
    return torch.cat([theta, ones], dim=1)


def _d_quad_term(tf, tt):
    return torch.einsum('bp,pq,bq->b', tt, tf.d_quad, tt)


def _scatter(vals, ij, shape):
    """Zero tensor of ``shape`` (leading batch optional) with ``vals`` at
    the (unique) positions ``ij``."""
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    out[..., ij[:, 0], ij[:, 1]] = vals
    return out


def canon_batch(tf: TorchFamily, theta):
    """theta (B, p) -> dict of batched canonical tensors (one GEMM)."""
    tt = _theta_t(tf, theta)
    B = tt.shape[0]
    vals = tt @ tf.maps.T  # (B, N_total) -- single GEMM
    n, m = tf.n, tf.m
    o = 0
    if tf.dense_mode:
        P = vals[:, o:o + n * n].reshape(B, n, n); o += n * n
        q = vals[:, o:o + n]; o += n
        d = vals[:, o]; o += 1
        A = vals[:, o:o + m * n].reshape(B, m, n); o += m * n
        b = vals[:, o:o + m]
    else:
        pv = vals[:, o:o + tf.nP]; o += tf.nP
        q = vals[:, o:o + n]; o += n
        d = vals[:, o]; o += 1
        av = vals[:, o:o + tf.nA]; o += tf.nA
        b = vals[:, o:o + m]
        P = _scatter(pv, tf.P_ij, (B, n, n))
        A = _scatter(av, tf.A_ij, (B, m, n))
    d = d + _d_quad_term(tf, tt)
    return dict(P=P, q=q, d=d, A=A, b=b)


def canon_batch_shared(tf: TorchFamily, theta):
    """Shared-P/A canonicalization: P (n, n) and A (m, n) from theta ROW 0,
    q/b/d batched over all rows.  The caller (CompiledQPSolver.solve_batch)
    has verified that all batch rows share the P/A-relevant theta entries."""
    tt = _theta_t(tf, theta)
    n, m = tf.n, tf.m
    mp = tf.maps
    if tf.dense_mode:
        oq = n * n
        od = oq + n
        oA = od + 1
        ob = oA + m * n
        P = (tt[:1] @ mp[:oq].T).reshape(n, n)
        A = (tt[:1] @ mp[oA:ob].T).reshape(m, n)
    else:
        oq = tf.nP
        od = oq + n
        oA = od + 1
        ob = oA + tf.nA
        P = _scatter((tt[:1] @ mp[:oq].T)[0], tf.P_ij, (n, n))
        A = _scatter((tt[:1] @ mp[oA:ob].T)[0], tf.A_ij, (m, n))
    q = tt @ mp[oq:od].T
    d = (tt @ mp[od:oA].T)[:, 0] + _d_quad_term(tf, tt)
    b = tt @ mp[ob:].T
    return dict(P=P, q=q, d=d, A=A, b=b)


def canon_batch_sparse(tf: TorchFamily, theta):
    """theta (B, p) -> dict(pvals, q, d, avals, b): the canonical NONZERO
    values only (no dense P/A), the input of the banded solvers.  Needs a
    scatter-mode family (``from_family(..., force_scatter=True)``)."""
    if tf.dense_mode:
        raise ValueError('canon_batch_sparse needs a scatter-mode '
                         'TorchFamily')
    tt = _theta_t(tf, theta)
    vals = tt @ tf.maps.T
    n, m = tf.n, tf.m
    o = 0
    pvals = vals[:, o:o + tf.nP]; o += tf.nP
    q = vals[:, o:o + n]; o += n
    d = vals[:, o]; o += 1
    avals = vals[:, o:o + tf.nA]; o += tf.nA
    b = vals[:, o:o + m]
    d = d + _d_quad_term(tf, tt)
    return dict(pvals=pvals, q=q, d=d, avals=avals, b=b)


def qp_bounds_batch(tf: TorchFamily, b):
    """OSQP-style box (l, u) from the aff-convention offsets b (B, m):
    zero rows: l = u = -b; nonneg rows: -b <= A x <= +inf."""
    if tf.soc_dims or tf.n_exp or tf.psd_dims or tf.pow_alphas:
        raise ValueError('QP form unavailable: family has cones')
    mz = tf.n_zero
    l = -b
    u = torch.cat([-b[:, :mz], torch.full_like(b[:, mz:], float('inf'))],
                  dim=1)
    return l, u
