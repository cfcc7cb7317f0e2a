"""OSQP-style ADMM settings and the Newton-Schulz KKT inverse, in torch.

Port of the JAX package's ``solvers/admm.py``: ``ADMMSettings`` keeps the
same fields and defaults (the tests assert it), and the Newton-Schulz
helpers compute the same batched SPD inverse with ``torch.matmul``.

Problem form:  min 0.5 x'Px + q'x  s.t.  l <= A x <= u  (rows 0..n_eq are
equalities, l==u).  Default settings mirror reference osqp.py:102-115
(rho=0.1, sigma=1e-6, alpha=1.6, eps 1e-3, max_iter 4000) with adaptive_rho
off.

Precision: every matmul of a solve runs in full float32 (or float64), never
TF32; ``full_f32_matmul`` switches TF32 off for the duration of a solve and
restores the caller's setting.  The reference's bf16 bulk phase of the cold
Newton-Schulz start is specific to its TPU build; the port runs the full-
precision branch on every device.

The per-instance ``admm_solve`` (and its kernels) is ported in a later
slice.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

_INF = 1e30  # parity: reference replace_inf (utils.py:213-228)


@dataclass(frozen=True)
class ADMMSettings:
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    max_iter: int = 4000
    check_interval: int = 25
    scaling: int = 10
    warm_starting: bool = True
    # KKT application mode:
    #   'ns'   Newton-Schulz iterations for M^{-1}: pure batched matmuls;
    #   'inv'  Cholesky once + explicit inverse (good on CPU/float64);
    #   'chol' triangular solves every iteration (reference-like);
    #   'auto' 'ns' on CUDA, 'inv' on the CPU.
    kkt_solver: str = 'auto'
    kkt_refine: int = 1
    # cold Newton-Schulz sweeps from the diagonal start
    ns_iters: int = 16
    # hand-written kernel selection (the field keeps the reference's name):
    # 'auto'/'always'/'full' launch the CUDA kernel of the shared-KKT solve
    # on CUDA tensors (ops/admm_shared_kernel.py), 'full_interpret' runs the
    # kernel's plain torch version, 'never' runs the torch loop.
    use_pallas: str = 'auto'
    # reference: full-precision tail of its mixed-precision cold start; the
    # port is full precision throughout
    ns_f32_iters: int = 5
    # adaptive rho (OSQP section 5.2): rescale by the normalized residual
    # ratio at each check; re-"factorization" is a warm Newton-Schulz
    # restart.  Off by default (reference comparison settings pin it off).
    adaptive_rho: bool = False
    adaptive_rho_tolerance: float = 5.0
    ns_adapt_iters: int = 8
    # stop adapting rho after this many iterations (0 = never stop)
    adaptive_rho_until: int = 0


@contextlib.contextmanager
def full_f32_matmul():
    """Full-precision float32 matmuls (no TF32) inside the block; the
    caller's setting is restored on exit (the reference runs its solves
    under ``jax.default_matmul_precision('highest')``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _inf_norm(v, axis=-1):
    return torch.amax(torch.abs(v), dim=axis)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _ns_diag_start(M):
    """Diagonal-preconditioner NS start X0 = diag(M)^{-1} rescaled so
    eig(M X0) in (0, 1] -- monotone NS from any SPD M.  M is (B, n, n)."""
    n = M.shape[-1]
    dg = torch.diagonal(M, dim1=1, dim2=2)
    dg_inv = 1.0 / torch.clamp(dg, min=1e-12)
    ninf = torch.amax(torch.sum(torch.abs(M * dg_inv[:, None, :]), dim=2),
                      dim=1)
    scale = dg_inv / torch.clamp(ninf, min=1.0)[:, None]
    return _eye(n, M)[None] * scale[:, None, :]


def ns_residual_err(M, X):
    """Per-instance ||I - M X||_inf (entrywise): the NS convergence
    certificate.  NaN iterates compare as 'not < threshold', so err-based
    guards catch divergence AND overflow."""
    n = M.shape[-1]
    R = _eye(n, M)[None] - torch.matmul(M, X)
    return torch.amax(torch.abs(R), dim=(1, 2))


def _ns_sweeps(M, X, iters):
    I2 = 2.0 * _eye(M.shape[-1], M)
    for _ in range(iters):
        X = torch.matmul(X, I2 - torch.matmul(M, X))
    return X


def _ns_rescue(M, X, iters):
    """Recompute, from the monotone diagonal start, every instance whose
    residual certificate ||I - MX|| is not below 0.05."""
    bad = ~(ns_residual_err(M, X) < 0.05)
    if not bool(bad.any()):
        return X
    Xr = _ns_sweeps(M, _ns_diag_start(M), iters)
    return torch.where(bad[:, None, None], Xr, X)


def newton_schulz_inverse(M, iters):
    """Batched SPD inverse by Newton-Schulz, X <- X(2I - MX), from the
    diagonal preconditioner start: the reference's full-precision branch
    (its bf16 bulk phase, and with it ``ns_f32_iters``, exists only on its
    TPU build)."""
    return _ns_sweeps(M, _ns_diag_start(M), iters)


def newton_schulz_warm(M, X0, iters):
    """Newton-Schulz restarted from a previous inverse (adaptive-rho
    refactorization).  X0 is rescaled by ||M X0||_inf >= lambda_max so
    eig(M X0) lies in (0, 1] -- monotone convergence from any SPD warm
    start -- and the certificate rescue guards a contaminated X0."""
    ninf = torch.amax(torch.sum(torch.abs(torch.matmul(M, X0)), dim=2), dim=1)
    X0 = X0 / torch.clamp(ninf, min=1.0)[:, None, None]
    X = _ns_sweeps(M, X0, iters)
    return _ns_rescue(M, X, max(iters, 30))
