"""Kernel K2: the whole per-instance ADMM solve, written by hand for Hopper.

Replaces the JAX package's Pallas TPU kernel
``ops/admm_full_kernel.py::_full_solve_kernel`` (wrapper
``admm_solve_full_pallas``) and computes the same function on the same
scaled data (solvers/admm.py prepares it): for every block of instances,
each with its own P and A, M = P + sigma I + A' diag(rho) A; a cold
Newton-Schulz inverse from the diagonal start with the residual-certificate
rescue; the ADMM loop with ``kkt_refine`` refinement sweeps against M; the
residuals and the OSQP section 3.4 infeasibility certificates per instance;
per-instance adaptive rho, where a change of any instance re-forms M for
the whole block and warm-restarts Newton-Schulz; a block exit as soon as
its instances are done; and the objective.

Three pieces live here:

- ``admm_solve_full``: the wrapper.  On CUDA tensors it launches the CUDA
  kernel in ``csrc/admm_full.cu`` (built with nvcc at first use, bound with
  ctypes) and counts the launch in ``admm_solve_full.launches``; on CPU
  tensors it runs the plain version.  It never falls back: a build, launch
  or shape the kernel cannot take raises.
- ``admm_solve_full_plain``: the kernel's arithmetic per block in torch,
  vectorized over blocks.  The CPU tests hold it against the Pallas kernel
  in interpret mode, and ``chip_smoke.py`` holds the CUDA kernel against
  it.
- ``pick_full_block``: instances per block, by the TPU kernel's own rule.
  The rescue and the adaptive-rho refactorization act on a whole block, so
  the block changes the answer; both versions take it from here unless the
  caller pins it.  On the card a block is one thread-block cluster.
- ``pick_full_ctas`` and ``full_layout``: the layout on the card.  Where
  c x block <= 16 (Hopper's largest cluster), each instance's M^-1 and A
  live in the shared memory of a team of c thread blocks between
  factorizations (c = 2 at the MPC shape, 1 at the portfolio shape: both
  main-path blocks fill a cluster of 16); elsewhere a cluster of
  min(block, 16) thread blocks streams them from global memory every
  iteration.
- ``tf32x3_matmul``: the kernel's factorization product in torch (the
  three-pass TF32 split), for the tests; the plain version takes it
  through ``matmul=``.

What bounds it on the card: operations, in the factorization (about 0.75
GFLOP per instance at the MPC shape, on the tensor cores with the
three-pass TF32 split); then the iterations' shared-memory reads.  Design
notes are in the CUDA source.  float32 only on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..solvers.admm import _ns_diag_start
from .admm_kernel import slice_words, team_rows
from .build import checked, load_library

_INF = 1e30
_THREADS = 256
# the tensor-core product's converted operands and raw cp.async ring
# (csrc/mma_tf32.cuh, kWgWords)
_MMA_WORDS = 2 * 2 * (128 * 8 + 112 * 8) + 3 * (128 * (16 + 4)
                                                 + 16 * (112 + 8))
_SCALARS = 9
_STATS = 16
_MAX_TEAM = 8
# per-block dynamic shared memory limit on Hopper (232,448 bytes)
_SMEM_LIMIT = 232448
# Hopper's largest thread-block cluster (non-portable size)
_CLUSTER_MAX = 16
# the TPU kernel's resident-set budget per block (its _BLOCK_BUDGET)
_REF_BLOCK_BUDGET = 70 * 1024 * 1024
_LIB = None


def full_smem_bytes(per, n, m, ctas=0):
    """Dynamic shared memory of one thread block (csrc/admm_full.cu): of
    the streaming layout with ``per`` instances (``stream_words``) for
    ``ctas`` 0, else of the resident layout in a team of ``ctas``
    (``resident_words``)."""
    if ctas == 0:
        return 4 * (_MMA_WORDS + per * (3 * n + 6 * m + _SCALARS)
                    + 7 * n + 7 * m + _THREADS)
    rm = team_rows(m, ctas)
    region = max(slice_words(team_rows(n, ctas), n) + slice_words(rm, n),
                 _MMA_WORDS)
    return 4 * (region + 12 * n + m + 12 * rm + _THREADS + _STATS
                + _SCALARS)


def pick_full_ctas(m, n):
    """Thread blocks per instance in the resident layout: the smallest of
    1, 2, 4, 8 whose blocks hold the instance's rows of M^-1 and A beside
    its vectors; 0 when none does."""
    for c in (1, 2, 4, _MAX_TEAM):
        if full_smem_bytes(1, n, m, c) <= _SMEM_LIMIT:
            return c
    return 0


def full_layout(block, m, n):
    """Thread blocks per instance that the kernel takes for ``block``: the
    resident team of ``pick_full_ctas`` where the block's teams fill at
    most one cluster of 16, else 0 (the streaming layout)."""
    c = pick_full_ctas(m, n)
    return c if c and c * block <= _CLUSTER_MAX else 0


def pick_full_block(B, m, n, dtype=torch.float32):
    """Instances per block: the TPU kernel's own rule, so that the port
    solves with the same block and hence computes the same function (the
    rescue and the adaptive-rho refactorization act on a whole block).  The
    largest of 32, 16, 8, 4 that divides B and whose resident set, by that
    kernel's estimate (pipelined P/A/A' inputs twice, the M^-1 and M
    scratches, temporaries, times its measured 3.7x overhead), fits its
    70 MB budget; None when none does."""
    esize = torch.empty((), dtype=dtype).element_size()
    for blk in (32, 16, 8, 4):
        est = blk * (2 * (n * n + 2 * m * n) + 3 * n * n + 2 * m * n) * esize
        if B % blk == 0 and int(est * 3.7) <= _REF_BLOCK_BUDGET:
            return blk
    return None


def _resolve_block(B, m, n, block, dtype):
    if block is None:
        block = pick_full_block(B, m, n, dtype)
        if block is None:
            raise ValueError(f'full-solve kernel: no block of B={B} fits '
                             f'n={n}, m={m}')
    if B % block:
        raise ValueError(f'full-solve kernel: block {block} does not divide '
                         f'the batch {B}')
    return block


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _vm(v, W):
    """Batched row vector times matrix: (k, a) x (k, a, b) -> (k, b)."""
    return torch.matmul(v[:, None, :], W)[:, 0]


def _tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does: on the int32 view."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_matmul(a, b):
    """The kernel's factorization product in torch: the three-pass TF32
    split a_lo b_hi + a_hi b_lo + a_hi b_hi (csrc/mma_tf32.cuh), each part
    rounded to TF32, summed in float32.  float32 only."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError('tf32x3_matmul: float32 operands expected')
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ((torch.matmul(al, bh) + torch.matmul(ah, bl))
            + torch.matmul(ah, bh))


def _form_M(Ps, As, sigma, rho, mm=torch.matmul):
    n = Ps.shape[-1]
    eye = torch.eye(n, dtype=Ps.dtype, device=Ps.device)
    return (Ps + sigma * eye) + mm(As.transpose(1, 2), As * rho[:, :, None])


def _sweeps(M, X, iters, mm):
    """Newton-Schulz sweeps X <- X (2I - M X) with the product ``mm``."""
    I2 = 2.0 * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    for _ in range(iters):
        X = mm(X, I2 - mm(M, X))
    return X


def ns_cert(M, X, mm=torch.matmul):
    """Per-instance ||I - M X||_inf (entrywise) with the product ``mm``;
    NaN compares as 'not < threshold'."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.amax(torch.abs(eye - mm(M, X)), dim=(1, 2))


def _rescue(M, X, block, ns_iters, stats, mm=torch.matmul):
    """The block's certificate rescue on whole blocks: where any instance
    has ||I - MX|| not below 0.05, its failing instances restart from the
    diagonal start and the whole block runs max(ns_iters, 30) sweeps."""
    bad = ~(ns_cert(M, X, mm) < 0.05)
    blk_bad = bad.reshape(-1, block).any(dim=1)
    if not bool(blk_bad.any()):
        return X
    sel = torch.nonzero(blk_bad)[:, 0]
    ix = (sel[:, None] * block + torch.arange(block, device=M.device)
          ).reshape(-1)
    Ms, Xs = M[ix], X[ix]
    Xs = torch.where(bad[ix][:, None, None], _ns_diag_start(Ms), Xs)
    X = X.clone()
    X[ix] = _sweeps(Ms, Xs, max(ns_iters, 30), mm)
    if stats is not None:
        stats['rescue_blocks'] = stats.get('rescue_blocks', 0) + len(sel)
    return X


def admm_solve_full_plain(Ps, qs, As, ls, us, rho_base, D, E, c_inv,
                          x0, z0, y0, *, sigma, alpha, eps_abs, eps_rel,
                          check_interval, max_iter, ns_iters, ns_f32_iters,
                          ns_adapt_iters, adaptive, rho_tol, kkt_refine=1,
                          adapt_until=0, block=None, stats=None,
                          matmul=torch.matmul):
    """Kernel K2's arithmetic in torch, per block, vectorized over blocks.

    Scaled data in: Ps (B, n, n), As (B, m, n), qs/D/x0 (B, n),
    ls/us/rho_base/E/z0/y0 (B, m), c_inv (B,).  Returns (x, z, y, obj,
    iters, status, rp, rd) in the scaled space.  A block that is done takes
    no further part, as in the kernel.  A ``stats`` dict, when given,
    receives the number of block refactorizations (``'refactor_blocks'``)
    and of block rescues (``'rescue_blocks'``).  ``matmul`` is the product
    of the factorization (forming M, the Newton-Schulz sweeps, the
    certificates and the warm rescale): ``torch.matmul`` by default, the
    kernel's ``tf32x3_matmul`` in the tests."""
    B, m, n = As.shape
    dtype, dev = Ps.dtype, Ps.device
    block = _resolve_block(B, m, n, block, dtype)
    max_iter = (max_iter // check_interval) * check_interval
    nb = B // block
    if stats is not None:
        stats.update(refactor_blocks=0, rescue_blocks=0)

    At = As.transpose(1, 2)
    D_inv, E_inv = 1.0 / D, 1.0 / E
    cinv = c_inv.reshape(B)
    eps_inf = 1e-4
    u_fin = torch.where(us < _INF * 0.5, us * E_inv, torch.zeros_like(us))
    l_fin = torch.where(ls > -_INF * 0.5, ls * E_inv, torch.zeros_like(ls))
    u_open = us >= _INF * 0.5
    l_open = ls <= -_INF * 0.5

    mm = matmul
    M = _form_M(Ps, As, sigma, rho_base, mm)
    Minv = _sweeps(M, _ns_diag_start(M), ns_iters, mm)
    if ns_iters > ns_f32_iters:
        Minv = _rescue(M, Minv, block, ns_iters, stats, mm)

    x, z, y = x0.clone(), z0.clone(), y0.clone()
    rho_scale = torch.ones((B,), dtype=dtype, device=dev)
    it = torch.zeros((nb,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    it_vec = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp_o = torch.full((B,), _INF, dtype=dtype, device=dev)
    rd_o = rp_o.clone()
    status = torch.zeros((B,), dtype=torch.int32, device=dev)
    lanes = torch.arange(block, device=dev)

    def inf_norm(v):
        return torch.amax(torch.abs(v), dim=-1)

    while True:
        running = ~done.reshape(nb, block).all(dim=1) & (it < max_iter)
        if not bool(running.any()):
            break
        bix = torch.nonzero(running)[:, 0]
        ix = (bix[:, None] * block + lanes).reshape(-1)
        P_i, A_i, At_i = Ps[ix], As[ix], At[ix]
        Mi, Mm = Minv[ix], M[ix]
        q, l, u = qs[ix], ls[ix], us[ix]
        xs, zs, ys = x[ix], z[ix], y[ix]
        Di, Dinv_i, Ei, Einv_i, ci = D[ix], D_inv[ix], E[ix], E_inv[ix], \
            cinv[ix]
        rho_vec = rho_base[ix] * rho_scale[ix][:, None]
        rho_inv = 1.0 / rho_vec

        xi, zi, yi = xs, zs, ys
        for _ in range(check_interval):
            rhs = sigma * xi - q + _vm(rho_vec * zi - yi, A_i)
            xt = _vm(rhs, Mi)
            for _ in range(kkt_refine):
                xt = xt + _vm(rhs - _vm(xt, Mm), Mi)
            zt = _vm(xt, At_i)
            x1 = alpha * xt + (1.0 - alpha) * xi
            w = alpha * zt + (1.0 - alpha) * zi + rho_inv * yi
            zi = torch.minimum(torch.maximum(w, l), u)
            yi = rho_vec * (w - zi)
            xi = x1

        # freeze converged instances with the kernel's blend (not a where)
        dn = done[ix]
        fmask = dn.to(dtype)[:, None]
        keep = 1.0 - fmask
        dx = keep * (xi - xs)
        dy = keep * (yi - ys)
        xs = fmask * xs + keep * xi
        zs = fmask * zs + keep * zi
        ys = fmask * ys + keep * yi
        it[bix] += check_interval
        itc = it[bix].repeat_interleave(block)

        Ax, Px, Aty = _vm(xs, At_i), _vm(xs, P_i), _vm(ys, A_i)
        rp = inf_norm(Einv_i * (Ax - zs))
        rp_den = torch.maximum(inf_norm(Einv_i * Ax), inf_norm(Einv_i * zs))
        rd = ci * inf_norm(Dinv_i * (Px + q + Aty))
        rd_den = ci * torch.maximum(
            torch.maximum(inf_norm(Dinv_i * Px), inf_norm(Dinv_i * Aty)),
            inf_norm(Dinv_i * q))
        ok = ((rp <= eps_abs + eps_rel * rp_den)
              & (rd <= eps_abs + eps_rel * rd_den))

        Adx, Pdx, Atdy = _vm(dx, At_i), _vm(dx, P_i), _vm(dy, A_i)
        Edy = Ei * dy
        dy_n = inf_norm(Edy) * ci
        cert_p1 = inf_norm(Dinv_i * Atdy) * ci <= eps_inf * dy_n
        sup = torch.sum(u_fin[ix] * torch.clamp(Edy, min=0.0)
                        + l_fin[ix] * torch.clamp(Edy, max=0.0), dim=1) * ci
        open_dir = (torch.any((dy > 1e-12) & u_open[ix], dim=1)
                    | torch.any((dy < -1e-12) & l_open[ix], dim=1))
        p_inf = ((dy_n > 1e-10) & cert_p1 & (sup <= -eps_inf * dy_n)
                 & ~open_dir)
        dx_n = inf_norm(Di * dx)
        cert_d1 = inf_norm(Dinv_i * Pdx) * ci <= eps_inf * dx_n
        cert_d2 = torch.sum(q * dx, dim=1) * ci <= -eps_inf * dx_n
        bar = eps_inf * dx_n[:, None]
        up_ok = u_open[ix] | (Einv_i * Adx <= bar)
        lo_ok = l_open[ix] | (Einv_i * Adx >= -bar)
        d_inf = ((dx_n > 1e-10) & cert_d1 & cert_d2
                 & torch.all(up_ok & lo_ok, dim=1))

        st = status[ix]
        it_vec[ix] = torch.where(ok & ~dn, itc, it_vec[ix])
        st = torch.where(ok & (st == 0), 1, st)
        st = torch.where(p_inf & (st == 0), -3, st)
        st = torch.where(d_inf & (st == 0), -4, st)
        dn = dn | ok | p_inf | d_inf
        x[ix], z[ix], y[ix] = xs, zs, ys
        status[ix], done[ix] = st, dn
        rp_o[ix], rd_o[ix] = rp, rd

        if adaptive:
            ratio = torch.sqrt(
                (rp / torch.clamp(rp_den, min=1e-10))
                / torch.clamp(rd / torch.clamp(rd_den, min=1e-10), min=1e-10))
            change = ((ratio > rho_tol) | (ratio < 1.0 / rho_tol)) & ~dn
            if adapt_until > 0:
                change = change & (itc <= adapt_until)
            step_f = torch.clamp(
                torch.where(change, ratio, torch.ones_like(ratio)), 0.1, 10.0)
            rho_scale[ix] = torch.clamp(rho_scale[ix] * step_f, 1e-6, 1e6)
            blk_change = change.reshape(-1, block).any(dim=1)
            if bool(blk_change.any()):
                cb = bix[blk_change]
                cx = (cb[:, None] * block + lanes).reshape(-1)
                M2 = _form_M(Ps[cx], As[cx], sigma,
                             rho_base[cx] * rho_scale[cx][:, None], mm)
                X = Minv[cx]
                ninf = torch.amax(torch.sum(torch.abs(mm(M2, X)), dim=2),
                                  dim=1)
                X = X / torch.clamp(ninf, min=1.0)[:, None, None]
                X = _sweeps(M2, X, ns_adapt_iters, mm)
                M[cx] = M2
                Minv[cx] = _rescue(M2, X, block, ns_iters, stats, mm)
                if stats is not None:
                    stats['refactor_blocks'] += len(cb)

    obj = cinv * (0.5 * torch.sum(x * _vm(x, Ps), dim=1)
                  + torch.sum(qs * x, dim=1))
    iters = torch.where(done, it_vec, it.repeat_interleave(block))
    return x, z, y, obj, iters, status, rp_o, rd_o


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_full_solve_f32.restype = I
    lib.admm_full_solve_f32.argtypes = (
        [P] * 22 + [I] * 5 + [F] * 5 + [I] * 8 + [P])


def build_kernel(verbose=False):
    """Compile csrc/admm_full.cu with nvcc for sm_90a (ops/build.py) and
    load it.  Returns the build's wall seconds (0.0 when already loaded)."""
    global _LIB
    _LIB, secs = load_library('admm_full', _bind, verbose=verbose)
    return secs


def admm_solve_full(Ps, qs, As, ls, us, rho_base, D, E, c_inv, x0, z0, y0,
                    *, sigma, alpha, eps_abs, eps_rel, check_interval,
                    max_iter, ns_iters, ns_f32_iters, ns_adapt_iters,
                    adaptive, rho_tol, kkt_refine=1, adapt_until=0,
                    block=None, cold_cert=None):
    """Kernel K2 on scaled data (signature of ``admm_solve_full_pallas``
    with an explicit ``block``).  Returns (x, z, y, obj, iters, status, rp,
    rd) in the scaled space.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (float32) or raise.  ``cold_cert``, a (B,)
    float32 tensor on the card, receives each instance's ||I - M X|| after
    the cold sweeps where the kernel takes it (ns_iters > ns_f32_iters,
    the rescue's gate); the plain version does not fill it."""
    kw = dict(sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
              check_interval=check_interval, max_iter=max_iter,
              ns_iters=ns_iters, ns_f32_iters=ns_f32_iters,
              ns_adapt_iters=ns_adapt_iters, adaptive=adaptive,
              rho_tol=rho_tol, kkt_refine=kkt_refine,
              adapt_until=adapt_until, block=block)
    if qs.device.type == 'cpu':
        return admm_solve_full_plain(Ps, qs, As, ls, us, rho_base, D, E,
                                     c_inv, x0, z0, y0, **kw)
    if qs.device.type != 'cuda':
        raise TypeError(f'full-solve kernel: no kernel for {qs.device}')
    B, m, n = As.shape
    dev = qs.device
    block = _resolve_block(B, m, n, block, torch.float32)
    # the block runs as one cluster: teams of ctas thread blocks per
    # instance (resident), or min(block, 16) thread blocks (streaming)
    ctas = full_layout(block, m, n)
    csize = min(block, _CLUSTER_MAX)
    if ctas == 0 and (block % csize or block // csize > 2
                      or full_smem_bytes(block // csize, n, m)
                      > _SMEM_LIMIT):
        raise ValueError(f'full-solve kernel: block {block} at n={n}, m={m} '
                         'does not fit a cluster')
    if cold_cert is not None:
        checked(cold_cert, 'cold_cert', (B,), dev)
        if not cold_cert.is_contiguous():
            raise ValueError('cold_cert: a contiguous tensor expected')
    args = [checked(Ps, 'Ps', (B, n, n), dev),
            checked(As, 'As', (B, m, n), dev),
            checked(qs, 'qs', (B, n), dev), checked(ls, 'ls', (B, m), dev),
            checked(us, 'us', (B, m), dev),
            checked(rho_base, 'rho_base', (B, m), dev),
            checked(D, 'D', (B, n), dev), checked(E, 'E', (B, m), dev),
            checked(c_inv.reshape(-1), 'c_inv', (B,), dev),
            checked(x0, 'x0', (B, n), dev), checked(z0, 'z0', (B, m), dev),
            checked(y0, 'y0', (B, m), dev)]
    build_kernel()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = [torch.empty((B, n), **f32), torch.empty((B, m), **f32),
            torch.empty((B, m), **f32), torch.empty((B,), **f32),
            torch.empty((B,), **i32), torch.empty((B,), **i32),
            torch.empty((B,), **f32), torch.empty((B,), **f32)]
    # per instance: M, two M^-1 buffers and a Newton-Schulz temporary
    scratch = torch.empty((B, 4, n, n), **f32)
    max_iter = (max_iter // check_interval) * check_interval
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB.admm_full_solve_f32(
            *[t.data_ptr() for t in args + outs],
            None if cold_cert is None else cold_cert.data_ptr(),
            scratch.data_ptr(), B, n, m, int(block), ctas, float(sigma),
            float(alpha), float(eps_abs), float(eps_rel), float(rho_tol),
            int(check_interval), int(max_iter), int(ns_iters),
            int(ns_f32_iters), int(ns_adapt_iters), int(bool(adaptive)),
            int(kkt_refine), int(adapt_until), stream)
    if err != 0:
        raise RuntimeError(f'admm_solve_full kernel launch failed: CUDA '
                           f'error {err}')
    admm_solve_full.launches += 1
    return tuple(outs)


admm_solve_full.launches = 0
