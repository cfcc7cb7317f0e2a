"""Kernel K1: the whole shared-KKT ADMM solve, written by hand for Hopper.

Replaces the JAX package's Pallas TPU kernel
``ops/admm_shared_kernel.py::_shared_solve_kernel`` (wrapper
``admm_shared_solve_pallas``) and computes the same function on the same
scaled data (solvers/admm_shared.py prepares it): for every chunk of
instances, the full ADMM loop against one shared P, A, M and M^{-1} --
``check_interval`` iterations of x~ = rhs M^{-1} (with ``kkt_refine``
refinement sweeps against M), z~ = x~ A', over-relaxation, box projection
and dual update; then residuals and the OSQP section 3.4 infeasibility
certificates; a chunk-shared adaptive rho (geometric mean of the active
instances' residual ratios) whose change re-forms M and warm-restarts
Newton-Schulz on the chunk's own copy of M^{-1}; and a chunk exit as soon
as its instances are done.

Three pieces live here:

- ``admm_shared_solve``: the wrapper.  On CUDA tensors it launches the CUDA
  kernel in ``csrc/admm_shared.cu`` (built with nvcc at first use, bound
  with ctypes) and counts the launch in ``admm_shared_solve.launches``; on
  CPU tensors it runs the plain version.  It never falls back: a build,
  launch or shape the kernel cannot take raises.
- ``admm_shared_solve_plain``: the kernel's arithmetic per chunk in torch,
  vectorized over chunks.  The CPU tests hold it against the Pallas kernel
  in interpret mode, and ``chip_smoke.py`` holds the CUDA kernel against it.
- ``pick_shared_chunk``: instances per thread block.  Adaptive rho is shared
  by a chunk, so the chunk changes the answer; both versions take it from
  here unless the caller pins it.

Design on the card (see the note in csrc/admm_shared.cu): one thread block
per chunk; the chunk's vectors live in shared memory, the shared matrices
(about 1 MB at the MPC shape in float32) stream from the 50 MB L2, and the
chunk's refactored M and M^{-1} live in global scratch that this wrapper
allocates.  float32 only on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .build import checked as _checked, load_library

_INF = 1e30

# instances per block, largest first: B=2048 gives 256 blocks at 8 (the card
# has 132 SMs)
_CHUNKS = (8, 4, 2, 1)
_THREADS = 256
_TILE, _TILE_K = 128, 16
# per-block dynamic shared memory limit on Hopper (232,448 bytes)
_SMEM_LIMIT = 232448

_LIB = None


def shared_smem_bytes(chunk, n, m):
    """Dynamic shared memory of one block: the layout of the CUDA kernel
    (csrc/admm_shared.cu, ``smem_words``)."""
    words = (chunk * (7 * n + 8 * m) + n + 4 * m
             + _TILE_K * (_TILE + 4) + _TILE_K * _TILE + _THREADS
             + 7 * chunk)
    return 4 * words


def pick_shared_chunk(B, m, n):
    """Largest chunk that divides B and whose block fits shared memory, or
    None when no chunk fits."""
    for chunk in _CHUNKS:
        if B % chunk == 0 and shared_smem_bytes(chunk, n, m) <= _SMEM_LIMIT:
            return chunk
    return None


def _resolve_chunk(B, m, n, chunk):
    if chunk is None:
        chunk = pick_shared_chunk(B, m, n)
        if chunk is None:
            raise ValueError(
                f'shared-KKT kernel: no chunk fits n={n}, m={m} in shared '
                'memory')
    if B % chunk:
        raise ValueError(f'shared-KKT kernel: chunk {chunk} does not divide '
                         f'the batch {B}')
    return chunk


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def admm_shared_solve_plain(Ps, qs, As, ls, us, rho_base, D, E, c_inv,
                            M0, Minv0, x0, z0, y0, *, sigma, alpha,
                            eps_abs, eps_rel, check_interval, max_iter,
                            ns_adapt_iters, adaptive, rho_tol,
                            kkt_refine=1, adapt_until=0, chunk=None,
                            stats=None):
    """Kernel K1's arithmetic in torch, per chunk, vectorized over chunks.

    Scaled data in, scaled (x, z, y, iters, status, rp, rd) out.  A chunk
    that is done takes no further part, as in the kernel.  A ``stats`` dict,
    when given, receives the number of chunk refactorizations
    (``'refactors'``)."""
    m, n = As.shape
    B = qs.shape[0]
    dtype, dev = Ps.dtype, Ps.device
    chunk = _resolve_chunk(B, m, n, chunk)
    max_iter = (max_iter // check_interval) * check_interval
    nc = B // chunk

    def per_chunk(v):
        return v.reshape(nc, chunk, v.shape[-1]).clone()

    q, l, u = per_chunk(qs), per_chunk(ls), per_chunk(us)
    x, z, y = per_chunk(x0), per_chunk(z0), per_chunk(y0)
    At = As.T
    rho0 = rho_base.reshape(1, 1, m)
    D_inv = 1.0 / D
    E_inv = 1.0 / E
    cinv = torch.as_tensor(c_inv, dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    eps_inf = 1e-4

    u_fin = torch.where(u < _INF * 0.5, u * E_inv, torch.zeros_like(u))
    l_fin = torch.where(l > -_INF * 0.5, l * E_inv, torch.zeros_like(l))
    u_open = u >= _INF * 0.5
    l_open = l <= -_INF * 0.5

    M = M0.expand(nc, n, n).clone()
    Minv = Minv0.expand(nc, n, n).clone()
    rho_scale = torch.ones((nc,), dtype=dtype, device=dev)
    it = torch.zeros((nc,), dtype=torch.int32, device=dev)
    done = torch.zeros((nc, chunk), dtype=torch.bool, device=dev)
    it_vec = torch.zeros((nc, chunk), dtype=torch.int32, device=dev)
    rp_o = torch.full((nc, chunk), _INF, dtype=dtype, device=dev)
    rd_o = rp_o.clone()
    status = torch.zeros((nc, chunk), dtype=torch.int32, device=dev)

    def inf_norm(v):
        return torch.amax(torch.abs(v), dim=-1)

    refactors = 0

    while True:
        running = ~done.all(dim=1) & (it < max_iter)
        if not bool(running.any()):
            break
        ix = torch.nonzero(running)[:, 0]
        xs, zs, ys = x[ix], z[ix], y[ix]
        qc, lc, uc = q[ix], l[ix], u[ix]
        dn = done[ix]
        rho_vec = rho0 * rho_scale[ix].reshape(-1, 1, 1)
        rho_inv = 1.0 / rho_vec
        Mi, Mc = Minv[ix], M[ix]

        xi, zi, yi = xs, zs, ys
        for _ in range(check_interval):
            rhs = sigma * xi - qc + (rho_vec * zi - yi) @ As
            xt = rhs @ Mi
            for _ in range(kkt_refine):
                xt = xt + (rhs - xt @ Mc) @ Mi
            zt = xt @ At
            x1 = alpha * xt + (1.0 - alpha) * xi
            w = alpha * zt + (1.0 - alpha) * zi + rho_inv * yi
            z1 = torch.minimum(torch.maximum(w, lc), uc)
            yi = rho_vec * (w - z1)
            xi, zi = x1, z1

        keep = ~dn[..., None]
        dx = torch.where(keep, xi - xs, torch.zeros_like(xs))
        dy = torch.where(keep, yi - ys, torch.zeros_like(ys))
        xs = torch.where(keep, xi, xs)
        zs = torch.where(keep, zi, zs)
        ys = torch.where(keep, yi, ys)
        itc = it[ix] + check_interval

        Ax, Px, Aty = xs @ At, xs @ Ps, ys @ As
        rp = inf_norm(E_inv * (Ax - zs))
        rp_den = torch.maximum(inf_norm(E_inv * Ax), inf_norm(E_inv * zs))
        rd = cinv * inf_norm(D_inv * (Px + qc + Aty))
        rd_den = cinv * torch.maximum(
            torch.maximum(inf_norm(D_inv * Px), inf_norm(D_inv * Aty)),
            inf_norm(D_inv * qc))
        ok = ((rp <= eps_abs + eps_rel * rp_den)
              & (rd <= eps_abs + eps_rel * rd_den))

        Adx, Pdx, Atdy = dx @ At, dx @ Ps, dy @ As
        Edy = E * dy
        dy_n = inf_norm(Edy) * cinv
        cert_p1 = inf_norm(D_inv * Atdy) * cinv <= eps_inf * dy_n
        sup = torch.sum(u_fin[ix] * torch.clamp(Edy, min=0.0)
                        + l_fin[ix] * torch.clamp(Edy, max=0.0),
                        dim=-1) * cinv
        open_dir = (torch.any((dy > 1e-12) & u_open[ix], dim=-1)
                    | torch.any((dy < -1e-12) & l_open[ix], dim=-1))
        p_inf = ((dy_n > 1e-10) & cert_p1 & (sup <= -eps_inf * dy_n)
                 & ~open_dir)
        dx_n = inf_norm(dx / D_inv)
        cert_d1 = inf_norm(D_inv * Pdx) * cinv <= eps_inf * dx_n
        cert_d2 = torch.sum(qc * dx, dim=-1) * cinv <= -eps_inf * dx_n
        bar = eps_inf * dx_n[..., None]
        up_ok = u_open[ix] | (E_inv * Adx <= bar)
        lo_ok = l_open[ix] | (E_inv * Adx >= -bar)
        d_inf = ((dx_n > 1e-10) & cert_d1 & cert_d2
                 & torch.all(up_ok & lo_ok, dim=-1))

        st = status[ix]
        newly = ok & ~dn
        it_vec[ix] = torch.where(newly, itc[:, None].expand_as(newly),
                                 it_vec[ix])
        st = torch.where(ok & (st == 0), 1, st)
        st = torch.where(p_inf & (st == 0), -3, st)
        st = torch.where(d_inf & (st == 0), -4, st)
        dn = dn | ok | p_inf | d_inf

        x[ix], z[ix], y[ix] = xs, zs, ys
        it[ix] = itc
        status[ix] = st
        done[ix] = dn
        rp_o[ix], rd_o[ix] = rp, rd

        if adaptive:
            ratio = torch.sqrt(
                (rp / torch.clamp(rp_den, min=1e-10))
                / torch.clamp(rd / torch.clamp(rd_den, min=1e-10), min=1e-10))
            active = ~dn
            log_r = torch.where(active,
                                torch.log(torch.clamp(ratio, 1e-6, 1e6)),
                                torch.zeros_like(ratio))
            n_act = torch.clamp(active.to(dtype).sum(dim=1), min=1.0)
            comb = torch.exp(log_r.sum(dim=1) / n_act)
            change = ((comb > rho_tol) | (comb < 1.0 / rho_tol)) \
                & active.any(dim=1)
            if adapt_until > 0:
                change = change & (itc <= adapt_until)
            step_f = torch.clamp(
                torch.where(change, comb, torch.ones_like(comb)), 0.1, 10.0)
            new_scale = torch.clamp(rho_scale[ix] * step_f, 1e-6, 1e6)
            rho_scale[ix] = new_scale
            if bool(change.any()):
                cx = ix[change]
                rho_new = rho0[0] * new_scale[change][:, None]   # (k, m)
                M2 = (Ps + sigma * eye) + (At * rho_new[:, None, :]) @ As
                X = Minv[cx]
                ninf = torch.amax(torch.sum(torch.abs(M2 @ X), dim=2), dim=1)
                X = X / torch.clamp(ninf, min=1.0)[:, None, None]
                for _ in range(ns_adapt_iters):
                    X = X @ (2.0 * eye - M2 @ X)
                M[cx] = M2
                Minv[cx] = X
                refactors += len(cx)

    if stats is not None:
        stats['refactors'] = refactors

    iters = torch.where(done, it_vec, it[:, None].expand_as(it_vec))
    return (x.reshape(B, n), z.reshape(B, m), y.reshape(B, m),
            iters.reshape(B), status.reshape(B), rp_o.reshape(B),
            rd_o.reshape(B))


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_shared_solve_f32.restype = I
    lib.admm_shared_solve_f32.argtypes = (
        [P] * 8 + [F] + [P] * 6 + [P] * 7 + [P]
        + [I] * 4 + [F] * 5 + [I] * 6 + [P])


def build_kernel(verbose=False):
    """Compile csrc/admm_shared.cu with nvcc for sm_90a (ops/build.py) and
    load it.  Returns the build's wall seconds (0.0 when the library was
    already loaded).  Raises when nvcc is missing or the build fails."""
    global _LIB
    _LIB, secs = load_library('admm_shared', _bind, verbose=verbose)
    return secs


def admm_shared_solve(Ps, qs, As, ls, us, rho_base, D, E, c_inv,
                      M0, Minv0, x0, z0, y0, *, sigma, alpha,
                      eps_abs, eps_rel, check_interval, max_iter,
                      ns_adapt_iters, adaptive, rho_tol,
                      kkt_refine=1, adapt_until=0, chunk=None):
    """Kernel K1 on scaled data (signature of ``admm_shared_solve_pallas``
    plus ``chunk``).  Ps, M0, Minv0 (n, n) and As (m, n) shared; qs (B, n),
    ls/us/x0/z0/y0 batched.  Returns (x, z, y, iters, status, rp, rd) in
    the scaled space.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (float32) or raise."""
    kw = dict(sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
              check_interval=check_interval, max_iter=max_iter,
              ns_adapt_iters=ns_adapt_iters, adaptive=adaptive,
              rho_tol=rho_tol, kkt_refine=kkt_refine,
              adapt_until=adapt_until, chunk=chunk)
    if qs.device.type == 'cpu':
        return admm_shared_solve_plain(Ps, qs, As, ls, us, rho_base, D, E,
                                       c_inv, M0, Minv0, x0, z0, y0, **kw)
    if qs.device.type != 'cuda':
        raise TypeError(f'shared-KKT kernel: no kernel for {qs.device}')
    m, n = As.shape
    B = qs.shape[0]
    dev = qs.device
    chunk = _resolve_chunk(B, m, n, chunk)
    args = [_checked(Ps, 'Ps', (n, n), dev), _checked(As, 'As', (m, n), dev),
            _checked(As.T.contiguous(), 'At', (n, m), dev),
            _checked(M0, 'M0', (n, n), dev),
            _checked(Minv0, 'Minv0', (n, n), dev),
            _checked(rho_base, 'rho_base', (m,), dev),
            _checked(D, 'D', (n,), dev), _checked(E, 'E', (m,), dev)]
    vecs = [_checked(qs, 'qs', (B, n), dev), _checked(ls, 'ls', (B, m), dev),
            _checked(us, 'us', (B, m), dev), _checked(x0, 'x0', (B, n), dev),
            _checked(z0, 'z0', (B, m), dev), _checked(y0, 'y0', (B, m), dev)]
    build_kernel()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = [torch.empty((B, n), **f32), torch.empty((B, m), **f32),
            torch.empty((B, m), **f32), torch.empty((B,), **i32),
            torch.empty((B,), **i32), torch.empty((B,), **f32),
            torch.empty((B,), **f32)]
    # per block: M, two M^{-1} ping-pong buffers and one temporary (n, n)
    scratch = torch.empty((B // chunk, 4, n, n), **f32)
    max_iter = (max_iter // check_interval) * check_interval
    ptr = [t.data_ptr() for t in args]
    ptr_v = [t.data_ptr() for t in vecs]
    ptr_o = [t.data_ptr() for t in outs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB.admm_shared_solve_f32(
            *ptr, float(c_inv), *ptr_v, *ptr_o, scratch.data_ptr(),
            B, n, m, chunk,
            float(sigma), float(alpha), float(eps_abs), float(eps_rel),
            float(rho_tol),
            int(check_interval), int(max_iter), int(ns_adapt_iters),
            int(bool(adaptive)), int(kkt_refine), int(adapt_until), stream)
    if err != 0:
        raise RuntimeError(f'admm_shared_solve kernel launch failed: CUDA '
                           f'error {err}')
    admm_shared_solve.launches += 1
    return tuple(outs)


admm_shared_solve.launches = 0
