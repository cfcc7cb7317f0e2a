"""Kernel K3: fused ADMM iteration block, written by hand for Hopper.

Replaces the JAX package's Pallas TPU kernel
``ops/admm_kernel.py::_admm_block_kernel`` (wrapper ``admm_iterate_pallas``)
and computes the same function: ``n_iters`` ADMM iterations for a batch of
QPs, each with its own M^-1 (n, n) and A (m, n) held fixed -- no refinement
sweep and no checks.  The per-instance solve (solvers/admm.py) launches it
once per check interval when ``use_pallas`` is 'auto' or 'always' with the
Newton-Schulz KKT mode.

Three pieces live here:

- ``admm_iterate``: the wrapper.  On CUDA tensors it launches the CUDA
  kernel in ``csrc/admm_iterate.cu`` (built with nvcc at first use, bound
  with ctypes) and counts the launch in ``admm_iterate.launches``; on CPU
  tensors it runs the plain version.  It never falls back: a build, launch
  or shape the kernel cannot take raises.  The solver calls it through
  the operator ``torch.ops.cvxpygen_tpu_torch.admm_iterate``
  (``admm_iterate_op``, with a fake implementation for tracing), since a
  ctypes launch is invisible to ``torch.export``.
- ``admm_iterate_plain``: the same arithmetic in torch (the JAX package's
  ``admm_iterate_reference``).  The CPU tests hold it against the Pallas
  kernel in interpret mode, and ``chip_smoke.py`` holds the CUDA kernel
  against it.
- ``pick_iterate_ctas`` and ``pick_iterate_block``: the layout on the
  card.  An instance's M^-1 and A live in the shared memory of a cluster
  of c thread blocks, c the smallest of 1, 2, 4, 8 that holds them (2 at
  the MPC shape n=222, m=252; 1 at the portfolio shape n=130, m=172); at
  larger shapes (c = 0) one block per instance streams them from global
  memory every iteration.  The shape alone picks the layout (``block`` > 1
  reaches the streaming one for tests).  Instances do not interact, so
  the layout does not change the answer.

What bounds it on the card: shared-memory bandwidth in the resident layout
(each block reads its matrix rows once per iteration; device memory once
per launch), bytes from global memory in the streaming one (see the note
in the CUDA source).  float32 only on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .build import checked, load_library

# per-block dynamic shared memory limit on Hopper (232,448 bytes)
_SMEM_LIMIT = 232448
_LIB = None


_MAX_TEAM = 8


def team_rows(d, c):
    """Rows of d that the first block of a team of c holds
    (csrc/resident.cuh, ``team_rows``)."""
    return min(d, -(-d // c))


def slice_words(rows, n):
    """Shared-memory words of a resident slice (csrc/resident.cuh,
    ``slice_words``)."""
    return (rows * n + 6) // 4 * 4


def iterate_smem_bytes(n, m, ctas=0):
    """Dynamic shared memory of one block (csrc/admm_iterate.cu): the
    streaming layout's vectors (``stream_words``) for ``ctas`` 0, else the
    resident layout's rows of M^-1 and A beside its vectors
    (``resident_words``)."""
    if ctas == 0:
        return 4 * (4 * n + 7 * m)
    rm = team_rows(m, ctas)
    return 4 * (slice_words(team_rows(n, ctas), n) + slice_words(rm, n)
                + 5 * n + 7 * rm)


def pick_iterate_ctas(m, n):
    """Thread blocks per instance in the resident layout: the smallest of
    1, 2, 4, 8 whose blocks hold the instance's rows of M^-1 and A in
    shared memory; 0 (the streaming layout) when none does."""
    for c in (1, 2, 4, _MAX_TEAM):
        if iterate_smem_bytes(n, m, c) <= _SMEM_LIMIT:
            return c
    return 0


def pick_iterate_block(B, m, n):
    """Instances per thread block of the streaming layout: 1 (one block
    per instance, the most blocks in flight) when an instance's vectors fit
    shared memory, else None (no layout takes the shape).  The resident
    layout always takes one instance per cluster."""
    return 1 if iterate_smem_bytes(n, m) <= _SMEM_LIMIT else None


def admm_iterate_plain(Minv, A, q, l, u, rho_vec, x, z, y, sigma, alpha,
                       n_iters):
    """K3's arithmetic in torch; all arrays batched on axis 0."""
    rho_inv = 1.0 / rho_vec
    for _ in range(n_iters):
        v = rho_vec * z - y
        rhs = sigma * x - q + torch.matmul(v[:, None, :], A)[:, 0]
        xt = torch.matmul(Minv, rhs[:, :, None])[..., 0]
        zt = torch.matmul(A, xt[:, :, None])[..., 0]
        x1 = alpha * xt + (1.0 - alpha) * x
        w = alpha * zt + (1.0 - alpha) * z + rho_inv * y
        z = torch.minimum(torch.maximum(w, l), u)
        y = rho_vec * (w - z)
        x = x1
    return x, z, y


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_iterate_f32.restype = I
    lib.admm_iterate_f32.argtypes = [P] * 12 + [I] * 5 + [F] * 2 + [I, P]


def build_kernel(verbose=False):
    """Compile csrc/admm_iterate.cu with nvcc for sm_90a (ops/build.py) and
    load it.  Returns the build's wall seconds (0.0 when already loaded)."""
    global _LIB
    _LIB, secs = load_library('admm_iterate', _bind, verbose=verbose)
    return secs


def admm_iterate(Minv, A, q, l, u, rho_vec, x, z, y, sigma, alpha, n_iters,
                 block=None):
    """Run ``n_iters`` fused ADMM iterations (signature of
    ``admm_iterate_pallas``).  CPU tensors run the plain version; CUDA
    tensors launch the kernel (float32) or raise.  With ``block`` None or 1
    (what the solver passes) the shape alone picks the layout: resident
    where ``pick_iterate_ctas`` finds a c, else streaming at one instance
    per thread block.  ``block`` > 1 (instances per thread block) exists
    only so that tests can reach the streaming layout at shapes where the
    resident one fits."""
    if x.device.type == 'cpu':
        return admm_iterate_plain(Minv, A, q, l, u, rho_vec, x, z, y, sigma,
                                  alpha, n_iters)
    if x.device.type != 'cuda':
        raise TypeError(f'fused iteration kernel: no kernel for {x.device}')
    B, m, n = A.shape
    dev = x.device
    if block is None:
        block = pick_iterate_block(B, m, n)
        if block is None:
            raise ValueError(f'fused iteration kernel: n={n}, m={m} does not '
                             'fit shared memory')
    if B % block:
        raise ValueError(f'fused iteration kernel: block {block} does not '
                         f'divide the batch {B}')
    ctas = pick_iterate_ctas(m, n) if block == 1 else 0
    args = [checked(Minv, 'Minv', (B, n, n), dev),
            checked(A, 'A', (B, m, n), dev), checked(q, 'q', (B, n), dev),
            checked(l, 'l', (B, m), dev), checked(u, 'u', (B, m), dev),
            checked(rho_vec, 'rho_vec', (B, m), dev),
            checked(x, 'x', (B, n), dev), checked(z, 'z', (B, m), dev),
            checked(y, 'y', (B, m), dev)]
    build_kernel()
    outs = [torch.empty((B, n), dtype=torch.float32, device=dev),
            torch.empty((B, m), dtype=torch.float32, device=dev),
            torch.empty((B, m), dtype=torch.float32, device=dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB.admm_iterate_f32(
            *[t.data_ptr() for t in args + outs], B, n, m, int(block),
            ctas, float(sigma), float(alpha), int(n_iters), stream)
    if err != 0:
        raise RuntimeError(f'admm_iterate kernel launch failed: CUDA error '
                           f'{err}')
    admm_iterate.launches += 1
    return tuple(outs)


admm_iterate.launches = 0


@torch.library.custom_op('cvxpygen_tpu_torch::admm_iterate', mutates_args=())
def admm_iterate_op(Minv: torch.Tensor, A: torch.Tensor, q: torch.Tensor,
                    l: torch.Tensor, u: torch.Tensor, rho_vec: torch.Tensor,
                    x: torch.Tensor, z: torch.Tensor, y: torch.Tensor,
                    sigma: float, alpha: float, n_iters: int,
                    block: int) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``admm_iterate`` as an operator that tracers see
    (``torch.ops.cvxpygen_tpu_torch.admm_iterate``): the solve's loop calls
    it, so a program that ``torch.export`` records from the loop launches
    K3 on the card (runtime/aot.py)."""
    return admm_iterate(Minv, A, q, l, u, rho_vec, x, z, y, sigma, alpha,
                        n_iters, block=block)


@admm_iterate_op.register_fake
def _admm_iterate_fake(Minv, A, q, l, u, rho_vec, x, z, y, sigma, alpha,
                       n_iters, block):
    return torch.empty_like(x), torch.empty_like(z), torch.empty_like(y)
