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
  or shape the kernel cannot take raises.
- ``admm_iterate_plain``: the same arithmetic in torch (the JAX package's
  ``admm_iterate_reference``).  The CPU tests hold it against the Pallas
  kernel in interpret mode, and ``chip_smoke.py`` holds the CUDA kernel
  against it.
- ``pick_iterate_block``: instances per thread block on the card.
  Instances do not interact, so the block does not change the answer.

What bounds it on the card: bytes.  Each iteration does 2 m n + n^2
multiply-adds on 4 (n^2 + m n) bytes of matrices, and this first design
rereads M^-1 and A from global memory every iteration (see the note in the
CUDA source).  float32 only on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .build import checked, load_library

# per-block dynamic shared memory limit on Hopper (232,448 bytes)
_SMEM_LIMIT = 232448
_LIB = None


def iterate_smem_bytes(n, m):
    """Dynamic shared memory of one block (csrc/admm_iterate.cu,
    ``smem_words``)."""
    return 4 * (4 * n + 7 * m)


def pick_iterate_block(B, m, n):
    """Instances per thread block: 1 (one block per instance, the most
    blocks in flight) when an instance's vectors fit shared memory, else
    None."""
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
    lib.admm_iterate_f32.argtypes = [P] * 12 + [I] * 4 + [F] * 2 + [I, P]


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
    tensors launch the kernel (float32) or raise."""
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
            float(sigma), float(alpha), int(n_iters), stream)
    if err != 0:
        raise RuntimeError(f'admm_iterate kernel launch failed: CUDA error '
                           f'{err}')
    admm_iterate.launches += 1
    return tuple(outs)


admm_iterate.launches = 0
