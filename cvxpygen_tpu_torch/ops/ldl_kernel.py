"""Kernels K6, K7 and K8: the batched static-pivot blocked LDL^T of the conic
IPM's 'ldl' KKT mode, written by hand for Hopper.

- K6, ``ldl_factor_kernel``: L, d and the panel inverses of a batch of
  quasidefinite KKT matrices.  Replaces the JAX package's Pallas TPU kernel
  ``ops/ldl_kernel.py::_factor_kernel`` (wrapper ``ldl_factor_pallas``).
  CUDA source: csrc/ldl_factor.cu.
- K7, ``ldl_inverse_kernel``: the explicit inverse of the factored matrix
  (``_inverse_kernel``, wrapper ``ldl_inverse_pallas``), so that each KKT
  solve is one batched product.  CUDA source: csrc/ldl_inverse.cu.
- K8, ``ldl_solve_kernel``: one solve with the factor (``_solve_kernel``,
  wrapper ``ldl_solve_pallas``), the IPM's route with
  ``IPMSettings(ldl_inverse=False)``.  CUDA source: csrc/ldl_solve.cu.

The contracts are the reference wrappers': the factor is a dict with L
(B, Np, Np), d (B, Np), Linv stored flat (B, nbp * p, p), panel, N and Np,
where Np pads N to a multiple of the panel with an identity tail; the
inverse returns (B, N, N) and the solve (B, N).  Each wrapper runs its
plain torch version (``ldl_factor_plain``, ``ldl_inverse_plain``,
``ldl_solve_plain``: the panel math of ops/ldl_batched.py) on CPU tensors,
and on CUDA tensors launches its kernel (float32, built with nvcc at first
use, bound with ctypes, one count per launch in ``.launches``) or raises:
there is no fallback.

What bounds them on the card (notes in the CUDA sources): bytes (K6: the
lower triangle of K in, L out; K7: the lower triangle of L in, Kinv out;
K8: the lower triangle of L in).  K6 keeps an instance's working matrix in
shared memory up to Np = 224 (the largest multiple of the 16-wide panel
that fits) and in a device scratch the wrapper allocates above that.
"""
from __future__ import annotations

import ctypes

import torch

from .build import checked, load_library
from .ldl_batched import ldl_factor, ldl_inverse, ldl_solve, padded_signs

_LIB_FACTOR = None
_LIB_INVERSE = None
_LIB_SOLVE = None
# K7's grid is (column tiles, instances); grid.y takes at most 65535
_GRID_Y = 65535


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _dims(N, panel):
    p = min(panel, N)
    nbp = -(-N // p)
    return p, nbp * p


def ldl_factor_plain(K, signs, dyn_delta, panel: int = 16):
    """K6's arithmetic in torch (ops/ldl_batched.ldl_factor) with the
    kernel's flat Linv layout (B, nbp * p, p)."""
    fac = ldl_factor(K, panel=panel, signs=signs, dyn_delta=dyn_delta)
    B, nbp, p, _ = fac['Linv'].shape
    fac['Linv'] = fac['Linv'].reshape(B, nbp * p, p)
    return fac


# K7's and K8's arithmetic in torch: (B, N, N) and (B, N)
ldl_inverse_plain = ldl_inverse
ldl_solve_plain = ldl_solve


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _bind_factor(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldl_factor_f32.restype = I
    lib.ldl_factor_f32.argtypes = [P, I, I, I, I, P, F, P, P, P, P, P]
    lib.ldl_factor_smem_bytes.restype = ctypes.c_longlong
    lib.ldl_factor_smem_bytes.argtypes = [I]


def _bind_inverse(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ldl_inverse_f32.restype = I
    lib.ldl_inverse_f32.argtypes = [P, P, P, I, I, I, I, P, P]


def _bind_solve(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ldl_solve_f32.restype = I
    lib.ldl_solve_f32.argtypes = [P, P, P, P, I, I, I, I, P, P]


def build_factor_kernel(verbose=False):
    """Compile csrc/ldl_factor.cu (K6) for sm_90a and load it.  Returns the
    build's wall seconds (0.0 when already loaded)."""
    global _LIB_FACTOR
    _LIB_FACTOR, secs = load_library('ldl_factor', _bind_factor,
                                     verbose=verbose)
    return secs


def build_inverse_kernel(verbose=False):
    """Compile csrc/ldl_inverse.cu (K7) for sm_90a and load it."""
    global _LIB_INVERSE
    _LIB_INVERSE, secs = load_library('ldl_inverse', _bind_inverse,
                                      verbose=verbose)
    return secs


def build_solve_kernel(verbose=False):
    """Compile csrc/ldl_solve.cu (K8) for sm_90a and load it."""
    global _LIB_SOLVE
    _LIB_SOLVE, secs = load_library('ldl_solve', _bind_solve,
                                    verbose=verbose)
    return secs


def _cuda_device(t, what):
    if t.device.type != 'cuda':
        raise TypeError(f'{what} kernel: no kernel for {t.device}')
    return t.device


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err}')


def ldl_factor_kernel(K, signs, dyn_delta, panel: int = 16):
    """Blocked LDL^T of K (B, N, N) with expected pivot signs ``signs``
    (length N, +-1) and pivot floor ``dyn_delta`` (K6; the contract of
    ``ldl_factor_pallas``).  CPU tensors run ``ldl_factor_plain``; CUDA
    tensors launch the kernel (float32) or raise."""
    if K.device.type == 'cpu':
        return ldl_factor_plain(K, signs, dyn_delta, panel)
    dev = _cuda_device(K, 'LDL factor')
    B, N, _ = K.shape
    p, Np = _dims(N, panel)
    K = checked(K, 'K', (B, N, N), dev)
    sg = torch.as_tensor(padded_signs(signs, N, Np), dtype=torch.float32,
                         device=dev)
    build_factor_kernel()
    L = torch.empty((B, Np, Np), dtype=torch.float32, device=dev)
    d = torch.empty((B, Np), dtype=torch.float32, device=dev)
    Linv = torch.empty((B, Np, p), dtype=torch.float32, device=dev)
    # the working matrix stays in shared memory when it fits, else in a
    # device scratch (same kernel, csrc/ldl_factor.cu)
    scratch = None
    if _LIB_FACTOR.ldl_factor_smem_bytes(Np) == 0:
        scratch = torch.empty((B, Np, Np), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB_FACTOR.ldl_factor_f32(
            K.data_ptr(), B, N, Np, p, sg.data_ptr(), float(dyn_delta),
            L.data_ptr(), d.data_ptr(), Linv.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    _raise_on(err, 'ldl_factor')
    ldl_factor_kernel.launches += 1
    return dict(L=L, d=d, Linv=Linv, panel=p, N=N, Np=Np)


ldl_factor_kernel.launches = 0


def _fac_args(fac, dev):
    p, N, Np = fac['panel'], fac['N'], fac['Np']
    B = fac['L'].shape[0]
    if fac['Linv'].dim() != 3:
        raise ValueError('LDL kernels take the flat (B, nbp * p, p) Linv of '
                         'ldl_factor_kernel')
    return (B, N, Np, p, checked(fac['L'], 'L', (B, Np, Np), dev),
            checked(fac['d'], 'd', (B, Np), dev),
            checked(fac['Linv'], 'Linv', (B, Np, p), dev))


def ldl_inverse_kernel(fac):
    """Explicit inverse (B, N, N) of the factored matrix (K7; the contract
    of ``ldl_inverse_pallas``).  CPU tensors run ``ldl_inverse_plain``;
    CUDA tensors launch the kernel (float32) or raise."""
    if fac['L'].device.type == 'cpu':
        return ldl_inverse_plain(fac)
    dev = _cuda_device(fac['L'], 'LDL inverse')
    B, N, Np, p, L, d, Linv = _fac_args(fac, dev)
    build_inverse_kernel()
    Kinv = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # one launch per slice of at most 65535 instances (the grid.y limit);
    # slices of a contiguous batch are contiguous
    for b0 in range(0, B, _GRID_Y):
        b1 = min(B, b0 + _GRID_Y)
        with torch.cuda.device(dev):
            err = _LIB_INVERSE.ldl_inverse_f32(
                L[b0:b1].data_ptr(), d[b0:b1].data_ptr(),
                Linv[b0:b1].data_ptr(), b1 - b0, N, Np, p,
                Kinv[b0:b1].data_ptr(), stream)
        _raise_on(err, 'ldl_inverse')
        ldl_inverse_kernel.launches += 1
    return Kinv


ldl_inverse_kernel.launches = 0


def ldl_solve_kernel(fac, b):
    """Solve K x = b (b (B, N) -> x (B, N)) with the factor (K8; the
    contract of ``ldl_solve_pallas``).  CPU tensors run ``ldl_solve_plain``;
    CUDA tensors launch the kernel (float32) or raise."""
    if b.device.type == 'cpu':
        return ldl_solve_plain(fac, b)
    dev = _cuda_device(b, 'LDL solve')
    B, N, Np, p, L, d, Linv = _fac_args(fac, dev)
    b = checked(b, 'b', (B, N), dev)
    build_solve_kernel()
    x = torch.empty((B, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB_SOLVE.ldl_solve_f32(
            L.data_ptr(), d.data_ptr(), Linv.data_ptr(), b.data_ptr(), B, N,
            Np, p, x.data_ptr(), stream)
    _raise_on(err, 'ldl_solve')
    ldl_solve_kernel.launches += 1
    return x


ldl_solve_kernel.launches = 0

