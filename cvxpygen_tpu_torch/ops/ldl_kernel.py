"""Kernels K6-K10: the batched static-pivot blocked LDL^T of the conic IPM's
'ldl' KKT mode, written by hand for Hopper.

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
- K9, ``ldl_factor_inverse_kernel``: factor and explicit inverse in one
  launch (``_factor_inverse_kernel``, wrapper ``ldl_factor_inverse_pallas``),
  the IPM's route under ``CPG_LDL_FUSED=1`` and both levels of its
  two-level route.
- K10, ``ldl_kinv_kernel``: the same function (``_factor_inverse_bm_kernel``,
  wrapper ``ldl_kinv_pallas``), the IPM's route under
  ``CPG_LDL_BM_FUSED=1``.

K9 and K10 launch one fused kernel, csrc/ldl_kinv.cu, each through its own
wrapper and launch count.  On the TPU the two differ in layout: K9
interleaves instances on the vector lanes ((Np, Np, B), the batch on the
fastest axis), because one instruction there covers 128 lanes and a single
instance's narrow rows would leave most of them idle; K10 keeps them
batch-major.  On the H100 every SIMT thread is already a lane of its own,
so the interleaving buys nothing: it cost two transposes of K and Kinv and
made eight instances share one block's shared memory, which then could not
hold their trailing matrices.  The fused kernel gives one instance one
block, as K6 and K7 do, and runs their device code (csrc/ldl_tiles.cuh) in
their order, so its Kinv is bitwise that of K7 on K6's factor.

The contracts are the reference wrappers': the factor is a dict with L
(B, Np, Np), d (B, Np), Linv stored flat (B, nbp * p, p), panel, N and Np,
where Np pads N to a multiple of the panel with an identity tail; the
inverse returns (B, N, N) and the solve (B, N); K9 and K10 take K
(B, N, N) and return the inverse (B, N, N) of the pivot-regularized K.
Each wrapper runs its plain torch version (``ldl_factor_plain``,
``ldl_inverse_plain``, ``ldl_solve_plain``, ``ldl_factor_inverse_plain``,
``ldl_kinv_plain``: the panel math of ops/ldl_batched.py;
``ldl_factor_inverse_plain`` in the reference K9's elimination order) on
CPU tensors, and on CUDA tensors launches its kernel (float32, built with
nvcc at first use, bound with ctypes, one count per launch in
``.launches``) or raises: there is no fallback.

What bounds them on the card (notes in the CUDA sources): bytes (K6: the
lower triangle of K in, L out; K7: the lower triangle of L in, Kinv out;
K8: the lower triangle of L in); the fused kernel operations, narrowly
(N^3 FLOP against the lower triangle of K in, Kinv out).  No batch
padding: every instance is independent, so no block size changes an
answer.  K6 keeps an instance's lower triangle as 16 x 16 tiles in shared
memory up to Np = 320 (three blocks per SM at the entropy shape, Np = 176)
and in a device scratch the wrapper allocates above that
(``factor_layout``).  K7 takes one instance and one tile of columns per
thread block (``inverse_plan``), skips the exact zeros of L^-1 and computes
the lower triangle only, writing the upper one as its transpose; its tile's
right-hand block stays in shared memory where it fits (Np <= 1296) and in a
device scratch the wrapper allocates above that.  The fused kernel keeps
the tiles, the panel inverses, the pivots and one column tile in shared
memory up to Np = 272 (two blocks per SM at Np = 176), else in a device
scratch from which its sweeps stage L as K7 does (``kinv_layout``).
"""
from __future__ import annotations

import ctypes

import torch

from .build import checked, load_library
from .ldl_batched import (ldl_factor, ldl_inverse, ldl_solve, pad_identity,
                          padded_signs)

_LIB_FACTOR = None
_LIB_INVERSE = None
_LIB_SOLVE = None
_LIB_KINV = None
_SIGNS = {}             # (padded signs, device) -> their tensor
# K7 (csrc/ldl_inverse.cu): its column-tile widths, the row stride of a
# staged L21 block and the rows (columns) of L in one stage
_K7_WIDTHS = (16, 32)
_K7_LS = 16 + 4
_K7_CHUNK = 256
# K6 (csrc/ldl_factor.cu): the tiles of the lower triangle are 16 x 16
# floats; its static shared memory (two panels' Minv and pivots); the per-block
# limit; an SM's shared memory and the 1 KB the card reserves per block;
# its threads per block and an SM's threads
_TILE = 16
_K6_STATIC = 2 * 4 * (16 * 16 + 16)
_SMEM_LIMIT = 232448
_SM_SMEM = 233472
_SM_BLOCK_RESERVE = 1024
_K6_THREADS = 256
_SM_THREADS = 2048
# the fused kernel's blocks per SM by registers: __launch_bounds__(256, 2)
# lets a thread take up to 128 of an SM's 65,536 (ptxas: 119-128)
_KINV_REG_BLOCKS = 2


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


def ldl_kinv_plain(K, signs, dyn_delta, panel: int = 16):
    """K10's arithmetic in torch: the batch-major panel factor of K6
    (ops/ldl_batched.ldl_factor), then K7's two panel sweeps on the
    identity; returns the inverse (B, N, N) of the pivot-regularized K."""
    return ldl_inverse(ldl_factor(K, panel=panel, signs=signs,
                                  dyn_delta=dyn_delta))


def factor_layout(N, panel: int = 16):
    """K6's layout for K (B, N, N) (csrc/ldl_factor.cu): the panel p, Np,
    the 16 x 16 tiles of the lower triangle (``tiles``; tile (I, J), J <=
    I, at float (I (I + 1) / 2 + J) * 256), the dynamic shared memory of
    one block (``smem_bytes``, 0 when the tiles live in a device scratch)
    and the thread blocks an SM holds at once (``blocks_per_sm``)."""
    p, Np = _dims(N, panel)
    nbp = Np // p
    tiles = nbp * (nbp + 1) // 2
    words = tiles * _TILE * _TILE
    resident = 4 * words + _K6_STATIC <= _SMEM_LIMIT
    smem = 4 * words if resident else 0
    per_block = smem + _K6_STATIC + _SM_BLOCK_RESERVE
    return dict(p=p, Np=Np, nbp=nbp, tiles=tiles, tile_words=words,
                resident=resident, smem_bytes=smem,
                blocks_per_sm=min(_SM_THREADS // _K6_THREADS,
                                  _SM_SMEM // per_block))


def inverse_smem_bytes(N, width, resident=True, panel: int = 16):
    """Dynamic shared memory of one K7 block (csrc/ldl_inverse.cu
    ``smem_bytes``): the tile's (Np, width + 4) right-hand block when it is
    ``resident``, the panel product (16, width) and two stages of the panel
    inverse and a chunk of at most 256 rows of L, in 16-byte lines."""
    p, Np = _dims(N, panel)
    stage = p * p
    if Np > p:
        stage += min(Np - p, _K7_CHUNK) * _K7_LS
    stage = -(-stage // 4) * 4
    rows = Np * (width + 4) if resident else 0
    return 4 * (rows + 16 * width + 2 * stage)


def inverse_plan(N, width=None, panel: int = 16):
    """K7's launch for a factor of N: the panel p, Np, the column-tile
    width (``width`` pins it), the tiles per instance, whether the tile's
    right-hand block is ``resident`` in shared memory (else in a device
    scratch of ``scratch_words`` floats per instance) and the shared memory
    of one block.  By default the width is 32 (faster than 16 on the H100
    at N=161, B=1024 and at N=321, B=64, chip_smoke.py phase 10), or 16
    where one tile of 16 holds every column (N <= 16).  Every N has a plan;
    raises ValueError for a width the kernel does not take."""
    p, Np = _dims(N, panel)
    if width is None:
        width = 16 if N <= 16 else 32
    if width not in _K7_WIDTHS:
        raise ValueError(f'ldl_inverse kernel: width={width} is not one of '
                         f'{_K7_WIDTHS}')
    tiles = -(-N // width)
    smem = inverse_smem_bytes(N, width, True, panel)
    resident = smem <= _SMEM_LIMIT
    if not resident:
        smem = inverse_smem_bytes(N, width, False, panel)
    return dict(p=p, Np=Np, width=width, tiles=tiles, resident=resident,
                scratch_words=0 if resident else tiles * Np * (width + 4),
                smem_bytes=smem)


def _round4(n):
    return -(-n // 4) * 4


# the fused kernel's layouts (csrc/ldl_kinv.cu): the factor resident in
# shared memory; the factor and the column tile's R in a device scratch
KINV_LAYOUTS = ('resident', 'scratch')


def kinv_smem_bytes(N, width, layout, panel: int = 16):
    """Dynamic shared memory of one block of the fused kernel
    (csrc/ldl_kinv.cu ``smem_bytes``) in ``layout`` (an index into
    ``KINV_LAYOUTS``): resident, K6's tiles, R (Np, width + 4), the panel
    inverses, the pivots (each part rounded to 16-byte lines) and Z
    (16, width); otherwise K7's block with R in the scratch
    (``inverse_smem_bytes``)."""
    if layout:
        return inverse_smem_bytes(N, width, False, panel)
    p, Np = _dims(N, panel)
    return 4 * (factor_layout(N, panel)['tile_words'] + Np * (width + 4)
                + _round4(Np * p) + _round4(Np) + 16 * width)


def kinv_layout(N, panel: int = 16):
    """The fused kernel's launch for K (B, N, N): the panel p, Np, K7's
    column-tile width (``inverse_plan``'s, so that Kinv is bitwise K7's),
    the column tiles per instance, the layout (``KINV_LAYOUTS``: resident
    where its block fits the per-block limit beside the static panel
    buffers, else the scratch), its dynamic shared memory, the device
    scratch per instance (``scratch_words`` floats: the tiles, panel
    inverses, pivots and R) and the thread blocks an SM holds at once (by
    shared memory, and at most two by registers).  Every N has a
    launch."""
    plan = inverse_plan(N, None, panel)
    p, Np, width = plan['p'], plan['Np'], plan['width']
    layout = int(kinv_smem_bytes(N, width, 0, panel) + _K6_STATIC
                 > _SMEM_LIMIT)
    smem = kinv_smem_bytes(N, width, layout, panel)
    scratch = 0
    if layout:
        scratch = (factor_layout(N, panel)['tile_words'] + _round4(Np * p)
                   + _round4(Np) + Np * (width + 4))
    per_block = smem + _K6_STATIC + _SM_BLOCK_RESERVE
    return dict(p=p, Np=Np, width=width, tiles=plan['tiles'],
                layout=KINV_LAYOUTS[layout], layout_id=layout,
                smem_bytes=smem, scratch_words=scratch,
                blocks_per_sm=min(_KINV_REG_BLOCKS, _SM_SMEM // per_block))


# K8 (csrc/ldl_solve.cu): its layouts, the panels the resident one takes
# (one mbarrier each, static shared memory) and its threads per block at
# most; an SM's thread blocks at most
SOLVE_LAYOUTS = ('resident', 'streamed')
_K8_PANELS = 32
_K8_STATIC = 8 * _K8_PANELS
_K8_THREADS = 256
_SM_BLOCKS = 32


def solve_smem_bytes(N, layout, panel: int = 16):
    """Dynamic shared memory of one K8 block (csrc/ldl_solve.cu
    ``smem_words``) in ``layout`` (an index into ``SOLVE_LAYOUTS``):
    resident, 1 KB of slack that starts the strips on a 1024-byte line,
    the strictly lower triangle of L as column strips (strip j: the
    Np - (j + 1) p rows below panel j, p columns each), the panel inverses
    (Np, p) and d; then the right-hand side and the forward solution (Np
    each); every part in 16-byte lines."""
    p, Np = _dims(N, panel)
    nbp = Np // p
    staged = 0
    if layout == 0:
        staged = (256 + _round4(p * p * nbp * (nbp - 1) // 2)
                  + _round4(Np * p) + _round4(Np))
    return 4 * (staged + 2 * _round4(Np))


def solve_plan(N, panel: int = 16):
    """K8's launch for a factor of N: the panel p, Np, the layout
    (``SOLVE_LAYOUTS``: resident at p = 16 where L's strips, the panel
    inverses and d fit one block's shared memory, up to Np = 320, else
    streamed: L, the panel inverses and d read from device memory, L in
    both sweeps), its dynamic
    shared memory, the threads per block (one per row of the padded
    system, in whole warps, at most 256) and the thread blocks an SM holds
    at once by shared memory and threads.  Raises ValueError above Np of
    about 29,000, where r and z leave no room."""
    p, Np = _dims(N, panel)
    layout = int(p != 16 or Np // p > _K8_PANELS
                 or solve_smem_bytes(N, 0, panel) + _K8_STATIC > _SMEM_LIMIT)
    smem = solve_smem_bytes(N, layout, panel)
    if smem + _K8_STATIC > _SMEM_LIMIT:
        raise ValueError(f'ldl_solve kernel: N={N} does not fit shared '
                         'memory')
    threads = min(_K8_THREADS, -(-Np // 32) * 32)
    per_block = smem + _K8_STATIC + _SM_BLOCK_RESERVE
    return dict(p=p, Np=Np, layout=SOLVE_LAYOUTS[layout], layout_id=layout,
                smem_bytes=smem, threads=threads,
                blocks_per_sm=min(_SM_BLOCKS, _SM_THREADS // threads,
                                  _SM_SMEM // per_block))


def ldl_factor_inverse_plain(K, signs, dyn_delta, panel: int = 16):
    """K9's arithmetic in torch, batch-major, in the elimination order of
    the reference's ``_factor_inverse_kernel``: the trailing matrix kept
    square and symmetric, row j of a panel step taken from it (not the
    transposed column), L11's inverse, L21 and the trailing update as
    sequential multiply-add loops over the panel index, then the two panel
    sweeps on the identity the same way.  Returns the inverse (B, N, N) of
    the pivot-regularized K."""
    B, N, _ = K.shape
    p, Np = _dims(N, panel)
    nbp = Np // p
    sg = padded_signs(signs, N, Np)
    delta = float(dyn_delta)
    A = pad_identity(K, Np).clone()
    L = torch.zeros_like(A)              # the L21 blocks
    d = K.new_zeros((B, Np))
    V = K.new_zeros((B, Np, p))          # the panel inverses
    idx = torch.arange(p, device=K.device)
    for k in range(nbp):
        o = k * p
        P = A[:, o:o + p, o:o + p].clone()
        L11 = K.new_zeros((B, p, p))     # strictly lower
        for j in range(p):
            sj = float(sg[o + j])
            dj = (sj * torch.clamp(sj * P[:, j, j], min=delta))[:, None]
            col = torch.where(idx > j, P[:, :, j] / dj, 0.0)
            row = torch.where(idx > j, P[:, j, :] / dj, 0.0)
            L11[:, :, j] = col
            d[:, o + j] = dj[:, 0]
            P = P - dj[:, :, None] * col[:, :, None] * row[:, None, :]
        Linv = K.new_zeros((B, p, p))
        for i in range(p):
            acc = (idx == i).to(K.dtype).expand(B, p)
            for j in range(i):
                acc = acc - L11[:, i, j:j + 1] * Linv[:, j, :]
            Linv[:, i, :] = acc
        V[:, o:o + p, :] = Linv
        if o + p < Np:
            d1 = d[:, None, o:o + p]
            Minv = Linv.transpose(1, 2) / d1
            A21 = A[:, o + p:, o:o + p]
            L21 = A21[:, :, 0:1] * Minv[:, 0:1, :]
            for j in range(1, p):
                L21 = L21 + A21[:, :, j:j + 1] * Minv[:, j:j + 1, :]
            L[:, o + p:, o:o + p] = L21
            W = L21 * d1
            tr = A[:, o + p:, o + p:]
            for j in range(p):
                tr = tr - W[:, :, j:j + 1] * L21[:, None, :, j]
            A[:, o + p:, o + p:] = tr
    # the inverse: forward L Z = I, diagonal, backward L' X = W
    X = torch.eye(Np, dtype=K.dtype, device=K.device).repeat(B, 1, 1)
    for k in range(nbp):
        o = k * p
        Lv, Rk = V[:, o:o + p, :], X[:, o:o + p, :]
        Zk = Lv[:, :, 0:1] * Rk[:, 0:1, :]
        for j in range(1, p):
            Zk = Zk + Lv[:, :, j:j + 1] * Rk[:, j:j + 1, :]
        X[:, o:o + p, :] = Zk
        if o + p < Np:
            L21 = L[:, o + p:, o:o + p]
            Rl = X[:, o + p:, :]
            for j in range(p):
                Rl = Rl - L21[:, :, j:j + 1] * Zk[:, j:j + 1, :]
            X[:, o + p:, :] = Rl
    X = X / d[:, :, None]
    for k in reversed(range(nbp)):
        o = k * p
        LvT, Wk = V[:, o:o + p, :].transpose(1, 2), X[:, o:o + p, :]
        Xk = LvT[:, :, 0:1] * Wk[:, 0:1, :]
        for j in range(1, p):
            Xk = Xk + LvT[:, :, j:j + 1] * Wk[:, j:j + 1, :]
        X[:, o:o + p, :] = Xk
        if o:
            LkT = L[:, o:o + p, :o].transpose(1, 2)
            Ru = X[:, :o, :]
            for j in range(p):
                Ru = Ru - LkT[:, :, j:j + 1] * Xk[:, j:j + 1, :]
            X[:, :o, :] = Ru
    return X[:, :N, :N]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _bind_factor(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldl_factor_f32.restype = I
    lib.ldl_factor_f32.argtypes = [P, I, I, I, I, P, F, P, P, P, P, P]
    lib.ldl_factor_smem_bytes.restype = ctypes.c_longlong
    lib.ldl_factor_smem_bytes.argtypes = [I, I]
    lib.ldl_factor_tile_words.restype = ctypes.c_longlong
    lib.ldl_factor_tile_words.argtypes = [I, I]


def _bind_inverse(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ldl_inverse_f32.restype = I
    lib.ldl_inverse_f32.argtypes = [P, P, P, I, I, I, I, I, P, P, P]
    lib.ldl_inverse_smem_bytes.restype = ctypes.c_longlong
    lib.ldl_inverse_smem_bytes.argtypes = [I, I, I, I]


def _bind_solve(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ldl_solve_f32.restype = I
    lib.ldl_solve_f32.argtypes = [P, P, P, P, I, I, I, I, I, P, P]
    lib.ldl_solve_smem_bytes.restype = ctypes.c_longlong
    lib.ldl_solve_smem_bytes.argtypes = [I, I, I]


def _bind_kinv(lib):
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.ldl_kinv_f32.restype = I
    lib.ldl_kinv_f32.argtypes = [P, I, I, I, I, P, F, I, I, P, P, P]
    lib.ldl_kinv_smem_bytes.restype = LL
    lib.ldl_kinv_smem_bytes.argtypes = [I, I, I, I]
    lib.ldl_kinv_scratch_words.restype = LL
    lib.ldl_kinv_scratch_words.argtypes = [I, I, I, I]


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


def build_kinv_kernel(verbose=False):
    """Compile csrc/ldl_kinv.cu (the fused kernel of K9 and K10) for sm_90a
    and load it."""
    global _LIB_KINV
    _LIB_KINV, secs = load_library('ldl_kinv', _bind_kinv, verbose=verbose)
    return secs


def _cuda_device(t, what):
    if t.device.type != 'cuda':
        raise TypeError(f'{what} kernel: no kernel for {t.device}')
    return t.device


def _signs_on(signs, N, Np, dev):
    """The padded pivot signs as a float32 tensor on ``dev``, uploaded once
    per sign pattern and device: a copy from host memory would synchronize
    the stream on every launch."""
    arr = padded_signs(signs, N, Np)
    key = (arr.tobytes(), str(dev))
    t = _SIGNS.get(key)
    if t is None:
        if len(_SIGNS) >= 64:
            _SIGNS.clear()
        t = _SIGNS[key] = torch.as_tensor(arr, dtype=torch.float32,
                                          device=dev)
    return t


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
    sg = _signs_on(signs, N, Np, dev)
    build_factor_kernel()
    L = torch.empty((B, Np, Np), dtype=torch.float32, device=dev)
    d = torch.empty((B, Np), dtype=torch.float32, device=dev)
    Linv = torch.empty((B, Np, p), dtype=torch.float32, device=dev)
    # the tiles stay in shared memory when they fit, else in a device
    # scratch (same kernel, csrc/ldl_factor.cu)
    lay = factor_layout(N, panel)
    scratch = None
    if not lay['resident']:
        scratch = torch.empty((B, lay['tile_words']), dtype=torch.float32,
                              device=dev)
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
    of ``ldl_inverse_pallas``), launched by ``inverse_plan``'s rule.  CPU
    tensors run ``ldl_inverse_plain``; CUDA tensors launch the kernel
    (float32) or raise."""
    return _inverse_launch(fac, None)


def _inverse_launch(fac, width):
    """``ldl_inverse_kernel`` with the column-tile width pinned (16 or 32;
    None: the plan's), for timing and tests; no width changes the lower
    triangle."""
    if fac['L'].device.type == 'cpu':
        return ldl_inverse_plain(fac)
    dev = _cuda_device(fac['L'], 'LDL inverse')
    B, N, Np, p, L, d, Linv = _fac_args(fac, dev)
    plan = inverse_plan(N, width, p)
    build_inverse_kernel()
    Kinv = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    scratch = None
    if not plan['resident']:
        scratch = torch.empty((B, plan['scratch_words']), dtype=torch.float32,
                              device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB_INVERSE.ldl_inverse_f32(
            L.data_ptr(), d.data_ptr(), Linv.data_ptr(), B, N, Np, p,
            plan['width'], None if scratch is None else scratch.data_ptr(),
            Kinv.data_ptr(), stream)
    _raise_on(err, 'ldl_inverse')
    ldl_inverse_kernel.launches += 1
    return Kinv


ldl_inverse_kernel.launches = 0


def ldl_solve_kernel(fac, b):
    """Solve K x = b (b (B, N) -> x (B, N)) with the factor (K8; the
    contract of ``ldl_solve_pallas``), in ``solve_plan``'s layout.  CPU
    tensors run ``ldl_solve_plain``; CUDA tensors launch the kernel
    (float32) or raise."""
    return _solve_launch(fac, b, None)


def _solve_launch(fac, b, layout):
    """``ldl_solve_kernel`` with the layout pinned (an index into
    ``SOLVE_LAYOUTS``; None: the plan's), for timing and tests; the
    resident layout is refused where it does not fit."""
    if b.device.type == 'cpu':
        return ldl_solve_plain(fac, b)
    dev = _cuda_device(b, 'LDL solve')
    B, N, Np, p, L, d, Linv = _fac_args(fac, dev)
    b = checked(b, 'b', (B, N), dev)
    plan = solve_plan(N, p)
    if layout is None:
        layout = plan['layout_id']
    elif layout not in (0, 1) or layout < plan['layout_id']:
        raise ValueError(f'ldl_solve kernel: layout {layout} does not fit '
                         f'N={N}')
    build_solve_kernel()
    x = torch.empty((B, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB_SOLVE.ldl_solve_f32(
            L.data_ptr(), d.data_ptr(), Linv.data_ptr(), b.data_ptr(), B, N,
            Np, p, int(layout == 0), x.data_ptr(), stream)
    _raise_on(err, 'ldl_solve')
    ldl_solve_kernel.launches += 1
    return x


ldl_solve_kernel.launches = 0



def _kinv_launch(K, signs, dyn_delta, panel: int = 16):
    """One launch of the fused kernel on the CUDA tensor K by
    ``kinv_layout``'s rule.  Returns Kinv (B, N, N)."""
    dev = _cuda_device(K, 'LDL factor+inverse')
    B, N, _ = K.shape
    lay = kinv_layout(N, panel)
    p, Np = lay['p'], lay['Np']
    K = checked(K, 'K', (B, N, N), dev)
    sg = _signs_on(signs, N, Np, dev)
    build_kinv_kernel()
    Kinv = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    # the factor stays in shared memory when it fits, else in a device
    # scratch (same kernel, another layout)
    scratch = None
    if lay['scratch_words']:
        scratch = torch.empty((B, lay['scratch_words']), dtype=torch.float32,
                              device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB_KINV.ldl_kinv_f32(
            K.data_ptr(), B, N, Np, p, sg.data_ptr(), float(dyn_delta),
            lay['width'], lay['layout_id'],
            None if scratch is None else scratch.data_ptr(), Kinv.data_ptr(),
            stream)
    _raise_on(err, 'ldl_kinv')
    return Kinv


def ldl_kinv_kernel(K, signs, dyn_delta, panel: int = 16):
    """Inverse (B, N, N) of the pivot-regularized K (B, N, N), factor and
    inverse in one launch of the fused kernel (K10; the contract of
    ``ldl_kinv_pallas``).  CPU tensors run ``ldl_kinv_plain``; CUDA
    tensors launch the kernel (float32) or raise."""
    if K.device.type == 'cpu':
        return ldl_kinv_plain(K, signs, dyn_delta, panel)
    Kinv = _kinv_launch(K, signs, dyn_delta, panel)
    ldl_kinv_kernel.launches += 1
    return Kinv


ldl_kinv_kernel.launches = 0


def ldl_factor_inverse_kernel(K, signs, dyn_delta, panel: int = 16):
    """Inverse (B, N, N) of the pivot-regularized K (B, N, N), factor and
    inverse in one launch of the fused kernel (K9; the contract of
    ``ldl_factor_inverse_pallas``, whose lane interleaving has no use on
    the card: see the module's notes).  CPU tensors run
    ``ldl_factor_inverse_plain``; CUDA tensors launch the kernel (float32)
    or raise."""
    if K.device.type == 'cpu':
        return ldl_factor_inverse_plain(K, signs, dyn_delta, panel)
    Kinv = _kinv_launch(K, signs, dyn_delta, panel)
    ldl_factor_inverse_kernel.launches += 1
    return Kinv


ldl_factor_inverse_kernel.launches = 0
