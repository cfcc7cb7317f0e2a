"""Kernels K4 and K5: the shared-KKT banded engine, written by hand for
Hopper.

When a batch shares canonical P and A, the banded KKT matrix
M = P + sigma I + A' diag(rho) A is one block-tridiagonal matrix, factored
once by block cyclic reduction (CR) and packed into one (NB_TOT, s, s)
tensor (ops/banded_grouped.pack_cr_levels).  Two kernels use that factor:

- K4, ``cr_solve``: x = M^-1 b for B right-hand sides.  Replaces the JAX
  package's Pallas TPU kernel ``ops/banded_shared_kernel.py::
  _cr_solve_only_kernel`` (wrapper ``cr_solve_pallas``); the large-nb
  engine (solvers/admm_banded_shared.py ``_impl_crk``) launches it once
  per ADMM iteration.  CUDA source: csrc/cr_solve.cu.
- K5, ``banded_shared_chunk``: ``check_interval`` fused ADMM iterations
  per instance with the grouped-A matvecs (the ops/banded_grouped.py
  layout) and the CR solve, then the residuals and the OSQP section 3.4
  certificates.  Replaces ``_banded_shared_kernel`` (wrapper
  ``banded_shared_chunk``); the small-nb engine (``_impl``) launches it
  once per check interval.  CUDA source: csrc/banded_chunk.cu.

- K11, ``banded_iterate``: ``check_interval`` fused ADMM iterations per
  instance on the rho-scaled state, no checks, for any nb.  Replaces
  ``_banded_iterate_kernel`` (wrapper ``banded_iterate``), which the
  reference ships but no solver calls; no solver of the port calls it
  either.  CUDA source: csrc/banded_iterate.cu.

All three share the grouped CR solve of csrc/cr_group.cuh (instances in
groups, the factor staged per group).  Each wrapper
runs its plain torch version (``cr_solve_plain``,
``banded_shared_chunk_plain``, ``banded_iterate_plain``, the same
arithmetic) on CPU tensors and launches its CUDA kernel (float32, built
with nvcc at first use, bound with ctypes, one count per launch in
``.launches``) on CUDA tensors, or raises: there is no fallback.

Layouts are the JAX wrappers': x/q/b (nb, s, B); z/y/l/u (nb, r_max, B);
D (nb, s), E/E_inv/rho (nb, r_max) shared; done (1, 1, B) int32; flags
bit-packed 1 ok, 2 p_inf, 4 d_inf.  The reference tiles the batch into
VMEM-sized chunks (its ``pick_banded_chunk``); nothing in any of the
kernels depends on the tiling, because every decision that couples
instances (done, adaptive rho, refactorization) is the solve loop's, over
the whole batch.  So the port has no chunk argument: each kernel takes a
group of 1-8 consecutive instances per thread block (``pick_cr_group``),
which shares each read of the shared matrices and changes no bit of the
answer.

What bounds them on the card: K4 is bytes-bound (b in, x out and the
factor once: 9.6 MB against 89 MFLOP at charging T=1440, B=256); its
dependent levels and the factor's trips from L2 set its time, so its
groups stage the factor through shared memory (csrc/cr_solve.cu).  K5 and
K11 are bound by operations on paper; in practice the shared factor and
grouped A that every iteration reads set their time (340 KB at MPC H=30,
2.4 MB at charging), so their groups share those reads and stage the
factor (K5 also the A windows) through shared memory by bulk copies.  K11
keeps only x and the CR state of its group there and reads z, y, l, u and
q from device memory every iteration.  See the notes in the CUDA
sources.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import checked, load_library

_INF = 1e30
# per-block dynamic shared memory limit on Hopper (232,448 bytes)
_SMEM_LIMIT = 232448
# levels csrc/cr.cuh takes (nb < 2**32)
_MAX_LEVELS = 32

# K4's launch (csrc/cr_solve.cu): threads per block, (block, row) pairs per
# thread and step, words between two state blocks, factor stages times
# factor kinds per step, and the static level table's bytes
_CR_THREADS = 256
_CR_PAIRS = 2
_CR_PAD = 4
_CR_STAGE_SLOTS = 3 * 3
_CR_STATIC = 4 * 9 * _MAX_LEVELS
_CR_GROUPS = (1, 2, 4, 8)

_LIB_CR = None
_CR_READY = set()       # devices whose K4 kernels may take the smem limit
_CR_TABLES = {}         # (nb, s, root, total) -> ctypes level table
_LIB_CHUNK = None
_LIB_ITERATE = None


def cr_level_shapes(nb):
    """Static per-level shapes of cr_factor for nb starting blocks:
    list of dicts(nb_in, nb_pad, n2) ending when one block remains."""
    out = []
    while nb > 1:
        nbp = nb + (nb % 2)
        n2 = nbp // 2
        out.append(dict(nb_in=nb, nb_pad=nbp, n2=n2))
        nb = n2
    return out


def estimate_nb_tot(nb):
    """Total (s, s) blocks in the packed CR factor (pack_cr_levels
    layout): per level Dinv(n2) + A(n2-1) + C(n2) + L_left(n2-1) +
    L_even(n2), plus the root."""
    tot = 1
    for shp in cr_level_shapes(nb):
        n2 = shp['n2']
        tot += 5 * n2 - 2
    return tot


def cr_meta_array(meta, nb, s):
    """The packed factor's metadata as the flat int list that csrc/cr.cuh
    reads (``CrMeta``): n_levels, root, nb, s, then per level nb_in, n2
    and the offsets/counts of Dinv_odd, A, C, L_left, L_even."""
    levels = cr_level_shapes(nb)
    if len(levels) > _MAX_LEVELS:
        raise ValueError(f'CR solve: {len(levels)} levels > {_MAX_LEVELS}')
    out = [len(levels), meta['root'], nb, s]
    for lvm, shp in zip(meta['levels'], levels):
        out += [shp['nb_in'], shp['n2'], lvm['Dinv_odd'][0], lvm['A'][0],
                lvm['A'][1], lvm['C'][0], lvm['L_left'][0],
                lvm['L_left'][1], lvm['L_even'][0]]
    return out


def pick_cr_group(B, sms=132):
    """K4's instances per thread block for a batch of B on a card of
    ``sms`` SMs: the fewest (1, 2, 4 or 8) that fit the batch in one wave
    of one block per SM, else 8.  One block per SM is what K4's shared
    memory allows at charging.  On the H100 (132 SMs) at charging T=1440
    (chip_smoke.py phase 7) that is 1 at B=1 and 3 (the fastest there), 2
    at B=256 (as fast as 4, twice as fast as 1) and 8 at B=2048 (the
    fastest)."""
    g = 1
    while g < 8 and -(-B // g) > sms:
        g *= 2
    return g


def cr_group_smem_bytes(nb, s, group, tile):
    """Dynamic shared memory of one K4 block (csrc/cr_solve.cu
    ``smem_bytes``): the state of ``group`` instances (nb blocks of s rows
    of ``group``-wide vectors, _CR_PAD words apart) and three stages of
    three factor slots of ``tile`` s x s blocks each."""
    return 4 * (nb * (s * group + _CR_PAD)
                + _CR_STAGE_SLOTS * tile * s * s)


@functools.lru_cache(maxsize=None)
def cr_launch_plan(nb, s, B, group=None, sms=132):
    """K4's launch for b (nb, s, B) on a card of ``sms`` SMs: (group, tile,
    smem bytes).  ``group`` instances per thread block (``pick_cr_group``
    unless pinned; a smaller one where the state does not fit), so
    ceil(B / group) blocks, the last one partial when group does not
    divide B; ``tile`` block pairs per step, as many as the threads take
    (two pairs each) and shared memory holds.  Raises ValueError when no
    plan fits."""
    if s % 4:
        raise ValueError(f'CR solve kernel: s={s} is not a multiple of 4')
    if group is not None and group not in _CR_GROUPS:
        raise ValueError(f'CR solve kernel: group={group} is not one of '
                         f'{_CR_GROUPS}')
    cap = pick_cr_group(B, sms) if group is None else group
    max_tile = _CR_PAIRS * _CR_THREADS // s
    for g in [g for g in reversed(_CR_GROUPS) if g <= cap]:
        words = (_SMEM_LIMIT - _CR_STATIC) // 4 - nb * (s * g + _CR_PAD)
        tile = min(max_tile, words // (_CR_STAGE_SLOTS * s * s))
        if tile >= 1:
            return g, tile, cr_group_smem_bytes(nb, s, g, tile)
        if group is not None:
            break
    raise ValueError(f'CR solve kernel: nb={nb}, s={s} does not fit shared '
                     f'memory at {cap} instances per block')


# K5's launch (csrc/banded_chunk.cu): CR block pairs and A blocks per step
# at most (fewer, larger steps are faster on the H100: a step's barrier and
# latency cost more than its work; 24 takes MPC H=30's 21 first-level
# pairs in one step, and more measured no faster), the ring's stages, and
# the static shared memory of a block beside the level table: the residual
# pass's per-warp maxima and sums of each instance, and one mbarrier per
# stage
_CHUNK_STEP = 24
_CHUNK_RING = 2
_CHUNK_RED = 4 * 8 * (14 + 2)
_CHUNK_BARS = 8 * _CHUNK_RING


def _r4(words):
    return -(-words // 4) * 4


def chunk_smem_bytes(nb, s, r_max, group, tile, gt):
    """Dynamic shared memory of one K5 block (csrc/banded_chunk.cu
    ``smem_words``): the CR state of ``group`` instances (nb blocks of s
    rows of ``group``-wide vectors, _CR_PAD words apart), their x, z, y and
    v = rho z - y, rho once, and a ring of two stages, each the larger of
    a CR step's three slots of ``tile`` s x s blocks and an A step's B0 and
    B1 windows of ``gt`` blocks; every part in 16-byte lines."""
    nx, nr = nb * s, nb * r_max
    stage = _r4(max(3 * tile * s * s, 2 * gt * r_max * s))
    return 4 * (nb * (s * group + _CR_PAD) + _r4(nx * group)
                + 3 * _r4(nr * group) + _r4(nr) + _CHUNK_RING * stage)


@functools.lru_cache(maxsize=None)
def chunk_launch_plan(nb, s, r_max, B, group=None, sms=132):
    """K5's launch for x (nb, s, B), z (nb, r_max, B) on a card of ``sms``
    SMs: (group, tile, gt, smem bytes).  ``group`` instances per thread
    block (K4's rule, ``pick_cr_group``, unless pinned: one block per SM
    is what K5's shared memory allows too, and on the H100 at MPC H=30 the
    rule's 2 at B=256 and 8 at B=2048 are the fastest, chip_smoke.py phase
    8; a smaller group where the state does not fit), so ceil(B / group)
    blocks, the last one partial when group does not divide B; ``tile`` CR
    block pairs and ``gt`` A blocks per step, each at most _CHUNK_STEP and
    as many as shared memory holds.  Raises ValueError when no plan
    fits."""
    if s % 4:
        raise ValueError(f'banded chunk kernel: s={s} is not a multiple of '
                         '4')
    if group is not None and group not in _CR_GROUPS:
        raise ValueError(f'banded chunk kernel: group={group} is not one of '
                         f'{_CR_GROUPS}')
    cap = pick_cr_group(B, sms) if group is None else group
    tile_cap = min(_CHUNK_STEP, _CR_PAIRS * _CR_THREADS // s)
    gt_cap = min(_CHUNK_STEP, nb)
    for g in [g for g in reversed(_CR_GROUPS) if g <= cap]:
        budget = _SMEM_LIMIT - _CR_STATIC - _CHUNK_RED * g - _CHUNK_BARS
        room = ((budget - chunk_smem_bytes(nb, s, r_max, g, 0, 0))
                // (16 * _CHUNK_RING) * 4)
        tile = min(tile_cap, room // (3 * s * s))
        gt = min(gt_cap, room // (2 * r_max * s))
        if tile >= 1 and gt >= 1:
            return g, tile, gt, chunk_smem_bytes(nb, s, r_max, g, tile, gt)
        if group is not None:
            break
    raise ValueError(f'banded chunk kernel: nb={nb}, s={s}, r_max={r_max} '
                     f'does not fit shared memory at {cap} instances per '
                     'block')


# K11's launch (csrc/banded_iterate.cu): the stages of its factor ring and
# the static shared memory of a block beside the level table (one mbarrier
# per stage)
_ITER_RING = 3
_ITER_BARS = 8 * _ITER_RING


def iterate_smem_bytes(nb, s, group, tile, kkt_refine):
    """Dynamic shared memory of one K11 block (csrc/banded_iterate.cu
    ``smem_words``): the CR state of ``group`` instances (nb blocks of s
    rows of ``group``-wide vectors, _CR_PAD words apart), their x, with
    ``kkt_refine`` > 0 also their refined solution and right-hand side
    (x's layout), and a ring of three stages of three factor slots of
    ``tile`` s x s blocks; every part in 16-byte lines."""
    return 4 * (nb * (s * group + _CR_PAD)
                + (3 if kkt_refine else 1) * _r4(nb * s * group)
                + _ITER_RING * _r4(3 * tile * s * s))


def iterate_scratch_words(nb, s, r_max, B, group):
    """Floats of K11's device scratch (csrc/banded_iterate.cu): per group
    of instances (ceil(B / group)) its z, y, l, u (nb r_max rows each) and
    q (nb s rows), rows of ``group`` adjacent instances."""
    return (4 * nb * r_max + nb * s) * group * -(-B // group)


@functools.lru_cache(maxsize=None)
def iterate_launch_plan(nb, s, B, kkt_refine, group=None, sms=132):
    """K11's launch for x (nb, s, B) on a card of ``sms`` SMs: (group,
    tile, smem bytes).  ``group`` instances per thread block (K4's rule,
    ``pick_cr_group``, unless pinned: one block per SM; a smaller group
    where its state does not fit), so ceil(B / group) blocks, the last one
    partial when group does not divide B; ``tile`` CR block pairs per step,
    as many as the threads take (two pairs each) and shared memory holds.
    z, y, l, u and q stay in device memory, so r_max does not enter.
    Raises ValueError when no plan fits."""
    if s % 4:
        raise ValueError(f'banded iterate kernel: s={s} is not a multiple '
                         'of 4')
    if group is not None and group not in _CR_GROUPS:
        raise ValueError(f'banded iterate kernel: group={group} is not one '
                         f'of {_CR_GROUPS}')
    cap = pick_cr_group(B, sms) if group is None else group
    tile_cap = _CR_PAIRS * _CR_THREADS // s
    budget = _SMEM_LIMIT - _CR_STATIC - _ITER_BARS
    for g in [g for g in reversed(_CR_GROUPS) if g <= cap]:
        room = budget - iterate_smem_bytes(nb, s, g, 0, kkt_refine)
        tile = min(tile_cap, room // (4 * _ITER_RING * 3 * s * s))
        if tile >= 1:
            return g, tile, iterate_smem_bytes(nb, s, g, tile, kkt_refine)
        if group is not None:
            break
    raise ValueError(f'banded iterate kernel: nb={nb}, s={s}, kkt_refine='
                     f'{kkt_refine} does not fit shared memory at {cap} '
                     'instances per block')


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mv(M3, v3):
    """Batched block matvec: M3 (n, s, s) x v3 (n, s, B) -> (n, s, B)."""
    return torch.matmul(M3, v3)


def _mvT(M3, v3):
    """Transposed block matvec: out = M3' v3 per block."""
    return torch.matmul(M3.transpose(1, 2), v3)


def cr_solve_plain(fac_packed, meta, b):
    """K4's arithmetic in torch: the shared-factor CR solve of the
    reference's ``_cr_solve_inkernel`` on b (nb, s, B)."""
    from ..solvers.admm import full_f32_matmul
    nb0, s, B = b.shape
    fac = fac_packed
    stack = []
    with full_f32_matmul():
        for lvm, shp in zip(meta['levels'], cr_level_shapes(nb0)):
            if shp['nb_pad'] != shp['nb_in']:
                b = torch.cat([b, b.new_zeros((1, s, B))], dim=0)
            n2 = shp['n2']
            b4 = b.reshape(n2, 2, s, B)
            b_even = b4[:, 0]
            b_odd = b4[:, 1]
            oA, nA = lvm['A']
            oC, nC = lvm['C']
            if nA:
                bp = torch.cat([b_even[:1], b_even[1:]
                                - _mv(fac[oA:oA + nA], b_odd[:nA])], dim=0)
            else:
                bp = b_even
            b = bp - _mv(fac[oC:oC + nC], b_odd)
            stack.append(b_odd)
        oR = meta['root']
        x = _mv(fac[oR:oR + 1], b)
        for lvm, shp, b_odd in zip(reversed(meta['levels']),
                                   reversed(cr_level_shapes(nb0)),
                                   reversed(stack)):
            n2 = shp['n2']
            x = x[:n2]
            oD, nD = lvm['Dinv_odd']
            oLe, nLe = lvm['L_even']
            oLl, nLl = lvm['L_left']
            r = b_odd - _mv(fac[oLe:oLe + nLe], x)
            if nLl:
                up = _mvT(fac[oLl:oLl + nLl], x[1:1 + nLl])
                r = torch.cat([r[:nLl] - up, r[nLl:]], dim=0)
            x_odd = _mv(fac[oD:oD + nD], r)
            x = torch.stack([x, x_odd], dim=1).reshape(2 * n2, s, B)
    return x[:nb0]


def _check_refine(kkt_refine):
    # CR is a direct factorization: the solve loop never refines (reference
    # solvers/admm_banded_shared.py:486), so neither version has the branch
    if kkt_refine != 0:
        raise ValueError(f'banded chunk kernel: kkt_refine={kkt_refine}; '
                         'only 0 is supported (the CR solve is direct)')


def grouped_av(B0, B1, x):
    """The grouped A product (ops/banded_grouped.py layout): x (nb, s, B)
    -> (nb, r_max, B); the B1 half reads the next block."""
    x_hi = torch.cat([x[1:], x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)
    return torch.matmul(B0, x) + torch.matmul(B1, x_hi)


def grouped_atv(B0, B1, v):
    """The grouped A' product: v (nb, r_max, B) -> (nb, s, B); the B1 half
    lands one block down."""
    lo = _mvT(B0, v)
    hi = _mvT(B1, v)
    return torch.cat([lo[:1], lo[1:] + hi[:-1]], dim=0)


def bt_mv(Dm, Lm, xb):
    """Block-tridiagonal matvec with shared blocks: diagonal Dm (nb, s, s),
    sub-diagonal Lm (nb - 1, s, s); xb (nb, s, B)."""
    yv = _mv(Dm, xb)
    lo = _mv(Lm, xb[:-1])
    up = _mvT(Lm, xb[1:])
    yv = torch.cat([yv[:1], yv[1:] + lo], dim=0)
    return torch.cat([yv[:-1] + up, yv[-1:]], dim=0)


def banded_shared_chunk_plain(fac_packed, meta, B0, B1, D_P, L_P, D_M, L_M,
                              D, E_inv, E, rho, c_inv, q, l, u, x, z, y,
                              done, *, sigma, alpha, eps_abs, eps_rel,
                              check_interval, kkt_refine,
                              solve=cr_solve_plain):
    """K5's arithmetic in torch on the whole batch; same contract as
    ``banded_shared_chunk`` (x, z, y are updated in place).  ``solve`` is
    the CR solve ``(fac_packed, meta, rhs) -> x``: the plain version by
    default, kernel K4 in the large-nb engine."""
    from ..solvers.admm import full_f32_matmul
    _check_refine(kkt_refine)
    B = x.shape[-1]
    dtype = x.dtype
    rho3 = rho.to(dtype)[:, :, None]            # (nb, r_max, 1), pads 1
    E_inv3 = E_inv.to(dtype)[:, :, None]        # pads 0
    E3 = E.to(dtype)[:, :, None]
    D3 = D.to(dtype)[:, :, None]
    D_inv3 = 1.0 / D3
    cinv = float(c_inv)

    def Av(xb):
        return grouped_av(B0, B1, xb)

    def Atv(v):
        return grouped_atv(B0, B1, v)

    def inf_norm(v):                    # (nb, ., B) -> (B,)
        return torch.amax(torch.abs(v), dim=(0, 1))

    with full_f32_matmul():
        x0, z0, y0 = x.clone(), z.clone(), y.clone()
        xn, zn, yn = x0, z0, y0
        for _ in range(check_interval):
            rhs = sigma * xn - q + Atv(rho3 * zn - yn)
            xt = solve(fac_packed, meta, rhs)
            zt = Av(xt)
            x1 = alpha * xt + (1.0 - alpha) * xn
            w = alpha * zt + (1.0 - alpha) * zn + yn / rho3
            zn = torch.minimum(torch.maximum(w, l), u)
            yn = rho3 * (w - zn)
            xn = x1
        dn = done > 0                                   # (1, 1, B)
        keep = 1.0 - dn.to(dtype)
        dx = keep * (xn - x0)
        dy = keep * (yn - y0)
        xs = torch.where(dn, x0, xn)
        zs = torch.where(dn, z0, zn)
        ys = torch.where(dn, y0, yn)

        Ax = Av(xs)
        Aty = Atv(ys)
        Px = bt_mv(D_P, L_P, xs)
        rp = inf_norm(E_inv3 * (Ax - zs))
        rp_den = torch.maximum(inf_norm(E_inv3 * Ax), inf_norm(E_inv3 * zs))
        rd = cinv * inf_norm(D_inv3 * (Px + q + Aty))
        rd_den = cinv * torch.maximum(
            torch.maximum(inf_norm(D_inv3 * Px), inf_norm(D_inv3 * Aty)),
            inf_norm(D_inv3 * q))
        ok = ((rp <= eps_abs + eps_rel * rp_den)
              & (rd <= eps_abs + eps_rel * rd_den))

        # infeasibility certificates (OSQP section 3.4) on the deltas
        eps_inf = 1e-4
        Edy = E3 * dy
        dy_n = inf_norm(Edy) * cinv
        cert_p1 = inf_norm(D_inv3 * Atv(dy)) * cinv <= eps_inf * dy_n
        u_open = u >= _INF * 0.5
        l_open = l <= -_INF * 0.5
        u_fin = torch.where(u_open, torch.zeros_like(u), u * E_inv3)
        l_fin = torch.where(l_open, torch.zeros_like(l), l * E_inv3)
        sup = torch.sum(u_fin * torch.clamp(Edy, min=0.0)
                        + l_fin * torch.clamp(Edy, max=0.0),
                        dim=(0, 1)) * cinv
        open_dir = (torch.any((dy > 1e-12) & u_open, dim=1).any(dim=0)
                    | torch.any((dy < -1e-12) & l_open, dim=1).any(dim=0))
        p_inf = ((dy_n > 1e-10) & cert_p1 & (sup <= -eps_inf * dy_n)
                 & ~open_dir)

        Adx = Av(dx)
        dx_n = inf_norm(D3 * dx)
        cert_d1 = (inf_norm(D_inv3 * bt_mv(D_P, L_P, dx)) * cinv
                   <= eps_inf * dx_n)
        cert_d2 = torch.sum(q * dx, dim=(0, 1)) * cinv <= -eps_inf * dx_n
        up_ok = u_open | (E_inv3 * Adx <= eps_inf * dx_n)
        lo_ok = l_open | (E_inv3 * Adx >= -eps_inf * dx_n)
        d_inf = ((dx_n > 1e-10) & cert_d1 & cert_d2
                 & torch.all((up_ok & lo_ok).reshape(-1, B), dim=0))
    flags = (ok.to(torch.int32) + 2 * p_inf.to(torch.int32)
             + 4 * d_inf.to(torch.int32))
    # in place, as the kernel (the reference aliases x, z, y to its outputs)
    x.copy_(xs)
    z.copy_(zs)
    y.copy_(ys)
    return x, z, y, rp, rd, rp_den, rd_den, flags


def banded_iterate_plain(fac_packed, meta, B0, B1, D_M, L_M, rho_g, q, l, u,
                         x, z, y, *, sigma, alpha, check_interval,
                         kkt_refine, solve=cr_solve_plain):
    """K11's arithmetic in torch: the reference kernel's iteration on the
    rho-scaled state (z and the bounds l, u arrive multiplied by rho, as
    its caller passes them; the A stores of the z-update are scaled by
    ``rho_g`` here), with ``kkt_refine`` sweeps of refinement against the
    banded M = (D_M, L_M).  Same contract as ``banded_iterate``: x, z, y
    are updated in place.  ``solve`` is the CR solve: the plain version by
    default, kernel K4 for the K4 route."""
    from ..solvers.admm import full_f32_matmul
    rho3 = rho_g.to(x.dtype)[:, :, None]
    with full_f32_matmul():
        B0r, B1r = B0 * rho3, B1 * rho3
        xn, zn, yn = x, z, y
        for _ in range(check_interval):
            rhs = sigma * xn - q + grouped_atv(B0, B1, zn - yn)
            xt = solve(fac_packed, meta, rhs)
            for _ in range(kkt_refine):
                xt = xt + solve(fac_packed, meta,
                                rhs - bt_mv(D_M, L_M, xt))
            wt = (alpha * grouped_av(B0r, B1r, xt) + (1.0 - alpha) * zn
                  + yn)
            z1 = torch.minimum(torch.maximum(wt, l), u)
            yn = wt - z1
            zn = z1
            xn = alpha * xt + (1.0 - alpha) * xn
    x.copy_(xn)
    z.copy_(zn)
    y.copy_(yn)
    return x, z, y


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _bind_cr(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cr_solve_f32.restype = I
    lib.cr_solve_f32.argtypes = [P, P, P, I, P, I, I, P]
    lib.cr_solve_smem_bytes.restype = ctypes.c_longlong
    lib.cr_solve_smem_bytes.argtypes = [I, I, I, I]
    lib.cr_solve_init.restype = I
    lib.cr_solve_init.argtypes = []


def _bind_chunk(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.banded_chunk_f32.restype = I
    lib.banded_chunk_f32.argtypes = ([P] * 21 + [P] + [I] * 5 + [F] * 5
                                     + [I] * 3 + [P])
    lib.banded_chunk_smem_bytes.restype = ctypes.c_longlong
    lib.banded_chunk_smem_bytes.argtypes = [I] * 6


def _bind_iterate(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.banded_iterate_f32.restype = I
    lib.banded_iterate_f32.argtypes = ([P] * 14 + [P] + [I] * 6 + [F] * 2
                                       + [I] * 2 + [P])
    lib.banded_iterate_smem_bytes.restype = ctypes.c_longlong
    lib.banded_iterate_smem_bytes.argtypes = [I] * 5


def build_cr_kernel(verbose=False):
    """Compile csrc/cr_solve.cu (K4) for sm_90a and load it.  Returns the
    build's wall seconds (0.0 when already loaded)."""
    global _LIB_CR
    _LIB_CR, secs = load_library('cr_solve', _bind_cr, verbose=verbose)
    return secs


def build_chunk_kernel(verbose=False):
    """Compile csrc/banded_chunk.cu (K5) for sm_90a and load it.  Returns
    the build's wall seconds (0.0 when already loaded)."""
    global _LIB_CHUNK
    _LIB_CHUNK, secs = load_library('banded_chunk', _bind_chunk,
                                    verbose=verbose)
    return secs


def build_iterate_kernel(verbose=False):
    """Compile csrc/banded_iterate.cu (K11) for sm_90a and load it.
    Returns the build's wall seconds (0.0 when already loaded)."""
    global _LIB_ITERATE
    _LIB_ITERATE, secs = load_library('banded_iterate', _bind_iterate,
                                      verbose=verbose)
    return secs


@functools.lru_cache(maxsize=None)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _meta_ptr(meta, nb, s):
    """The ctypes level table of cr_meta_array, built once per packed
    structure (the metadata of pack_cr_levels follows from nb alone, and
    its root and total offsets tell two structures apart)."""
    key = (nb, s, meta['root'], meta['total'])
    arr = _CR_TABLES.get(key)
    if arr is None:
        vals = cr_meta_array(meta, nb, s)
        arr = _CR_TABLES[key] = (ctypes.c_int * len(vals))(*vals)
    return arr


def _in_place(t, name, shape, dev):
    """An output updated in place: float32, contiguous, on ``dev``."""
    if t.device != dev or t.dtype != torch.float32:
        raise TypeError(f'{name}: float32 on {dev} expected, got {t.dtype} '
                        f'on {t.device}')
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f'{name}: a contiguous {tuple(shape)} tensor is '
                         f'updated in place, got {tuple(t.shape)}')
    return t


def cr_solve(fac_packed, meta, b, group=None):
    """Shared-factor CR solve for a batch of right-hand sides (K4):
    fac_packed (NB_TOT, s, s) from pack_cr_levels, b (nb, s, B); returns
    x (nb, s, B).  ``group`` pins the instances per thread block (1, 2, 4
    or 8; ``cr_launch_plan``'s rule by default); no bit of x depends on it.
    CPU tensors run ``cr_solve_plain``; CUDA tensors launch the kernel
    (float32) or raise."""
    if b.device.type == 'cpu':
        return cr_solve_plain(fac_packed, meta, b)
    if b.device.type != 'cuda':
        raise TypeError(f'CR solve kernel: no kernel for {b.device}')
    nb, s, B = b.shape
    dev = b.device
    fac = checked(fac_packed, 'fac_packed', (meta['total'], s, s), dev)
    b = checked(b, 'b', (nb, s, B), dev)
    g, tile, _ = cr_launch_plan(nb, s, B, group, _sm_count(dev))
    if _LIB_CR is None:
        build_cr_kernel()
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if dev.index not in _CR_READY:
            err = _LIB_CR.cr_solve_init()
            if err != 0:
                raise RuntimeError(f'cr_solve kernel set-up failed: CUDA '
                                   f'error {err}')
            _CR_READY.add(dev.index)
        err = _LIB_CR.cr_solve_f32(fac.data_ptr(), b.data_ptr(),
                                   x.data_ptr(), B, _meta_ptr(meta, nb, s),
                                   g, tile, stream)
    if err != 0:
        raise RuntimeError(f'cr_solve kernel launch failed: CUDA error {err}')
    cr_solve.launches += 1
    return x


cr_solve.launches = 0


def banded_shared_chunk(fac_packed, meta, B0, B1, D_P, L_P, D_M, L_M, D,
                        E_inv, E, rho, c_inv, q, l, u, x, z, y, done, *,
                        sigma, alpha, eps_abs, eps_rel, check_interval,
                        kkt_refine, group=None):
    """Run check_interval fused iterations on the whole batch (K5).

    Layouts (as solvers/admm_banded_shared.py prepares them): q/x
    (nb, s, B); l/u/z/y (nb, r_max, B); D (nb, s) / E, E_inv, rho
    (nb, r_max) shared; done (1, 1, B) int32.
    x, z, y are updated IN PLACE (the reference aliases them to its
    outputs); done instances keep their state.  D_M and L_M (the banded M)
    serve only a refinement sweep, which the CR solve does not need:
    ``kkt_refine`` must be 0.  ``group`` pins the instances per thread
    block (1, 2, 4 or 8; ``chunk_launch_plan``'s rule by default); no bit
    of the result depends on it.  Returns (x, z, y, rp, rd, rp_den, rd_den,
    flags), the last five of shape (B,).  CPU tensors run
    ``banded_shared_chunk_plain``; CUDA tensors launch the kernel (float32)
    or raise."""
    _check_refine(kkt_refine)
    args = (fac_packed, meta, B0, B1, D_P, L_P, D_M, L_M, D, E_inv, E, rho,
            c_inv, q, l, u, x, z, y, done)
    kw = dict(sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
              check_interval=check_interval, kkt_refine=kkt_refine)
    if x.device.type == 'cpu':
        return banded_shared_chunk_plain(*args, **kw)
    if x.device.type != 'cuda':
        raise TypeError(f'banded chunk kernel: no kernel for {x.device}')
    nb, s, B = x.shape
    r_max = l.shape[1]
    dev = x.device
    g, tile, gt, _ = chunk_launch_plan(nb, s, r_max, B, group,
                                       _sm_count(dev))
    ins = [checked(fac_packed, 'fac_packed', (meta['total'], s, s), dev),
           checked(B0, 'B0', (nb, r_max, s), dev),
           checked(B1, 'B1', (nb, r_max, s), dev),
           checked(D_P, 'D_P', (nb, s, s), dev),
           checked(L_P, 'L_P', (nb - 1, s, s), dev),
           checked(D, 'D', (nb, s), dev),
           checked(E_inv, 'E_inv', (nb, r_max), dev),
           checked(E, 'E', (nb, r_max), dev),
           checked(rho, 'rho', (nb, r_max), dev),
           checked(q, 'q', (nb, s, B), dev),
           checked(l, 'l', (nb, r_max, B), dev),
           checked(u, 'u', (nb, r_max, B), dev)]
    state = [_in_place(x, 'x', (nb, s, B), dev),
             _in_place(z, 'z', (nb, r_max, B), dev),
             _in_place(y, 'y', (nb, r_max, B), dev)]
    if done.dtype != torch.int32 or tuple(done.shape) != (1, 1, B):
        raise ValueError(f'done: int32 (1, 1, {B}) expected, got '
                         f'{done.dtype} {tuple(done.shape)}')
    done = done.to(dev).contiguous()
    build_chunk_kernel()
    outs = [torch.empty((B,), dtype=torch.float32, device=dev)
            for _ in range(4)]
    flags = torch.empty((B,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB_CHUNK.banded_chunk_f32(
            *[t.data_ptr() for t in ins + state + [done] + outs + [flags]],
            _meta_ptr(meta, nb, s), B, nb, s, r_max, int(check_interval),
            float(c_inv), float(sigma), float(alpha), float(eps_abs),
            float(eps_rel), g, tile, gt, stream)
    if err != 0:
        raise RuntimeError(f'banded_chunk kernel launch failed: CUDA error '
                           f'{err}')
    banded_shared_chunk.launches += 1
    return (x, z, y) + tuple(outs) + (flags,)


banded_shared_chunk.launches = 0


def banded_iterate(fac_packed, meta, B0, B1, D_M, L_M, rho_g, q, l, u, x, z,
                   y, *, sigma, alpha, check_interval, kkt_refine,
                   group=None):
    """Run check_interval fused ADMM iterations on the rho-scaled state
    (K11; the contract of the reference's ``banded_iterate``).

    Layouts as in ``banded_shared_chunk``: q/x (nb, s, B); l/u/z/y
    (nb, r_max, B), where z, l and u are the rho-scaled row-space state and
    bounds (rho z, rho l, rho u) the caller passes; rho_g (nb, r_max)
    shared, by which the wrapper scales the A stores of the z-update.  D_M
    and L_M, the banded M, serve the ``kkt_refine`` refinement sweeps
    (None when it is 0).  x, z, y are updated IN PLACE, as the reference
    aliases them.  Per iteration:
        rhs = sigma x - q + A'(z - y);  x~ = M^-1 rhs (+ refinement)
        w = alpha rho A x~ + (1 - alpha) z + y;  z = clip(w, l, u);
        y = w - z;  x = alpha x~ + (1 - alpha) x.
    The reference's ``ll_pack`` argument (its separate pack of the
    untransposed L_left blocks, ops/banded_grouped.py::pack_lleft) is
    dropped: the grouped CR solve reads L_left from the packed factor
    itself.  So are its ``chunk`` and ``interpret``: ``group`` pins the
    instances per thread block (1, 2, 4 or 8; ``iterate_launch_plan``'s
    rule by default); no bit of the result depends on it.  Returns
    (x, z, y).  CPU tensors run ``banded_iterate_plain``; CUDA tensors
    launch the kernel (float32) or raise."""
    args = (fac_packed, meta, B0, B1, D_M, L_M, rho_g, q, l, u, x, z, y)
    kw = dict(sigma=sigma, alpha=alpha, check_interval=check_interval,
              kkt_refine=kkt_refine)
    if x.device.type == 'cpu':
        return banded_iterate_plain(*args, **kw)
    if x.device.type != 'cuda':
        raise TypeError(f'banded iterate kernel: no kernel for {x.device}')
    nb, s, B = x.shape
    r_max = l.shape[1]
    dev = x.device
    kkt_refine = int(kkt_refine)
    if kkt_refine < 0 or int(check_interval) < 0:
        raise ValueError('banded iterate kernel: negative kkt_refine or '
                         'check_interval')
    g, tile, _ = iterate_launch_plan(nb, s, B, kkt_refine, group,
                                     _sm_count(dev))
    rho3 = checked(rho_g, 'rho_g', (nb, r_max), dev)[:, :, None]
    B0 = checked(B0, 'B0', (nb, r_max, s), dev)
    B1 = checked(B1, 'B1', (nb, r_max, s), dev)
    refine = [None, None]
    if kkt_refine:
        refine = [checked(D_M, 'D_M', (nb, s, s), dev),
                  checked(L_M, 'L_M', (nb - 1, s, s), dev)]
    # the A stores of the z-update scaled by rho (the reference's wrapper
    # side), and the windows r-major (r_max, nb, s), so that a warp's
    # reads of them are contiguous; q, l and u in their own layout
    ins = [checked(fac_packed, 'fac_packed', (meta['total'], s, s), dev)] + [
        w.transpose(0, 1).contiguous()
        for w in (B0, B1, B0 * rho3, B1 * rho3)]
    vecs = [checked(q, 'q', (nb, s, B), dev),
            checked(l, 'l', (nb, r_max, B), dev),
            checked(u, 'u', (nb, r_max, B), dev)]
    state = [_in_place(x, 'x', (nb, s, B), dev),
             _in_place(z, 'z', (nb, r_max, B), dev),
             _in_place(y, 'y', (nb, r_max, B), dev)]
    build_iterate_kernel()
    # the kernel's working copy of z, y, l, u and q, each group's
    # instances adjacent (iterate_scratch_words)
    scratch = torch.empty((iterate_scratch_words(nb, s, r_max, B, g),),
                          dtype=torch.float32, device=dev)
    ptrs = ([t.data_ptr() for t in ins]
            + [None if t is None else t.data_ptr() for t in refine]
            + [t.data_ptr() for t in vecs + state + [scratch]])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB_ITERATE.banded_iterate_f32(
            *ptrs, _meta_ptr(meta, nb, s), B, nb, s, r_max,
            int(check_interval), kkt_refine, float(sigma), float(alpha), g,
            tile, stream)
    if err != 0:
        raise RuntimeError(f'banded_iterate kernel launch failed: CUDA error '
                           f'{err}')
    banded_iterate.launches += 1
    return x, z, y


banded_iterate.launches = 0
