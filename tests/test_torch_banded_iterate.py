"""Kernel K11's plain version (cvxpygen_tpu_torch/ops/banded_shared_kernel.py
::banded_iterate_plain) against the JAX package's banded_iterate in
interpret mode, on the shared-P/A charging batch of
tests/test_admm_banded_shared.py (T=48), float64 on the CPU; its
rho-scaled iteration against the solve loop's K4 route on the unscaled
state; the kernel's launch plan and its grouped schedule against the plain
version."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from test_admm_banded_shared import _charging_family, _theta_batch
from test_torch_banded_shared import _cr_solve_strided
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.ops import banded_grouped as grouped_ref
from cvxpygen_tpu.ops import banded_shared_kernel as kernel_ref
from cvxpygen_tpu.ops.block_tridiag import cr_factor as cr_factor_ref
from cvxpygen_tpu.runtime import jax_family as jf_ref
from cvxpygen_tpu.solvers.admm_banded import build_banded_structure
from cvxpygen_tpu_torch.ops import banded_shared_kernel as kernel
from cvxpygen_tpu_torch.ops.banded_grouped import build_grouped_a
from cvxpygen_tpu_torch.solvers import admm_banded_shared as shared
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
from cvxpygen_tpu_torch.solvers.admm_banded import \
    build_banded_structure as build_port

B = 4
TOL = 1e-9
ITER_KW = dict(sigma=1e-6, alpha=1.6, check_interval=5)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope='module')
def setup():
    """The port's set-up of the shared banded engine on the charging batch
    (Ruiz, CR factor at the base rho, grouped layouts), a seeded state in
    the rho-scaled variables, and the JAX package's own packed factor and
    L_left pack of the same M."""
    prob = _charging_family()
    fam = canon_ref(prob)
    st = build_banded_structure(fam.P_idx, fam.A_idx, fam.n, fam.m)
    jf = jf_ref.JaxFamily.from_family(fam, force_scatter=True)
    ds = jf_ref.canon_batch_sparse(jf, jnp.asarray(_theta_batch(fam, prob,
                                                                B)))
    l, u = jf_ref.qp_bounds_batch(jf, ds['b'])
    args = shared.banded_kernel_args(
        build_port(fam.P_idx, fam.A_idx, fam.n, fam.m),
        build_grouped_a(st.a_row, st.a_col, fam.m, st.s, st.nb),
        _t(ds['pvals'][0]), _t(ds['q']), _t(ds['avals'][0]), _t(l), _t(u),
        jf.n_zero, ADMMSettings(scaling=10))
    fac, meta, D_M, L_M, rho = args[0], args[1], args[6], args[7], args[11]
    fac_ref = jax.jit(cr_factor_ref)(jnp.asarray(D_M.numpy())[None],
                                     jnp.asarray(L_M.numpy())[None])
    packed_ref, meta_ref = grouped_ref.pack_cr_levels(fac_ref)
    assert meta_ref == meta
    rng = np.random.default_rng(3)
    x, z, y = (rng.standard_normal(tuple(a.shape)) for a in args[16:19])
    rho3 = rho[:, :, None]
    return dict(args=args, packed_ref=packed_ref,
                llp_ref=grouped_ref.pack_lleft(fac_ref),
                # the rho-scaled bounds and state
                q=args[13], l=args[14] * rho3, u=args[15] * rho3, x=x,
                z=_t(z) * rho3, y=y)


def _plain(s, kkt_refine, solve=kernel.cr_solve_plain):
    a = s['args']
    x, z, y = _t(s['x']), s['z'].clone(), _t(s['y'])
    out = kernel.banded_iterate_plain(
        a[0], a[1], a[2], a[3], a[6], a[7], a[11], s['q'], s['l'], s['u'],
        x, z, y, kkt_refine=kkt_refine, solve=solve, **ITER_KW)
    assert all(o is v for o, v in zip(out, (x, z, y)))
    return x, z, y


@pytest.mark.parametrize('kkt_refine', [0, 1])
def test_plain_version_matches_interpret_kernel(setup, kkt_refine):
    """Five iterations from a seeded state: x, z and y within 1e-9 of
    max(1, |v|) of the reference kernel's in interpret mode (its own packed
    factor and L_left pack of the same M)."""
    s = setup
    a = s['args']
    meta = a[1]

    def ref(packed, llp, B0, B1, D_M, L_M, rho, q, l, u, x, z, y):
        return kernel_ref.banded_iterate(
            packed, llp, meta, B0, B1, D_M, L_M, rho, q, l, u, x, z, y,
            kkt_refine=kkt_refine, interpret=True, **ITER_KW)

    def np_(v):
        return jnp.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)

    out_ref = jax.jit(ref)(
        s['packed_ref'], s['llp_ref'],
        *(np_(v) for v in (a[2], a[3], a[6], a[7], a[11], s['q'], s['l'],
                           s['u'], s['x'], s['z'], s['y'])))
    for got, want in zip(_plain(s, kkt_refine), out_ref):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TOL * max(1.0, float(np.abs(want).max())))


def test_rho_scaled_iteration_is_the_k4_route(setup, monkeypatch):
    """The same iterations as the solve loop's K4 route (K5's plain version
    on the unscaled state, the CR solve through the K4 wrapper): x and y
    equal, z equal to the route's z times rho.  The K11 wrapper runs the
    plain version on CPU tensors and launches nothing."""
    s = setup
    a = s['args']
    rho3 = a[11][:, :, None]
    monkeypatch.setattr(kernel.banded_iterate, 'launches', 0)
    x, z, y = _t(s['x']), s['z'].clone(), _t(s['y'])
    kernel.banded_iterate(a[0], a[1], a[2], a[3], None, None, a[11],
                          s['q'], s['l'], s['u'], x, z, y, kkt_refine=0,
                          **ITER_KW)
    assert kernel.banded_iterate.launches == 0
    assert kernel._LIB_ITERATE is None
    xr, zr, yr = _t(s['x']), s['z'] / rho3, _t(s['y'])
    done = torch.zeros((1, 1, B), dtype=torch.int32)
    kernel.banded_shared_chunk_plain(
        *a[:16], xr, zr, yr, done, eps_abs=1e-3, eps_rel=1e-3, kkt_refine=0,
        solve=kernel.cr_solve, **ITER_KW)
    for got, want in ((x, xr), (z, zr * rho3), (y, yr)):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=0,
            atol=1e-10 * max(1.0, float(want.abs().max())))


# ---------------------------------------------------------------------------
# kernel K11's launch plan and schedule (csrc/banded_iterate.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('B', [1, 5, 256, 2048])
@pytest.mark.parametrize('kkt_refine', [0, 1])
def test_iterate_plan_covers_the_batch(B, kkt_refine):
    """K11's plan at charging T=1440 (nb=541, s=8): ceil(B / group) thread
    blocks cover every instance once (the last group partial where group
    does not divide B), a CR step's pairs fit the threads, and the shared
    memory of the layout fits the per-block limit beside the level table
    and the ring's barriers."""
    g, tile, smem = kernel.iterate_launch_plan(541, 8, B, kkt_refine)
    assert g in (1, 2, 4, 8) and g <= kernel.pick_cr_group(B)
    blocks = -(-B // g)
    covered = np.concatenate([np.arange(j * g, min(B, j * g + g))
                              for j in range(blocks)])
    assert np.array_equal(covered, np.arange(B))
    assert 1 <= tile and tile * 8 <= 2 * 256
    assert smem == kernel.iterate_smem_bytes(541, 8, g, tile, kkt_refine)
    assert smem + 4 * 10 * 32 + 8 * 3 <= 232448
    # the layout: the CR state (blocks of s rows of g-wide vectors, four
    # words apart), x (and with refinement the refined solution and the
    # right-hand side), three ring stages of three slots of tile blocks
    words = (541 * (8 * g + 4) + (3 if kkt_refine else 1) * 541 * 8 * g
             + 3 * 3 * tile * 64)
    assert smem == 4 * words


@pytest.mark.parametrize('kkt_refine,plan', [(0, (2, 64)), (1, (2, 36))])
def test_iterate_plan_rule_at_charging(kkt_refine, plan):
    """At charging's B=256 the rule's two instances per thread block (one
    wave of 128 blocks on 132 SMs): CR steps of 64 block pairs (the
    threads' limit) without refinement, of 36 with one sweep, whose
    refined solution and right-hand side take the room; a pinned group
    that does not fit is refused, and so is a group the kernel does not
    take or a block size that is not a multiple of 4."""
    assert kernel.iterate_launch_plan(541, 8, 256, kkt_refine)[:2] == plan
    assert kernel.iterate_launch_plan(541, 8, 256, kkt_refine,
                                      group=1)[0] == 1
    with pytest.raises(ValueError, match='does not fit'):
        kernel.iterate_launch_plan(541, 8, 2048, kkt_refine, group=8)
    with pytest.raises(ValueError, match='does not fit'):
        kernel.iterate_launch_plan(4000, 32, 256, kkt_refine)
    with pytest.raises(ValueError, match='group'):
        kernel.iterate_launch_plan(541, 8, 256, kkt_refine, group=3)
    with pytest.raises(ValueError, match='multiple of 4'):
        kernel.iterate_launch_plan(541, 6, 256, kkt_refine)


def _iterate_grouped(a, q, l, u, x, z, y, group, tile, kkt_refine):
    """csrc/banded_iterate.cu's schedule, float64, updating x, z, y in
    place: per group of ``group`` instances (the last one partial), z, y,
    l, u (their rows r-major) and q copied into the group's stretch of the
    scratch (rows of ``group`` adjacent instances, zeros past the batch),
    then per iteration the A' pass by the kernel's tasks (block g, rows
    from i0, one half: B0 of block g against z_g - y_g or B1 of block
    g - 1 against z_{g-1} - y_{g-1}, r in order; rhs = (sigma x - q) +
    (lo + hi)), the CR
    solve's in-place strided steps of ``tile`` block pairs, with
    refinement the fold of each solve into the refined solution and the
    residual rhs - M x~ before each sweep, then the A pass row by row (the
    rho-scaled windows on blocks g and g + 1) with the z and y updates,
    then x; z and y copied back at the end."""
    fac, meta, B0, B1, D_M, L_M, rho = (a[0], a[1], a[2], a[3], a[6], a[7],
                                        a[11])
    sigma, alpha = ITER_KW['sigma'], ITER_KW['alpha']
    B0r, B1r = B0 * rho[:, :, None], B1 * rho[:, :, None]
    nb, s, B = x.shape
    R = B0.shape[1]
    nr, nx = nb * R, nb * s
    scr = torch.full((kernel.iterate_scratch_words(nb, s, R, B, group),),
                     float('nan'), dtype=x.dtype)
    for j0 in range(0, B, group):
        nv = min(group, B - j0)
        sl = slice(j0, j0 + nv)
        base = j0 // group * (4 * nr + nx) * group
        views = []
        for k, t in enumerate((z, y, l, u, q)):
            rows = nx if k == 4 else nr
            v = scr[base + k * nr * group:
                    base + (k * nr + rows) * group].view(rows, group)
            v.zero_()
            if k == 4:
                v[:, :nv] = t[:, :, sl].reshape(rows, nv)
                views.append(v.view(nb, s, group))
            else:       # r-major: row r of block g at r nb + g
                v[:, :nv] = t[:, :, sl].transpose(0, 1).reshape(rows, nv)
                views.append(v.view(R, nb, group).transpose(0, 1))
        zs, ys, ls, us, qs = views
        X = torch.zeros((nb, s, group), dtype=x.dtype)
        X[:, :, :nv] = x[:, :, sl]
        for _ in range(ITER_KW['check_interval']):
            v = zs - ys
            rhs = torch.empty_like(X)
            for g in range(nb):
                for i0 in range(0, s, 4):
                    lo = torch.zeros_like(X[0, :4])
                    hi = torch.zeros_like(lo)
                    for r in range(R):
                        lo = lo + B0[g, r, i0:i0 + 4, None] * v[g, r]
                        if g > 0:
                            hi = hi + B1[g - 1, r, i0:i0 + 4, None] * v[g - 1,
                                                                       r]
                    rhs[g, i0:i0 + 4] = ((sigma * X[g, i0:i0 + 4]
                                          - qs[g, i0:i0 + 4]) + (lo + hi))
            xt = _cr_solve_strided(fac, meta, rhs, tile)
            for _ in range(kkt_refine):
                res = rhs - kernel.bt_mv(D_M, L_M, xt)
                xt = xt + _cr_solve_strided(fac, meta, res, tile)
            for g in range(nb):
                for r in range(R):
                    acc = B0r[g, r] @ xt[g]
                    if g + 1 < nb:
                        acc = acc + B1r[g, r] @ xt[g + 1]
                    w = alpha * acc + (1 - alpha) * zs[g, r] + ys[g, r]
                    z1 = torch.minimum(torch.maximum(w, ls[g, r]), us[g, r])
                    ys[g, r] = w - z1
                    zs[g, r] = z1
            X = alpha * xt + (1 - alpha) * X
        x[:, :, sl] = X[:, :, :nv]
        z[:, :, sl] = zs[:, :, :nv]
        y[:, :, sl] = ys[:, :, :nv]
    assert not bool(torch.isnan(scr).any())


@pytest.mark.parametrize('group', [1, 2])
@pytest.mark.parametrize('kkt_refine', [0, 1])
def test_grouped_schedule_matches_plain(setup, group, kkt_refine):
    """K11's grouped schedule (the scratch's group stretches covering it
    once, the A' tasks and halves, the CR steps of 3 block pairs, so a
    level spans several steps, the refinement's fold and residual, the A
    pass) on three instances, so that the second group of two is partial,
    gives banded_iterate_plain's x, z and y, float64."""
    s = setup
    a = s['args']
    sl = slice(0, 3)
    q, l, u = (t[:, :, sl].contiguous() for t in (s['q'], s['l'], s['u']))
    x0 = _t(s['x'])[:, :, sl].contiguous()
    z0 = s['z'][:, :, sl].contiguous()
    y0 = _t(s['y'])[:, :, sl].contiguous()
    want = [t.clone() for t in (x0, z0, y0)]
    kernel.banded_iterate_plain(a[0], a[1], a[2], a[3], a[6], a[7], a[11], q,
                                l, u, *want, kkt_refine=kkt_refine,
                                **ITER_KW)
    got = [t.clone() for t in (x0, z0, y0)]
    _iterate_grouped(a, q, l, u, *got, group=group, tile=3,
                     kkt_refine=kkt_refine)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(
            g_.numpy(), w_.numpy(), rtol=0,
            atol=1e-12 * max(1.0, float(w_.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize('kkt_refine', [0, 1])
def test_iterate_kernel_matches_plain_on_card(setup, kkt_refine):
    """On a card, K11 on five instances at two per thread block (the last
    group partial) against its plain version (1e-4 of max(1, |v|_inf) per
    instance), bitwise equal at one and four per block and on a second
    call."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the card: chip_smoke.py phase 13)')
    s = setup
    a = [t.float().cuda() if isinstance(t, torch.Tensor) else t
         for t in s['args']]
    idx = np.arange(5) % B
    q, l, u = (t[:, :, idx].float().cuda().contiguous()
               for t in (s['q'], s['l'], s['u']))
    start = [_t(s['x'])[:, :, idx], s['z'][:, :, idx], _t(s['y'])[:, :, idx]]
    start = [t.float().cuda().contiguous() for t in start]

    def run(group):
        out = [t.clone() for t in start]
        kernel.banded_iterate(a[0], a[1], a[2], a[3], a[6], a[7], a[11], q,
                              l, u, *out, kkt_refine=kkt_refine, group=group,
                              **ITER_KW)
        return out

    got = run(2)
    want = [t.clone() for t in start]
    kernel.banded_iterate_plain(a[0], a[1], a[2], a[3], a[6], a[7], a[11], q,
                                l, u, *want, kkt_refine=kkt_refine,
                                **ITER_KW)
    for g_, w_ in zip(got, want):
        scale = torch.clamp(w_.abs().amax(dim=(0, 1)), min=1.0)
        assert float(((g_ - w_).abs().amax(dim=(0, 1)) / scale).max()) <= 1e-4
    for group in (1, 4, 2):
        assert all(torch.equal(p_, g_) for p_, g_ in zip(run(group), got))
