"""The port's shared-KKT banded engine (cvxpygen_tpu_torch: ops/
banded_shared_kernel.py, the plain versions of kernels K4 and K5, and
solvers/admm_banded_shared.py) against the JAX package's Pallas kernels in
interpret mode and its solve loops, on a shared-P/A batch of the charging
family of tests/test_admm_banded.py, float64 on the CPU."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import cvxpygen_tpu as ct_ref
from test_torch_banded import assign_charging, charging_problem, _thetas
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.ops import banded_grouped as grouped_ref
from cvxpygen_tpu.ops import banded_shared_kernel as kernel_ref
from cvxpygen_tpu.ops.block_tridiag import cr_factor as cr_factor_ref
from cvxpygen_tpu.runtime import jax_family as jf_ref
from cvxpygen_tpu.solvers import admm_banded_shared as shared_ref
from cvxpygen_tpu.solvers.admm import ADMMSettings as SettingsRef
from cvxpygen_tpu.solvers.admm_banded import build_banded_structure
from cvxpygen_tpu_torch.ops import banded_shared_kernel as kernel
from cvxpygen_tpu_torch.ops.banded_grouped import (build_grouped_a,
                                                   pack_cr_levels)
from cvxpygen_tpu_torch.ops.block_tridiag import cr_factor
from cvxpygen_tpu_torch.solvers import admm_banded_shared as shared
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
from cvxpygen_tpu_torch.solvers.admm_banded import \
    build_banded_structure as build_port

B = 4
CHUNK_KW = dict(sigma=1e-6, alpha=1.6, eps_abs=1e-3, eps_rel=1e-3,
                check_interval=10, kkt_refine=0)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test (several worker processes share the
    cores)."""
    with threadpool_limits(limits=1):
        yield


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope='module')
def batch():
    """A shared-P/A batch (only the prices p vary) in canonical sparse
    form, numpy."""
    prob = assign_charging(charging_problem(ct_ref))
    fam = canon_ref(prob)
    st = build_banded_structure(fam.P_idx, fam.A_idx, fam.n, fam.m)
    ga = grouped_ref.build_grouped_a(st.a_row, st.a_col, fam.m, st.s, st.nb)
    jf = jf_ref.JaxFamily.from_family(fam, force_scatter=True)
    ds = jf_ref.canon_batch_sparse(jf, jnp.asarray(_thetas(fam, prob, B)))
    l, u = jf_ref.qp_bounds_batch(jf, ds['b'])
    np.testing.assert_array_equal(np.asarray(ds['avals'][0]),
                                  np.asarray(ds['avals'][-1]))
    arrs = dict(pvals=ds['pvals'][0], q=ds['q'], avals=ds['avals'][0], l=l,
                u=u)
    return dict(st=st, ga=ga, n_eq=jf.n_zero,
                st_port=build_port(fam.P_idx, fam.A_idx, fam.n, fam.m),
                ga_port=build_grouped_a(st.a_row, st.a_col, fam.m, st.s,
                                        st.nb),
                **{k: np.asarray(v) for k, v in arrs.items()})


def _chunk_args(batch):
    """K5's arguments at the start state, from the port's solver helper."""
    return shared.banded_kernel_args(
        batch['st_port'], batch['ga_port'], _t(batch['pvals']),
        _t(batch['q']), _t(batch['avals']), _t(batch['l']), _t(batch['u']),
        batch['n_eq'], ADMMSettings(scaling=10))


@pytest.mark.parametrize('nb', [19, 41])
def test_pack_cr_levels_matches_reference(nb):
    """The packed factor and its metadata, and the CR solve through them,
    at block counts whose levels pad (41 -> 21 -> 11 -> 6 -> 3 -> 2 -> 1):
    the offsets of the A, C and L_left blocks are where an off-by-one
    would show."""
    rng = np.random.default_rng(nb)
    s = 4
    D = rng.standard_normal((1, nb, s, s))
    D = D @ np.swapaxes(D, 2, 3) + 4 * s * np.eye(s)
    L = 0.3 * rng.standard_normal((1, nb - 1, s, s))
    packed, meta = pack_cr_levels(cr_factor(_t(D), _t(L)))
    packed_ref, meta_ref = grouped_ref.pack_cr_levels(
        jax.jit(cr_factor_ref)(jnp.asarray(D), jnp.asarray(L)))
    assert meta == meta_ref
    assert packed.shape[0] == kernel.estimate_nb_tot(nb) == meta['total']
    np.testing.assert_allclose(packed.numpy(), np.asarray(packed_ref),
                               rtol=0, atol=1e-10)
    assert kernel.cr_level_shapes(nb) == kernel_ref.cr_level_shapes(nb)
    b = rng.standard_normal((nb, s, 3))
    x = kernel.cr_solve_plain(packed, meta, _t(b))
    x_ref = kernel_ref.cr_solve_pallas(packed_ref, meta, jnp.asarray(b),
                                       interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0,
                               atol=1e-10)
    # and it solves the system
    Mx = np.einsum('gij,gjb->gib', D[0], x.numpy())
    Mx[1:] += np.einsum('gij,gjb->gib', L[0], x.numpy()[:-1])
    Mx[:-1] += np.einsum('gji,gjb->gib', L[0], x.numpy()[1:])
    np.testing.assert_allclose(Mx, b, rtol=0, atol=1e-10)


def test_cr_solve_plain_matches_interpret_kernel(batch):
    """K4's plain version against cr_solve_pallas in interpret mode, on the
    solve loop's factor and random right-hand sides; the CPU wrapper runs the
    plain version and launches nothing."""
    args = _chunk_args(batch)
    fac, meta = args[0], args[1]
    nb, s = batch['st'].nb, batch['st'].s
    b = np.random.default_rng(1).standard_normal((nb, s, 6))
    x_ref = kernel_ref.cr_solve_pallas(jnp.asarray(fac.numpy()), meta,
                                       jnp.asarray(b), interpret=True)
    x = kernel.cr_solve_plain(fac, meta, _t(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0,
                               atol=1e-10)
    before = kernel.cr_solve.launches
    assert torch.equal(kernel.cr_solve(fac, meta, _t(b)), x)
    assert kernel.cr_solve.launches == before
    assert kernel._LIB_CR is None


def _ref_chunk(args, done):
    ref_args = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
                for a in args]
    return kernel_ref.banded_shared_chunk(*ref_args, jnp.asarray(done),
                                          **CHUNK_KW, chunk=B,
                                          interpret=True)


def test_chunk_plain_matches_interpret_kernel(batch):
    """One K5 call, plain version against the Pallas kernel in interpret
    mode: from the zero start, then from a mid-solve state with two
    instances done (they keep their state and get zero deltas)."""
    args = _chunk_args(batch)
    zero_done = np.zeros((1, 1, B), np.int32)
    for done in (zero_done, np.array([[[0, 1, 0, 1]]], np.int32)):
        ref = _ref_chunk(args, done)
        state_in = [a.clone() for a in args[-3:]]
        out = kernel.banded_shared_chunk_plain(*args, _t(done), **CHUNK_KW)
        # x, z, y are updated in place, as the kernel does
        for o, a in zip(out[:3], args[-3:]):
            assert o.data_ptr() == a.data_ptr()
        for name, o, r in zip(('x', 'z', 'y', 'rp', 'rd', 'rp_den',
                               'rd_den'), out[:7], ref[:7]):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-10, err_msg=name)
        np.testing.assert_array_equal(out[7].numpy(), np.asarray(ref[7]))
        for i in np.nonzero(done[0, 0])[0]:
            for o, a in zip(out[:3], state_in):
                assert torch.equal(o[..., i], a[..., i])
        # the second call starts from the state the first one left


@pytest.mark.parametrize('engine', ['_impl', '_impl_crk'])
def test_shared_engines_match_reference(batch, engine):
    """Both engines against the JAX package's (kernels in interpret mode),
    cold and warm-started: equal status and iterations, x within 1e-8."""
    st, ga = batch['st'], batch['ga']
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=4000, check_interval=25,
              adaptive_rho=True)
    fn_ref = getattr(shared_ref, engine)

    def solve_ref(pvals, q, avals, l, u, x0, y0, n_eq, settings):
        with jax.default_matmul_precision('highest'):
            return fn_ref(st, ga, pvals, q, avals, l, u, n_eq, settings, x0,
                          y0, True)

    solve_ref = jax.jit(solve_ref, static_argnames=('n_eq', 'settings'))
    fn = getattr(shared, engine)
    ix = shared._resolve_index(batch['st_port'], None, 'cpu',
                               batch['ga_port'])
    arrs = [batch[k] for k in ('pvals', 'q', 'avals', 'l', 'u')]
    rng = np.random.default_rng(2)
    starts = [(None, None),
              (rng.standard_normal((B, st.n)), rng.standard_normal((B, st.m)))]
    for x0, y0 in starts:
        ref = solve_ref(*[jnp.asarray(a) for a in arrs], x0, y0,
                        n_eq=batch['n_eq'], settings=SettingsRef(**kw))
        with torch.no_grad():
            out = fn(batch['st_port'], batch['ga_port'],
                     *[_t(a) for a in arrs], batch['n_eq'],
                     ADMMSettings(**kw), x0, y0, ix)
        assert np.all(out['status'].numpy() == 1)
        assert np.array_equal(out['status'].numpy(),
                              np.asarray(ref['status']))
        assert np.array_equal(out['iters'].numpy(), np.asarray(ref['iters']))
        np.testing.assert_allclose(out['x'].numpy(), np.asarray(ref['x']),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(out['y'].numpy(), np.asarray(ref['y']),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out['obj'].numpy(),
                                   np.asarray(ref['obj']), rtol=0, atol=1e-8)


def test_engine_switch_follows_block_count(batch, monkeypatch):
    """admm_solve_banded_shared picks K5 for nb <= 96 and the K4 loop
    above, as the reference does; kkt_refine other than 0 is refused."""
    calls = []
    monkeypatch.setattr(shared, '_impl', lambda *a: calls.append('k5'))
    monkeypatch.setattr(shared, '_impl_crk', lambda *a: calls.append('k4'))
    st = batch['st_port']
    args = [_t(batch[k]) for k in ('pvals', 'q', 'avals', 'l', 'u')]
    shared.admm_solve_banded_shared(st, batch['ga_port'], *args,
                                    batch['n_eq'], ADMMSettings())
    big = functools.partial(shared.admm_solve_banded_shared,
                            type(st)(**dict(vars(st), nb=97)))
    big(batch['ga_port'], *args, batch['n_eq'], ADMMSettings(),
        index=shared._resolve_index(st, None, 'cpu', batch['ga_port']))
    assert calls == ['k5', 'k4']
    with pytest.raises(ValueError, match='kkt_refine'):
        kernel.banded_shared_chunk_plain(
            *_chunk_args(batch), torch.zeros((1, 1, B), dtype=torch.int32),
            **dict(CHUNK_KW, kkt_refine=1))


# ---------------------------------------------------------------------------
# kernel K4's launch plan and its in-place strided state (csrc/cr_solve.cu)
# ---------------------------------------------------------------------------

def _random_cr(nb, s, seed):
    """The packed CR factor of a random SPD block-tridiagonal M, float64."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((1, nb, s, s))
    D = D @ np.swapaxes(D, 2, 3) + 4 * s * np.eye(s)
    L = 0.3 * rng.standard_normal((1, nb - 1, s, s))
    return pack_cr_levels(cr_factor(_t(D), _t(L)))


@pytest.mark.parametrize('B', [1, 3, 256, 2048])
def test_cr_group_rule_covers_the_batch(B):
    """K4's plan at charging (nb=541, s=8) and at nb=97: ceil(B / group)
    thread blocks cover every instance once (the last group partial where
    group does not divide B), a step's pairs fit the threads, and shared
    memory fits the per-block limit; a pinned group that does not fit is
    refused."""
    for nb in (97, 541):
        g, tile, smem = kernel.cr_launch_plan(nb, 8, B)
        assert g in (1, 2, 4, 8) and g <= kernel.pick_cr_group(B)
        blocks = -(-B // g)
        covered = np.concatenate([np.arange(j * g, min(B, j * g + g))
                                  for j in range(blocks)])
        assert np.array_equal(covered, np.arange(B))
        assert 1 <= tile and tile * 8 <= 2 * 256
        assert smem == kernel.cr_group_smem_bytes(nb, 8, g, tile)
        assert smem + 4 * 10 * 32 <= 232448
    with pytest.raises(ValueError, match='does not fit'):
        kernel.cr_launch_plan(2000, 64, B, group=8)


def test_cr_meta_table_is_cached():
    """The ctypes level table of a packed structure is built once: it
    equals a fresh cr_meta_array for nb 97 and 541, a second call returns
    the same table, and the other structure has its own."""
    tables = {}
    for nb in (97, 541):
        _, meta = _random_cr(nb, 8, nb)
        arr = kernel._meta_ptr(meta, nb, 8)
        assert list(arr) == kernel.cr_meta_array(meta, nb, 8)
        assert kernel._meta_ptr(meta, nb, 8) is arr
        tables[nb] = arr
    assert list(tables[97]) != list(tables[541])


def _cr_solve_strided(fac, meta, b, tile):
    """csrc/cr_solve.cu's schedule on one state buffer: level k's block m
    at position m << k; the forward sweep writes b' over the even block and
    leaves the odd one in place, the root solve writes x_0 over block 0, the
    backward sweep writes x over the odd blocks (the padding block
    skipped).  Each step reads its factor blocks from a stage filled by the
    kernel's copy ranges (pair t at t - t0)."""
    nb, s, _ = b.shape
    arr = kernel.cr_meta_array(meta, nb, s)
    n_levels, root = arr[0], arr[1]
    lv = [arr[4 + 10 * k:14 + 10 * k] for k in range(n_levels)]
    st = b.clone()
    nan = float('nan')

    def stage(ranges, t0):
        """slots of `tile` blocks: (global first block, local first, count)
        per slot"""
        slots = torch.full((3, tile, s, s), nan, dtype=fac.dtype)
        for q, (g0, l0, cnt) in enumerate(ranges):
            if cnt > 0:
                slots[q, l0:l0 + cnt] = fac[g0:g0 + cnt]
        return slots

    for k in range(n_levels):
        nb_in, n2, oD, oA, nA, oC, oLl, nLl, oLe, _ = lv[k]
        for t0 in range(0, n2, tile):
            t1 = min(t0 + tile, n2)
            lo, hi = max(t0, 1), min(t1, nA + 1)
            sl = stage([(oA + lo - 1, lo - t0, hi - lo),
                        (oC + t0, 0, t1 - t0)], t0)
            for t in range(t0, t1):
                acc = st[(2 * t) << k].clone()
                if t >= 1 and t - 1 < nA:
                    acc -= sl[0, t - t0] @ st[(2 * t - 1) << k]
                if 2 * t + 1 < nb_in:
                    acc -= sl[1, t - t0] @ st[(2 * t + 1) << k]
                st[(2 * t) << k] = acc
    st[0] = stage([(root, 0, 1)], 0)[0, 0] @ st[0]
    for k in reversed(range(n_levels)):
        nb_in, n2, oD, oA, nA, oC, oLl, nLl, oLe, _ = lv[k]
        for t0 in range(0, n2, tile):
            t1 = min(t0 + tile, n2)
            sl = stage([(oLe + t0, 0, t1 - t0),
                        (oLl + t0, 0, min(t1, nLl) - t0),
                        (oD + t0, 0, t1 - t0)], t0)
            for t in range(t0, t1):
                if 2 * t + 1 >= nb_in:
                    continue
                r = st[(2 * t + 1) << k] - sl[0, t - t0] @ st[(2 * t) << k]
                if t < nLl:
                    r = r - sl[1, t - t0].T @ st[(2 * t + 2) << k]
                st[(2 * t + 1) << k] = sl[2, t - t0] @ r
    return st


@pytest.mark.parametrize('nb', [97, 541])
def test_cr_strided_state_matches_plain(nb):
    """The in-place strided schedule of K4 (steps of 5 block pairs, so a
    level spans several steps) gives cr_solve_plain's x, float64."""
    packed, meta = _random_cr(nb, 8, nb)
    b = _t(np.random.default_rng(1).standard_normal((nb, 8, 3)))
    x = _cr_solve_strided(packed, meta, b, tile=5)
    np.testing.assert_allclose(x.numpy(),
                               kernel.cr_solve_plain(packed, meta, b).numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 5, 64])
def test_cr_solve_kernel_matches_plain_on_card(B):
    """On a card, K4 at its own group and at every pinned group against
    its plain version (1e-4 of max(1, |x|_inf) per instance), the groups
    and a second call bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the card: chip_smoke.py phase 7)')
    packed, meta = _random_cr(97, 8, 3)
    fac = packed.float().cuda()
    b = torch.tensor(np.random.default_rng(B).standard_normal((97, 8, B)),
                     dtype=torch.float32, device='cuda')
    x = kernel.cr_solve(fac, meta, b)
    ref = kernel.cr_solve_plain(fac, meta, b)
    scale = torch.clamp(ref.abs().amax(dim=(0, 1)), min=1.0)
    assert float(((x - ref).abs().amax(dim=(0, 1)) / scale).max()) <= 1e-4
    for g in (1, 2, 4, 8):
        assert torch.equal(kernel.cr_solve(fac, meta, b, group=g), x)


# ---------------------------------------------------------------------------
# kernel K5's launch plan (csrc/banded_chunk.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('B,plan', [(1, (1, 24, 24)), (256, (2, 24, 24)),
                                    (257, (2, 24, 24)),
                                    (2048, (8, 14, 14))])
def test_chunk_plan_rule(B, plan):
    """K5's plan at MPC H=30 (nb=41, s=16, r_max=24): the rule's group
    (eight instances per thread block at B=2048) with steps as large as
    shared memory holds (14 CR block pairs and A blocks at eight, the cap
    of 24 below), every pinned group fits, ceil(B / group) thread blocks
    cover every instance once, and the kernel's static shared memory fits
    beside the dynamic part."""
    g, tile, gt, smem = kernel.chunk_launch_plan(41, 16, 24, B)
    assert (g, tile, gt) == plan and g == kernel.pick_cr_group(B)
    for pin in (1, 2, 4, 8):
        gp, tp, gtp, sp = kernel.chunk_launch_plan(41, 16, 24, B, pin)
        assert gp == pin and 1 <= tp <= 24 and 1 <= gtp <= 24
        assert sp == kernel.chunk_smem_bytes(41, 16, 24, pin, tp, gtp)
        assert sp + 4 * 10 * 32 + 4 * 8 * 16 * pin + 8 * 2 <= 232448
        covered = np.concatenate([np.arange(j * pin, min(B, j * pin + pin))
                                  for j in range(-(-B // pin))])
        assert np.array_equal(covered, np.arange(B))


def test_chunk_plan_drops_the_group_where_it_must():
    """At nb=96 (the largest nb the engine gives K5) eight instances do not
    fit: the rule drops to four with shorter steps, a pinned eight is
    refused, and a shape where one instance does not fit raises."""
    assert kernel.chunk_launch_plan(96, 16, 24, 2048)[:3] == (4, 9, 9)
    with pytest.raises(ValueError, match='does not fit'):
        kernel.chunk_launch_plan(96, 16, 24, 2048, group=8)
    with pytest.raises(ValueError, match='does not fit'):
        kernel.chunk_launch_plan(96, 64, 96, 2048)
    with pytest.raises(ValueError, match='multiple of 4'):
        kernel.chunk_launch_plan(41, 6, 24, 2048)
    with pytest.raises(ValueError, match='group=3'):
        kernel.chunk_launch_plan(41, 16, 24, 2048, group=3)


@pytest.mark.cuda
def test_chunk_kernel_matches_plain_on_card(batch):
    """On a card, K5 against its plain version from the zero start and with
    every other instance done (1e-4 of max(1, |v|_inf) per instance for x,
    z, y), a second call and every pinned group bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the card: chip_smoke.py phase 8)')
    args = [a.float().cuda() if isinstance(a, torch.Tensor) else a
            for a in _chunk_args(batch)]

    def run(fn, done, **kw):
        a = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        return fn(*a, done, **CHUNK_KW, **kw)

    for done in ([0, 0, 0, 0], [0, 1, 0, 1]):
        done = torch.tensor(done, dtype=torch.int32,
                            device='cuda').reshape(1, 1, B)
        out = run(kernel.banded_shared_chunk, done)
        ref = run(kernel.banded_shared_chunk_plain, done)
        for o, r in zip(out[:3], ref[:3]):
            scale = torch.clamp(r.abs().amax(dim=(0, 1)), min=1.0)
            assert float(((o - r).abs().amax(dim=(0, 1)) / scale).max()) \
                <= 1e-4
        for g in (None, 1, 2, 4, 8):
            again = run(kernel.banded_shared_chunk, done, group=g)
            assert all(torch.equal(a, o) for a, o in zip(again, out))
