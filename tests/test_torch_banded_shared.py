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
