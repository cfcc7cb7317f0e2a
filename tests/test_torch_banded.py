"""The port's block-banded path (cvxpygen_tpu_torch: solvers/admm_banded.py,
ops/banded_grouped.py, runtime CompiledBandedQPSolver, the n >= 512 routing
and generate_code(solver='BANDED')) against the JAX package on the charging
family of tests/test_admm_banded.py, float64 on the CPU."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
from test_torch_solver import _problems_torch
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.ops.banded_grouped import build_grouped_a as grouped_ref
from cvxpygen_tpu.runtime import jax_family as jf_ref
from cvxpygen_tpu.runtime.solver import \
    CompiledBandedQPSolver as BandedSolverRef
from cvxpygen_tpu.solvers import admm_banded as banded_ref
from cvxpygen_tpu.solvers.admm import ADMMSettings as SettingsRef
from cvxpygen_tpu_torch import cpg
from cvxpygen_tpu_torch.canon.canonicalizer import (canonicalize,
                                                    family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.ops.banded_grouped import build_grouped_a
from cvxpygen_tpu_torch.runtime.solver import (CompiledBandedQPSolver,
                                               make_compiled_solver)
from cvxpygen_tpu_torch.runtime.torch_family import (TorchFamily,
                                                     canon_batch_sparse)
from cvxpygen_tpu_torch.solvers import admm_banded
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
from cvxpygen_tpu_torch.solvers.admm_banded import (admm_solve_banded,
                                                    build_banded_structure)

T = 48


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test (several worker processes share the
    cores)."""
    with threadpool_limits(limits=1):
        yield


def charging_problem(ct, T=T):
    """tests/test_admm_banded.py:23-33 in either package's modeling
    layer."""
    u = ct.Variable(T, name='u')
    q = ct.Variable(T + 1, name='q')
    p = ct.Parameter(T, nonneg=True, name='p')
    gamma = ct.Parameter(nonneg=True, name='gamma')
    objective = ct.Minimize(p @ u + gamma * ct.sum_squares(u))
    constraints = [q[1:] == q[:-1] + u,
                   ct.Constant(-0.1) <= u, u <= ct.Constant(0.05),
                   ct.Constant(0) <= q, q <= ct.Constant(1.0),
                   q[0] == 0, q[T] == ct.Constant(1.0)]
    return ct.Problem(objective, constraints)


def assign_charging(prob, T=T, seed=0, gamma=50.0):
    rng = np.random.default_rng(seed)
    prob.param_dict['p'].value = 1.0 + 4.0 * rng.random(T)
    prob.param_dict['gamma'].value = gamma
    return prob


def _thetas(fam, prob, B, gammas=None):
    out = []
    for i in range(B):
        assign_charging(prob, seed=i,
                        gamma=50.0 if gammas is None else gammas[i])
        out.append(fam.pack_theta(params=prob.parameters()))
    return np.stack(out)


@pytest.fixture(scope='module')
def charging():
    prob = assign_charging(charging_problem(ct_ref))
    fam_ref = canon_ref(prob)
    fam = family_from_arrays(family_to_arrays(fam_ref))
    return dict(prob=prob, fam_ref=fam_ref, fam=fam,
                st=build_banded_structure(fam.P_idx, fam.A_idx, fam.n,
                                          fam.m),
                st_ref=banded_ref.build_banded_structure(
                    fam_ref.P_idx, fam_ref.A_idx, fam_ref.n, fam_ref.m))


def test_structure_and_grouped_layout_equal_reference(charging):
    st, st_ref = charging['st'], charging['st_ref']
    assert st is not None and st.nb >= 4
    for f in ('n', 'm', 's', 'nb', 'n_slots'):
        assert getattr(st, f) == getattr(st_ref, f)
    for f in ('order', 'pos', 'a_row', 'a_col', 'p_row', 'p_col', 'pr_k1',
              'pr_k2', 'pr_row', 'pr_slot', 'p_slot', 'diag_slot'):
        np.testing.assert_array_equal(getattr(st, f), getattr(st_ref, f))
    ga = build_grouped_a(st.a_row, st.a_col, st.m, st.s, st.nb)
    ga_ref = grouped_ref(st.a_row, st.a_col, st.m, st.s, st.nb)
    assert (ga.nb, ga.s, ga.r_max, ga.m) == (ga_ref.nb, ga_ref.s,
                                             ga_ref.r_max, ga_ref.m)
    for f in ('b0_pos', 'b1_pos', 'row_group', 'row_local', 'row_slot'):
        np.testing.assert_array_equal(getattr(ga, f), getattr(ga_ref, f))


def test_canon_batch_sparse_matches_reference(charging):
    fam, fam_ref = charging['fam'], charging['fam_ref']
    theta = _thetas(fam_ref, charging['prob'], 4, gammas=[10, 20, 30, 40])
    out = canon_batch_sparse(
        TorchFamily.from_family(fam, device='cpu', force_scatter=True), theta)
    ref = jf_ref.canon_batch_sparse(
        jf_ref.JaxFamily.from_family(fam_ref, force_scatter=True),
        jnp.asarray(theta))
    for k in ('pvals', 'q', 'd', 'avals', 'b'):
        assert out[k].dtype == torch.float64
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-12, err_msg=k)
    with pytest.raises(ValueError, match='scatter'):
        canon_batch_sparse(TorchFamily.from_family(fam, device='cpu'), theta)


def _assert_same(out, ref, atol=1e-8):
    assert np.array_equal(out['status'].numpy(), np.asarray(ref['status']))
    assert np.array_equal(out['iters'].numpy(), np.asarray(ref['iters']))
    np.testing.assert_allclose(out['x'].numpy(), np.asarray(ref['x']),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(out['y'].numpy(), np.asarray(ref['y']),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out['obj'].numpy(), np.asarray(ref['obj']),
                               rtol=0, atol=atol)


@pytest.mark.parametrize('adaptive', [False, True])
def test_admm_solve_banded_matches_reference(charging, adaptive):
    """The per-instance banded engine, with adaptive rho off and on, on
    instances whose P differs (gamma per instance), from a cold and (with
    adaptive rho) a warm start."""
    fam_ref, st = charging['fam_ref'], charging['st']
    theta = _thetas(fam_ref, charging['prob'], 4, gammas=[20, 35, 50, 80])
    jf = jf_ref.JaxFamily.from_family(fam_ref, force_scatter=True)
    ds = jf_ref.canon_batch_sparse(jf, jnp.asarray(theta))
    l, u = jf_ref.qp_bounds_batch(jf, ds['b'])
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000,
              adaptive_rho=adaptive)
    solve_ref = jax.jit(functools.partial(banded_ref.admm_solve_banded,
                                          charging['st_ref']),
                        static_argnames=('n_eq', 'settings'))
    args = [torch.tensor(np.asarray(a)) for a in
            (ds['pvals'], ds['q'], ds['avals'], l, u)]
    starts = [(None, None)]
    if adaptive:
        rng = np.random.default_rng(1)
        starts.append((rng.standard_normal((4, fam_ref.n)),
                       rng.standard_normal((4, fam_ref.m))))
    for x0, y0 in starts:
        # the reference's cold start as explicit zeros (the same start,
        # bitwise), so that one compile serves both starts
        ref = solve_ref(ds['pvals'], ds['q'], ds['avals'], l, u,
                        n_eq=jf.n_zero, settings=SettingsRef(**kw),
                        x0=np.zeros((4, fam_ref.n)) if x0 is None else x0,
                        y0=np.zeros((4, fam_ref.m)) if y0 is None else y0)
        out = admm_solve_banded(st, *args, jf.n_zero, ADMMSettings(**kw),
                                x0=x0, y0=y0)
        assert np.all(out['status'].numpy() == 1)
        _assert_same(out, ref)


def test_compiled_banded_solver_non_shared_batch_matches_reference(
        charging):
    """A batch whose rows differ in gamma (so in P) takes the per-instance
    engine in both packages."""
    fam_ref = charging['fam_ref']
    theta = _thetas(fam_ref, charging['prob'], 4, gammas=[25, 50, 75, 100])
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000, adaptive_rho=True)
    solver = CompiledBandedQPSolver(charging['fam'], device='cpu',
                                    settings=ADMMSettings(**kw))
    assert not solver._use_shared(theta, 'auto')
    out = solver.solve_batch(theta)
    ref = BandedSolverRef(fam_ref, settings=SettingsRef(**kw)).solve_batch(
        theta)
    _assert_same(out, ref)
    np.testing.assert_allclose(out['y_canon'].numpy(),
                               np.asarray(ref['y_canon']), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out['d'].numpy(), np.asarray(ref['d']),
                               rtol=0, atol=1e-12)


def test_long_horizon_families_route_to_banded():
    """make_compiled_solver sends QP families with n >= 512 and a banded
    KKT pattern to the banded solver, as the reference does."""
    pt = _problems_torch()
    mpc = canonicalize(pt.assign_MPC(pt.MPC_problem(H=30)))
    T2 = 400
    charging2 = canonicalize(assign_charging(charging_problem(ct, T2), T2))
    for fam in (mpc, charging2):
        assert fam.n >= 512
        for name in ('ADMM', 'OSQP', 'BANDED', 'ADMM_BANDED'):
            solver = make_compiled_solver(fam, name, device='cpu')
            assert solver.solver_name == 'ADMM_BANDED'
    # a small family asks for the banded solver by name
    small = canonicalize(pt.assign_MPC(pt.MPC_problem(H=3)))
    assert make_compiled_solver(small, 'ADMM', device='cpu').solver_name \
        == 'ADMM'


def test_long_family_falls_back_to_dense_only_when_not_banded(monkeypatch):
    """A family with n >= 512 whose KKT pattern is not banded (one row
    couples every variable) takes the dense solver; any other error of the
    banded solver's construction propagates instead of turning into a
    dense solve."""
    x = ct.Variable(520, name='x')
    c = ct.Parameter(520, name='c')
    dense = canonicalize(ct.Problem(ct.Minimize(ct.sum_squares(x) + c @ x),
                                    [ct.sum(x) == 1, x >= -1]))
    assert dense.n >= 512
    assert build_banded_structure(dense.P_idx, dense.A_idx, dense.n,
                                  dense.m) is None
    assert make_compiled_solver(dense, 'ADMM', device='cpu').solver_name \
        == 'ADMM'
    pt = _problems_torch()
    mpc = canonicalize(pt.assign_MPC(pt.MPC_problem(H=30)))

    def broken(*args, **kw):
        raise ValueError('index construction failed')

    monkeypatch.setattr(admm_banded, 'banded_index', broken)
    with pytest.raises(ValueError, match='index construction failed'):
        make_compiled_solver(mpc, 'ADMM', device='cpu')


def test_generate_code_banded_cpg_solve(tmp_path):
    """generate_code(solver='BANDED') -> solve(method='CPG') on the CPU
    within 1e-3 of the float64 oracle, then a warm-started re-solve after a
    parameter update."""
    prob = assign_charging(charging_problem(ct))
    oracle = prob.solve()
    cpg.generate_code(prob, code_dir=str(tmp_path / 'banded'),
                      solver='BANDED', device='cpu')
    val = prob.solve(method='CPG', eps_abs=1e-5, eps_rel=1e-5,
                     adaptive_rho=True)
    assert prob.status == 'optimal'
    assert prob.solver_stats.solver_name == 'BANDED'
    assert abs(val - oracle) <= 1e-3 * max(1.0, abs(oracle))
    iters_cold = prob.solver_stats.num_iters
    prob.param_dict['p'].value = prob.param_dict['p'].value * 1.01
    oracle = prob.solve()
    val = prob.solve(method='CPG', updated_params=['p'], eps_abs=1e-5,
                     eps_rel=1e-5, adaptive_rho=True)
    assert prob.status == 'optimal'
    assert abs(val - oracle) <= 1e-3 * max(1.0, abs(oracle))
    assert prob.solver_stats.num_iters <= iters_cold
