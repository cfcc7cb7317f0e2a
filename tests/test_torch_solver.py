"""The port's slice end to end on the CPU: generate_code + solve(method='CPG')
and CompiledQPSolver.solve_batch (cvxpygen_tpu_torch) against the JAX
package's same flows, float64."""
import types

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import problems as problems_ref
import cvxpygen_tpu_torch
from cvxpygen_tpu import cpg as cpg_ref
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.runtime.solver import CompiledQPSolver as SolverRef
from cvxpygen_tpu.solvers.admm import ADMMSettings as SettingsRef
from cvxpygen_tpu_torch import cpg
from cvxpygen_tpu_torch.canon.canonicalizer import (canonicalize,
                                                    family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.runtime.solver import (CompiledQPSolver,
                                               make_compiled_solver)
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test: the suite runs in several worker
    processes on shared cores, where multi-threaded BLAS and torch calls on
    these small problems spin against each other."""
    with threadpool_limits(limits=1):
        yield


def _problems_torch():
    mod = types.ModuleType('problems_torch')
    src = open(problems_ref.__file__).read()
    exec(compile(src, problems_ref.__file__, 'exec'), mod.__dict__)
    mod.ct = cvxpygen_tpu_torch
    return mod


def _mpc_pair(H=3):
    pt = _problems_torch()
    return (problems_ref.assign_MPC(problems_ref.MPC_problem(H=H), seed=0),
            pt.assign_MPC(pt.MPC_problem(H=H), seed=0))


def _x_init_batch(fam, prob, B, seed=0):
    base = fam.pack_theta(params=prob.parameters())
    xi = [pi for pi in fam.param_info if pi.name == 'x_init'][0]
    theta = np.tile(base, (B, 1))
    theta[:, xi.offset:xi.offset + xi.flat_size] = \
        np.random.default_rng(seed).uniform(-2, 2, (B, xi.flat_size))
    return theta


def _assert_same_solution(ref, port, tol=1e-6):
    assert port.status == ref.status
    assert abs(port.value - ref.value) <= tol * max(1.0, abs(ref.value))
    for va, vb in zip(ref.variables(), port.variables()):
        np.testing.assert_allclose(vb.value, va.value, rtol=0, atol=tol)
    for ca, cb in zip(ref.constraints, port.constraints):
        np.testing.assert_allclose(np.asarray(cb.dual_value),
                                   np.asarray(ca.dual_value), rtol=0, atol=tol)


def test_generate_code_cpg_solve_matches_reference(tmp_path):
    ref, port = _mpc_pair()
    cpg_ref.generate_code(ref, code_dir=str(tmp_path / 'ref'), solver='ADMM')
    cpg.generate_code(port, code_dir=str(tmp_path / 'port'), solver='ADMM',
                      device='cpu')
    assert (tmp_path / 'port' / 'family.pkl').exists()
    src = (tmp_path / 'port' / 'cpg_solver.py').read_text()
    assert 'cvxpygen_tpu_torch.codegen.runtime' in src
    ref.solve(method='CPG', kkt_solver='inv')
    port.solve(method='CPG', kkt_solver='inv')
    assert port.status == 'optimal'
    assert port.solver_stats.num_iters == ref.solver_stats.num_iters
    _assert_same_solution(ref, port)
    # parameter update + warm start from the previous solution
    x_new = np.random.default_rng(1).uniform(-2, 2, 6)
    for prob in (ref, port):
        prob.param_dict['x_init'].value = x_new
        prob.solve(method='CPG', updated_params=['x_init'], kkt_solver='inv')
    assert port.solver_stats.num_iters == ref.solver_stats.num_iters
    _assert_same_solution(ref, port)


def test_solve_batch_matches_reference():
    ref, _ = _mpc_pair()
    fam_ref = canon_ref(ref)
    theta = _x_init_batch(fam_ref, ref, 16)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000, kkt_solver='inv')
    out_ref = SolverRef(fam_ref, settings=SettingsRef(**kw)).solve_batch(theta)
    solver = CompiledQPSolver(family_from_arrays(family_to_arrays(fam_ref)),
                              settings=ADMMSettings(**kw), device='cpu')
    out = solver.solve_batch(theta)
    assert out['x'].dtype == torch.float64
    assert np.all(out['status'].numpy() == 1)
    assert np.array_equal(np.asarray(out_ref['status']), out['status'].numpy())
    assert np.array_equal(np.asarray(out_ref['iters']), out['iters'].numpy())
    np.testing.assert_allclose(out['x'].numpy(), np.asarray(out_ref['x']),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose((out['obj'] + out['d']).numpy(),
                               np.asarray(out_ref['obj'] + out_ref['d']),
                               rtol=0, atol=1e-8)
    # a tensor batch takes the same path
    out_t = solver.solve_batch(torch.as_tensor(theta))
    assert torch.equal(out_t['x'], out['x'])


def _assert_same_batch(out_ref, out, atol=1e-8):
    assert np.array_equal(np.asarray(out_ref['status']), out['status'].numpy())
    assert np.array_equal(np.asarray(out_ref['iters']), out['iters'].numpy())
    np.testing.assert_allclose(out['x'].numpy(), np.asarray(out_ref['x']),
                               rtol=0, atol=atol)
    np.testing.assert_allclose((out['obj'] + out['d']).numpy(),
                               np.asarray(out_ref['obj'] + out_ref['d']),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(out['y_canon'].numpy(),
                               np.asarray(out_ref['y_canon']), rtol=0,
                               atol=atol)


def test_non_shared_batch_raises():
    """A non-shared batch that kernel K2 cannot take (B=6: no block of the
    reference's rule divides it) raises under use_pallas='full'; unlike the
    reference (solvers/admm.py:341) the port does not fall back to the
    loop."""
    _, port = _mpc_pair()
    fam = canonicalize(port)
    solver = CompiledQPSolver(fam, device='cpu', settings=ADMMSettings(
        use_pallas='full'))
    theta = _x_init_batch(fam, port, 6)
    with pytest.raises(ValueError, match='no block'):
        solver.solve_batch(theta, shared_PA=False)
    assert solver.solve_batch(theta[:4], shared_PA=False)['status'].tolist() \
        == [1] * 4


def test_non_shared_batch_solves():
    """A batch whose rows differ in a P/A-relevant parameter takes the
    per-instance branch and solves."""
    _, port = _mpc_pair()
    fam = canonicalize(port)
    solver = CompiledQPSolver(fam, device='cpu')
    theta = _x_init_batch(fam, port, 4)
    theta[0, np.where(solver._pa_mask)[0][0]] += 0.1
    assert not solver._use_shared(theta, 'auto')
    out = solver.solve_batch(theta)
    assert out['status'].tolist() == [1] * 4
    # the other rows' solutions do not depend on row 0
    rest = solver.solve_batch(theta[1:], shared_PA=False)
    np.testing.assert_allclose(rest['x'].numpy(), out['x'][1:].numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize('engine', ['never', 'full_interpret'])
def test_per_instance_solve_batch_matches_reference(engine):
    """shared_PA=False on MPC H=3: the per-instance branch of both packages
    on the same 8 distinct x_init."""
    ref, _ = _mpc_pair()
    fam_ref = canon_ref(ref)
    theta = _x_init_batch(fam_ref, ref, 8)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000, use_pallas=engine,
              kkt_solver='inv' if engine == 'never' else 'ns', ns_iters=40,
              adaptive_rho=True, adaptive_rho_tolerance=1.5)
    out_ref = SolverRef(fam_ref, settings=SettingsRef(**kw)).solve_batch(
        theta, shared_PA=False)
    solver = CompiledQPSolver(family_from_arrays(family_to_arrays(fam_ref)),
                              settings=ADMMSettings(**kw), device='cpu')
    out = solver.solve_batch(theta, shared_PA=False)
    assert np.all(out['status'].numpy() == 1)
    _assert_same_batch(out_ref, out)


def test_portfolio_varying_factors_matches_reference():
    """Portfolio with per-instance factor loadings F (bench.py:473-495 at a
    small size): canonical P/A vary, so both packages take the per-instance
    path."""
    n_assets, m_factors, B = 6, 2, 8
    ref = problems_ref.assign_portfolio(
        problems_ref.portfolio_problem(n=n_assets, m=m_factors), seed=0,
        n=n_assets, m=m_factors)
    fam_ref = canon_ref(ref)
    rng = np.random.default_rng(7)
    base = fam_ref.pack_theta(params=ref.parameters())
    Fi = [pi for pi in fam_ref.param_info if pi.name == 'F'][0]
    ai = [pi for pi in fam_ref.param_info if pi.name == 'a'][0]
    theta = np.tile(base, (B, 1))
    theta[:, Fi.offset:Fi.offset + Fi.flat_size] = np.round(
        rng.standard_normal((B, Fi.flat_size)))
    theta[:, ai.offset:ai.offset + ai.flat_size] = rng.standard_normal(
        (B, ai.flat_size))
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000, kkt_solver='inv',
              use_pallas='never')
    solver_ref = SolverRef(fam_ref, settings=SettingsRef(**kw))
    assert not solver_ref._use_shared(theta, 'auto')
    out_ref = solver_ref.solve_batch(theta)
    fam = family_from_arrays(family_to_arrays(fam_ref))
    solver = CompiledQPSolver(fam, settings=ADMMSettings(**kw), device='cpu')
    assert not solver._use_shared(theta, 'auto')
    out = solver.solve_batch(theta)
    assert np.all(out['status'].numpy() == 1)
    _assert_same_batch(out_ref, out)


def test_device_unset_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    _, port = _mpc_pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompiledQPSolver(canonicalize(port))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_compiled_solver(canonicalize(port), 'CLARABEL')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cpg.generate_code(port, code_dir=str(tmp_path / 'p'), solver='ADMM')


def test_unported_engines_raise(tmp_path):
    """The engines that raised before they were ported now route to their
    solvers: the IPM aliases, the conic ADMM (SCS), the long-horizon MPC
    family (the banded solver), gradient=True on a QP-form package through
    the ADMM and through the conic engines (ECOS, SCS), and the explicit
    solver (on a family with constant P and A and a bounded parameter
    domain; MPC's A depends on its parameters, which the explicit solver
    refuses, as the reference's does)."""
    from cvxpygen_tpu_torch.codegen.runtime import ExplicitRuntime
    from cvxpygen_tpu_torch.solvers.explicit import ExplicitError
    pt = _problems_torch()
    _, port = _mpc_pair()
    fam = canonicalize(port)
    for solver in ('SCS', 'CONIC_ADMM'):
        assert make_compiled_solver(fam, solver,
                                    device='cpu').solver_name == 'CONIC_ADMM'
    for solver in ('IPM', 'ECOS', 'CLARABEL', 'QOCO', 'QOCOGEN'):
        assert make_compiled_solver(fam, solver,
                                    device='cpu').solver_name == 'IPM'
    with pytest.raises(ExplicitError, match='parameter-independent A'):
        cpg.generate_code(port, code_dir=str(tmp_path / 'p'),
                          solver='explicit', device='cpu')
    x = cvxpygen_tpu_torch.Variable(2, name='x')
    b = cvxpygen_tpu_torch.Parameter(2, name='b')
    box = cvxpygen_tpu_torch.Problem(
        cvxpygen_tpu_torch.Minimize(cvxpygen_tpu_torch.sum_squares(x - b)),
        [x >= 0, b >= -1, b <= 1])
    mod = cpg.generate_code(box, code_dir=str(tmp_path / 'e'),
                            solver='explicit', device='cpu')
    assert isinstance(mod._runtime, ExplicitRuntime)
    for kw in (dict(solver='SCS'), dict(solver='ADMM', gradient=True),
               dict(solver='ECOS', gradient=True),
               dict(solver='SCS', gradient=True)):
        mod = cpg.generate_code(port, code_dir=str(tmp_path / 'p'),
                                device='cpu', **kw)
        assert mod._runtime.requested_solver == kw['solver']
        assert mod._runtime.gradient_enabled == kw.get('gradient', False)
    long_mpc = canonicalize(pt.assign_MPC(pt.MPC_problem(H=30)))
    assert long_mpc.n >= 512
    assert make_compiled_solver(long_mpc, 'ADMM',
                                device='cpu').solver_name == 'ADMM_BANDED'


def _entropy(pkg, n=3):
    x = pkg.Variable(n, name='x')
    c = pkg.Parameter(n, name='c')
    c.value = np.arange(n, dtype=float)
    return pkg.Problem(pkg.Maximize(c @ x + pkg.sum(pkg.entr(x))),
                       [pkg.sum(x) == 1.0])


def _sdp(pkg):
    X = pkg.Variable((2, 2), name='X', PSD=True)
    C = pkg.Parameter((2, 2), name='C')
    C.value = np.eye(2)
    return pkg.Problem(pkg.Minimize(pkg.trace(C @ X)),
                       [pkg.trace(X) == 1.0])


def _pow(pkg):
    x = pkg.Variable(name='x')
    y = pkg.Variable(name='y')
    z = pkg.Variable(name='z')
    p = pkg.Parameter(name='p')
    p.value = 1.0
    return pkg.Problem(pkg.Maximize(z), [pkg.PowCone3D(x, y, z, 0.5),
                                         x == p, y == p])


@pytest.mark.parametrize('family', ['MPC', 'ADP', 'entropy', 'sdp', 'pow'])
def test_default_solver_matches_reference(family, tmp_path):
    """generate_code's default engine follows the reference's rule
    (cvxpygen_tpu/cpg.py:48-55): QP-form -> ADMM, SOC-only -> IPM,
    exp/PSD/pow -> SCS (the conic ADMM)."""
    import cvxpygen_tpu as ct_ref
    from cvxpygen_tpu_torch.cpg import default_solver
    pt = _problems_torch()
    pair = {
        'MPC': lambda: _mpc_pair(),
        'ADP': lambda: (problems_ref.assign_ADP(problems_ref.ADP_problem()),
                        pt.assign_ADP(pt.ADP_problem())),
        'entropy': lambda: (_entropy(ct_ref), _entropy(cvxpygen_tpu_torch)),
        'sdp': lambda: (_sdp(ct_ref), _sdp(cvxpygen_tpu_torch)),
        'pow': lambda: (_pow(ct_ref), _pow(cvxpygen_tpu_torch)),
    }[family]
    ref, port = pair()
    want = {'MPC': 'ADMM', 'ADP': 'IPM'}.get(family, 'SCS')
    ref_dir = tmp_path / 'ref'
    cpg_ref.generate_code(ref, code_dir=str(ref_dir), wrapper=False)
    assert f'"solver": "{want}"' in (ref_dir / 'cpg_solver.py').read_text()
    assert default_solver(canonicalize(port)) == want
    mod = cpg.generate_code(port, code_dir=str(tmp_path / 'p'), device='cpu')
    assert mod._runtime.requested_solver == want
