"""The conic ADMM (solvers/conic_admm.py, conic_admm_shared.py; the SCS
route) of cvxpygen_tpu_torch against the JAX package's, float64 on the
CPU: per-instance and shared solves on ADP (SOC), an entropy family (exp)
and a max-eigenvalue SDP (PSD), with the KKT pinned to 'inv' and to 'ns';
warm start and primal infeasibility as in tests/test_conic_admm*.py; and
generate_code's default route on entropy against the JAX package's."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
from cvxpygen_tpu import cpg as cpg_ref
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.ops.cones import ConeLayout as LayoutRef
from cvxpygen_tpu.runtime.jax_family import JaxFamily
from cvxpygen_tpu.runtime.jax_family import canon_batch as canon_ref_batch
from cvxpygen_tpu.runtime.jax_family import \
    canon_batch_shared as canon_ref_shared
from cvxpygen_tpu.solvers import conic_admm as conic_ref
from cvxpygen_tpu.solvers import conic_admm_shared as conic_shared_ref
from cvxpygen_tpu_torch import cpg
from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.runtime.solver import (CompiledConicADMMSolver,
                                               make_compiled_solver)
from cvxpygen_tpu_torch.solvers.conic_admm import ConicADMMSettings
from problems import ADP_problem, assign_ADP

B = 4


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


def entropy_problem(pkg, n=8):
    x = pkg.Variable(n, name='x')
    c = pkg.Parameter(n, name='c')
    c.value = np.zeros(n)
    return pkg.Problem(pkg.Maximize(c @ x + pkg.sum(pkg.entr(x))),
                       [pkg.sum(x) == 1.0])


def sdp_problem(s=3):
    t = ct_ref.Variable(name='t')
    A = ct_ref.Parameter((s, s), name='A')
    A.value = np.eye(s)
    return ct_ref.Problem(ct_ref.Minimize(t),
                          [ct_ref.multiply(t, np.eye(s)) >> A])


def _batch(name):
    """(reference family, theta (B, p)): instances that share P and A (the
    parameters enter q and b only) and differ per row."""
    rng = np.random.default_rng(7)
    prob = {'ADP': lambda: assign_ADP(ADP_problem()),
            'entropy': lambda: entropy_problem(ct_ref),
            'SDP': sdp_problem}[name]()
    fam = canon_ref(prob)
    base = fam.pack_theta(params=prob.parameters())
    theta = np.tile(base, (B, 1))
    pi = {'ADP': 'f', 'entropy': 'c', 'SDP': 'A'}[name]
    pi = [p for p in fam.param_info if p.name == pi][0]
    sl = slice(pi.offset, pi.offset + pi.flat_size)
    if name == 'ADP':
        theta[:, sl] *= rng.uniform(0.5, 1.5, (B, pi.flat_size))
    else:
        theta[:, sl] = rng.standard_normal((B, pi.flat_size))
    return fam, theta


def _layout(fam, pkg):
    return pkg(n_nonneg=fam.n_nonneg, socs=tuple(fam.soc_dims),
               n_exp=fam.n_exp, psds=tuple(fam.psd_dims),
               pows=tuple(fam.pow_alphas))


def _settings(pkg, kkt):
    # adaptive_rho_tolerance 1.2 makes the 'ns' runs refactor (all but the
    # shared ADP one); fewer Ruiz passes and Newton-Schulz sweeps than the
    # defaults keep the reference's unrolled loops, and so its compile
    # time, small
    return pkg(eps_abs=1e-6, eps_rel=1e-6, max_iter=5000, kkt_solver=kkt,
               adaptive_rho_tolerance=1.2, scaling=3, ns_iters=15,
               ns_adapt_iters=6)


_CASES = [(f, k, s) for f in ('ADP', 'entropy', 'SDP')
          for k in ('inv', 'ns') for s in (False, True)]


@pytest.fixture(scope='module')
def reference():
    """The JAX package's solve of every case, computed once per module: one
    jitted program per family holds its four cases (one compile instead of
    four)."""
    out = {}
    for name in ('ADP', 'entropy', 'SDP'):
        fam, theta = _batch(name)
        jf = JaxFamily.from_family(fam)
        lay = _layout(fam, LayoutRef)
        cases = [c for c in _CASES if c[0] == name]

        def solve_all(th):
            res = []
            for _, kkt, shared in cases:
                st = _settings(conic_ref.ConicADMMSettings, kkt)
                if shared:
                    d = canon_ref_shared(jf, th)
                    solve = conic_shared_ref.conic_admm_solve_shared
                else:
                    d = canon_ref_batch(jf, th)
                    solve = conic_ref.conic_admm_solve
                res.append(solve(d['P'], d['q'], d['A'], d['b'], fam.n_zero,
                                 lay, st))
            return res

        for case, res in zip(cases, jax.jit(solve_all)(jnp.asarray(theta))):
            out[case] = {k: np.asarray(v) for k, v in res.items()}
    return out


@pytest.mark.parametrize('name,kkt,shared', _CASES)
def test_solve_matches_reference(reference, name, kkt, shared):
    fam, theta = _batch(name)
    solver = CompiledConicADMMSolver(
        family_from_arrays(family_to_arrays(fam)),
        settings=_settings(ConicADMMSettings, kkt), device='cpu')
    out = solver.solve_batch(theta, shared_PA=shared)
    ref = reference[name, kkt, shared]
    assert out['x'].dtype == torch.float64
    assert np.all(out['status'].numpy() == 1)
    assert np.array_equal(out['status'].numpy(), ref['status'])
    assert np.array_equal(out['iters'].numpy(), ref['iters'])
    for k in ('x', 'y'):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(out['obj'].numpy(), ref['obj'], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('shared', [False, True])
def test_warm_start_takes_no_more_iterations(shared):
    fam, theta = _batch('ADP')
    solver = make_compiled_solver(family_from_arrays(family_to_arrays(fam)),
                                  'SCS', device='cpu')
    cold = solver.solve_batch(theta, shared_PA=shared)
    warm = solver.solve_batch(theta, shared_PA=shared, x0=cold['x'],
                              y0=cold['y'])
    assert bool(warm['solved'].all())
    assert float(warm['iters'].float().mean()) <= \
        float(cold['iters'].float().mean())


@pytest.mark.parametrize('shared', [False, True])
def test_primal_infeasible(shared):
    """x >= p with sum(x) <= -1 and p = 1: status -3, objective +inf."""
    x = ct.Variable(3, name='x')
    p = ct.Parameter(3, name='p')
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x)),
                      [x >= p, ct.sum(x) <= -1.0])
    p.value = np.ones(3)
    solver = make_compiled_solver(ct.canon.canonicalizer.canonicalize(prob),
                                  'CONIC_ADMM', device='cpu',
                                  settings=ConicADMMSettings(max_iter=4000))
    theta = np.tile(solver.family.pack_theta(params=prob.parameters()),
                    (2, 1))
    out = solver.solve_batch(theta, shared_PA=shared)
    assert np.all(out['status'].numpy() == -3)
    assert np.all(np.isposinf(out['obj'].numpy()))


def test_generate_code_default_route_matches_reference(tmp_path):
    ref, port = entropy_problem(ct_ref), entropy_problem(ct)
    c = np.random.default_rng(3).standard_normal(8)
    for prob in (ref, port):
        prob.param_dict['c'].value = c
    cpg_ref.generate_code(ref, code_dir=str(tmp_path / 'ref'))
    mod = cpg.generate_code(port, code_dir=str(tmp_path / 'port'),
                            device='cpu')
    assert mod._runtime.requested_solver == 'SCS'
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iters=5000)
    ref.solve(method='CPG', **kw)
    port.solve(method='CPG', **kw)
    assert port.status == ref.status == 'optimal'
    assert port.solver_stats.num_iters == ref.solver_stats.num_iters
    assert abs(port.value - ref.value) <= 1e-6 * max(1.0, abs(ref.value))
    x_ref, x_port = ref.variables()[0].value, port.variables()[0].value
    np.testing.assert_allclose(x_port, x_ref, rtol=0, atol=1e-6)
    assert abs(port.value - np.log(np.exp(c).sum())) <= 1e-4
    # the next solve warm-starts from this one
    cold_iters = port.solver_stats.num_iters
    port.solve(method='CPG', **kw)
    assert port.status == 'optimal'
    assert port.solver_stats.num_iters <= cold_iters
