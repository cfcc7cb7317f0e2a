"""The ADP SOCP family (tests/problems.py:190; reference
tests/test_E2E_SOCP.py:15-35) on the port's interior-point engine: the
'schur' KKT mode (the engine's CUDA choice for symmetric layouts with
P != 0, Newton-Schulz in torch.matmul) against the JAX package's, and the
default generate_code route (SOC-only family -> IPM) against the float64
oracle, float64."""
import types

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

import problems as problems_ref
import cvxpygen_tpu_torch
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.runtime.solver import CompiledConicSolver as SolverRef
from cvxpygen_tpu.solvers.ipm import IPMSettings as SettingsRef
from cvxpygen_tpu_torch import cpg
from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
from cvxpygen_tpu_torch.runtime.solver import CompiledConicSolver
from cvxpygen_tpu_torch.solvers.ipm import IPMSettings

B = 6


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _adp_pair():
    pt = types.ModuleType('problems_torch')
    src = open(problems_ref.__file__).read()
    exec(compile(src, problems_ref.__file__, 'exec'), pt.__dict__)
    pt.ct = cvxpygen_tpu_torch
    return (problems_ref.assign_ADP(problems_ref.ADP_problem()),
            pt.assign_ADP(pt.ADP_problem()))


def _f_batch(fam, prob):
    """bench.py:355-361: the ADP batch, f scaled by U(0.5, 1.5) per entry."""
    base = fam.pack_theta(params=prob.parameters())
    fi = [pi for pi in fam.param_info if pi.name == 'f'][0]
    theta = np.tile(base, (B, 1))
    theta[:, fi.offset:fi.offset + fi.flat_size] *= \
        np.random.default_rng(1).uniform(0.5, 1.5, (B, fi.flat_size))
    return theta


@pytest.fixture(scope='module')
def adp():
    """The ADP batch in both packages and the JAX package's 'schur' solve,
    computed once."""
    ref_prob, port_prob = _adp_pair()
    fam_r, fam = canon_ref(ref_prob), canonicalize(port_prob)
    theta = _f_batch(fam, port_prob)
    np.testing.assert_array_equal(theta, _f_batch(fam_r, ref_prob))
    ref = SolverRef(fam_r, settings=SettingsRef(kkt_solver='schur'),
                    dtype=jnp.float64).solve_batch(theta)
    return dict(fam=fam, theta=theta,
                ref={k: np.asarray(v) for k, v in ref.items()})


def _port(adp, mode):
    solver = CompiledConicSolver(adp['fam'], settings=IPMSettings(
        kkt_solver=mode), device='cpu')
    assert not solver.P_is_zero
    return {k: v.numpy() for k, v in solver.solve_batch(
        adp['theta']).items()}


def test_adp_schur_matches_reference(adp):
    """Equal status and iterations, x and the duals within 1e-6, objectives
    within 1e-8, on the canonical layout n=17, nine zero rows, two nonneg
    rows and two SOC(4) cones."""
    fam = adp['fam']
    assert (fam.n, fam.n_zero, fam.n_nonneg, tuple(fam.soc_dims)) == \
        (17, 9, 2, (4, 4))
    out, ref = _port(adp, 'schur'), adp['ref']
    np.testing.assert_array_equal(out['status'], ref['status'])
    assert np.all(out['status'] == 1)
    np.testing.assert_array_equal(out['iters'], ref['iters'])
    np.testing.assert_allclose(out['x'], ref['x'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out['y_canon'], ref['y_canon'], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(out['obj'], ref['obj'], rtol=0, atol=1e-8)


@pytest.mark.parametrize('mode', ['lu', 'ldl', 'schur_chol', 'schur_lu'])
def test_adp_other_kkt_modes_reach_reference(adp, mode):
    """The other KKT modes (the 'ldl' one through K6 and K7's plain
    versions) reach the reference's answer: every instance solved, x
    within 1e-6, objectives within 1e-7."""
    out, ref = _port(adp, mode), adp['ref']
    assert np.all(out['status'] == 1)
    np.testing.assert_allclose(out['x'], ref['x'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out['obj'], ref['obj'], rtol=0, atol=1e-7)


def test_adp_generate_code_default_ipm_matches_oracle(tmp_path):
    """generate_code with no solver picks the IPM for an SOC-only family
    (the reference's rule); solve(method='CPG') lands within 1e-6 of the
    float64 oracle, primal and duals, with the IPM's aliases accepted as
    runtime settings."""
    _, prob = _adp_pair()
    oracle = prob.solve()
    want = [np.array(v.value, copy=True) for v in prob.variables()]
    duals = [np.array(c.dual_value, copy=True) for c in prob.constraints]
    mod = cpg.generate_code(prob, code_dir=str(tmp_path / 'adp'),
                            device='cpu')
    assert mod._runtime.solver.solver_name == 'IPM'
    assert mod._runtime.requested_solver == 'IPM'
    val = prob.solve(method='CPG', feastol=1e-9, reltol=1e-9)
    assert prob.status == 'optimal'
    assert abs(val - oracle) <= 1e-6 * max(1.0, abs(oracle))
    for v, w in zip(prob.variables(), want):
        np.testing.assert_allclose(v.value, w, rtol=0, atol=1e-6)
    for c, w in zip(prob.constraints, duals):
        np.testing.assert_allclose(np.asarray(c.dual_value), w, rtol=0,
                                   atol=1e-6)
    assert prob.solver_stats.num_iters > 0
    # the IPM takes no warm start: a second solve repeats the first
    val2 = prob.solve(method='CPG', feastol=1e-9, reltol=1e-9)
    assert val2 == val
