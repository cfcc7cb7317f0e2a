"""solvers/admm.py's per-instance solve (cvxpygen_tpu_torch) against the JAX
package's ``admm_solve``: the torch loop against the XLA loop, float64 on
the CPU, the same inputs made with numpy for both."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from test_full_kernel import _random_qp_batch
from cvxpygen_tpu.solvers import admm as admm_ref
from cvxpygen_tpu_torch.solvers import admm

# adaptive_rho_tolerance 1.5 makes the adaptive runs refactor (their
# iteration counts differ from the non-adaptive runs)
_TOL = 1.5


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test: the suite runs in several worker
    processes on shared cores, where multi-threaded BLAS calls on these
    small problems spin against each other."""
    with threadpool_limits(limits=1):
        yield


def _batch(**kw):
    """_random_qp_batch in float64: JAX arrays and torch tensors."""
    (P, q, A, l, u), n_eq = _random_qp_batch(**kw)
    arrs = tuple(np.asarray(v, np.float64) for v in (P, q, A, l, u))
    return (tuple(jnp.asarray(v) for v in arrs),
            tuple(torch.tensor(v) for v in arrs), n_eq)


def _settings(pkg, **kw):
    base = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=4000,
                check_interval=20, adaptive_rho_tolerance=_TOL,
                use_pallas='never')
    base.update(kw)
    return pkg.ADMMSettings(**base)


def _assert_same(ref, out, atol=1e-8):
    assert np.array_equal(np.asarray(ref['status']), out['status'].numpy())
    assert np.array_equal(np.asarray(ref['iters']), out['iters'].numpy())
    for k in ('x', 'y', 'z'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    np.testing.assert_allclose(out['obj'].numpy(), np.asarray(ref['obj']),
                               rtol=0, atol=atol)


@pytest.mark.parametrize('adaptive', [False, True])
@pytest.mark.parametrize('kkt', ['inv', 'chol', 'ns'])
def test_loop_matches_reference(kkt, adaptive):
    ref_in, port_in, n_eq = _batch(B=8)
    kw = dict(kkt_solver=kkt, ns_iters=40, adaptive_rho=adaptive)
    ref = admm_ref.admm_solve(*ref_in, n_eq, _settings(admm_ref, **kw))
    out = admm.admm_solve(*port_in, n_eq, _settings(admm, **kw))
    assert out['x'].dtype == torch.float64
    assert np.all(out['solved'].numpy())
    _assert_same(ref, out)


def test_adaptive_settings_refactor():
    """The adaptive runs above change rho: their iterations differ."""
    _, port_in, n_eq = _batch(B=8)
    off = admm.admm_solve(*port_in, n_eq, _settings(admm, kkt_solver='ns',
                                                    ns_iters=40))
    on = admm.admm_solve(*port_in, n_eq, _settings(
        admm, kkt_solver='ns', ns_iters=40, adaptive_rho=True))
    assert not np.array_equal(off['iters'].numpy(), on['iters'].numpy())


def test_warm_start_matches_reference():
    ref_in, port_in, n_eq = _batch(B=8, seed=2)
    kw = dict(kkt_solver='inv')
    cold = admm_ref.admm_solve(*ref_in, n_eq, _settings(admm_ref, **kw))
    warm_ref = admm_ref.admm_solve(*ref_in, n_eq, _settings(admm_ref, **kw),
                                   x0=cold['x'], y0=cold['y'])
    warm = admm.admm_solve(*port_in, n_eq, _settings(admm, **kw),
                           x0=torch.tensor(np.asarray(cold['x'])),
                           y0=torch.tensor(np.asarray(cold['y'])))
    _assert_same(warm_ref, warm)
    assert warm['iters'].float().mean() < float(np.mean(cold['iters']))


def _primal_infeasible_instance():
    """test_full_kernel.py's case: instance 0 with contradictory rows."""
    (P, q, A, l, u), n_eq = _random_qp_batch(B=8, seed=1)
    P, q, A, l, u = (np.array(v, np.float64) for v in (P, q, A, l, u))
    A[0, 4] = A[0, 5]
    l[0, 4], u[0, 4] = -1e30, -1.0
    l[0, 5], u[0, 5] = 1.0, 1e30
    return (P, q, A, l, u), n_eq, [-3] + [1] * 7


def _primal_infeasible_box():
    """An empty box: x >= 1 and x <= -1 (test_infeasibility.py's primal
    case in QP form)."""
    n, B = 2, 3
    P = np.tile(np.eye(n), (B, 1, 1))
    A = np.tile(np.vstack([np.eye(n), np.eye(n)]), (B, 1, 1))
    l = np.tile([1.0, 1.0, -1e30, -1e30], (B, 1))
    u = np.tile([1e30, 1e30, -1.0, -1.0], (B, 1))
    return (P, np.zeros((B, n)), A, l, u), 0, [-3] * B


def _dual_infeasible():
    """min -x s.t. x >= 0: unbounded below (test_infeasibility.py's dual
    case in QP form)."""
    B = 2
    return ((np.zeros((B, 1, 1)), np.full((B, 1), -1.0), np.ones((B, 1, 1)),
             np.zeros((B, 1)), np.full((B, 1), 1e30)), 0, [-4] * B)


@pytest.mark.parametrize('case', [_primal_infeasible_instance,
                                  _primal_infeasible_box, _dual_infeasible])
def test_infeasibility_matches_reference(case):
    data, n_eq, codes = case()
    kw = dict(eps_abs=1e-4, eps_rel=1e-4, max_iter=2000, kkt_solver='inv')
    ref = admm_ref.admm_solve(*(jnp.asarray(v) for v in data), n_eq,
                              _settings(admm_ref, **kw))
    out = admm.admm_solve(*(torch.tensor(v) for v in data), n_eq,
                          _settings(admm, **kw))
    assert out['status'].tolist() == codes
    assert np.array_equal(np.asarray(ref['status']), out['status'].numpy())
    assert np.array_equal(np.asarray(ref['iters']), out['iters'].numpy())
    bad = np.asarray(codes) != 1
    assert np.all(np.isinf(out['obj'].numpy()[bad]))
    np.testing.assert_array_equal(out['obj'].numpy()[bad],
                                  np.asarray(ref['obj'])[bad])


def test_unconstrained_closed_form():
    """m == 0: x = -(P + sigma I)^-1 q in one step."""
    rng = np.random.default_rng(3)
    F = rng.standard_normal((4, 5, 5))
    P = F @ np.swapaxes(F, 1, 2) + np.eye(5)
    q = rng.standard_normal((4, 5))
    A, lu = np.zeros((4, 0, 5)), np.zeros((4, 0))
    data = (P, q, A, lu, lu)
    ref = admm_ref.admm_solve(*(jnp.asarray(v) for v in data), 0,
                              admm_ref.ADMMSettings())
    out = admm.admm_solve(*(torch.tensor(v) for v in data), 0,
                          admm.ADMMSettings())
    assert out['y'].shape == (4, 0) and out['status'].tolist() == [1] * 4
    np.testing.assert_allclose(out['x'].numpy(), np.asarray(ref['x']),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out['obj'].numpy(), np.asarray(ref['obj']),
                               rtol=0, atol=1e-12)


def test_ruiz_matches_reference():
    ref_in, port_in, _ = _batch(B=4)
    ref = admm_ref.ruiz_equilibrate(*ref_in, 10)
    out = admm.ruiz_equilibrate(*port_in, 10)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14,
                                   atol=0)


def test_bad_settings_raise():
    _, port_in, n_eq = _batch(B=2)
    with pytest.raises(ValueError, match='kkt_solver'):
        admm.admm_solve(*port_in, n_eq, _settings(admm, kkt_solver='lu'))
    with pytest.raises(ValueError, match='use_pallas'):
        admm.admm_solve(*port_in, n_eq, _settings(admm, use_pallas='fast'))
