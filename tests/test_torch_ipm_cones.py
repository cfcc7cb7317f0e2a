"""The port's exotic-cone calculus (cvxpygen_tpu_torch/solvers/ipm_cones.py)
against the JAX package's, each reference under jax.jit (float64; called
eagerly, JAX dispatches and compiles every operation of its loops one by
one, which took most of this file's time): the closed-form
barrier derivatives against JAX autodiff, the scalings, step lengths,
proximity and distances; then the HSDE post-pass through the port's
CompiledConicSolver on the infeasible families of tests/test_hsde.py, held
to that file's expected statuses."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax

import cvxpygen_tpu_torch as ct
from cvxpygen_tpu.solvers import ipm_cones as ref
from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
from cvxpygen_tpu_torch.runtime.solver import make_compiled_solver
from cvxpygen_tpu_torch.solvers import ipm_cones as port

TOL = 1e-11
EXO = dict(n_exp=2, psd_dims=(2,), pow_alphas=(0.3, 0.6))


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, float(np.max(np.abs(b)))))


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _interior(rng, B, jitter=0.3):
    """s, z strictly inside the exotic cones (and duals) of EXO: the
    reference's starting point, perturbed."""
    exo = ref.ExoticCones(**EXO)
    e = np.asarray(ref.exotic_init(B, exo, np.float64))
    s = e * (1 + jitter * rng.random(e.shape))
    z = e * (1 + jitter * rng.random(e.shape))
    # keep the PSD svec blocks SPD and the pow third entries nonzero
    o = exo.psd_off
    s[:, o:o + 3] = [1.2, 0.3, 0.9]
    z[:, o:o + 3] = [0.8, -0.2, 1.1]
    s[:, exo.pow_off + 2::3] = 0.1
    z[:, exo.pow_off + 2::3] = -0.1
    return s, z


def test_barrier_derivatives_match_autodiff():
    rng = np.random.default_rng(0)
    s, z = _interior(rng, 4)
    zf = z[:, :6].reshape(-1, 3)
    sf = s[:, :6].reshape(-1, 3)
    g, h = port._exp_dual_derivs(*_t(zf))
    _close(g, jax.jit(ref._exp_grad)(zf))
    _close(h, jax.jit(ref._exp_hess)(zf))
    _close(port._exp_primal_grad(*_t(sf)), jax.jit(ref._exp_pgrad)(sf))
    exo = ref.ExoticCones(**EXO)
    pow_grad_hess = jax.jit(ref._pow_grad_hess, static_argnums=1)
    for i, a in enumerate(EXO['pow_alphas']):
        o = exo.pow_off + 3 * i
        g_r, h_r = pow_grad_hess(z[:, o:o + 3], a)
        g, h = port._pow_dual_derivs(*_t(z[:, o:o + 3]), a)
        _close(g, g_r)
        _close(h, h_r)
        pg_r = jax.jit(jax.vmap(jax.grad(
            lambda v, aa=a: ref._pow_primal_barrier(v, aa))))(s[:, o:o + 3])
        _close(port._pow_primal_grad(*_t(s[:, o:o + 3]), a), pg_r)


@pytest.mark.parametrize('strategy', ['pd', 'dual'])
def test_exotic_scaling_matches_reference(strategy):
    rng = np.random.default_rng(1)
    B = 3
    s, z = _interior(rng, B)
    mu = np.sum(s * z, axis=1) / 9.0
    v = rng.standard_normal(s.shape)
    exo_r = ref.ExoticCones(**EXO)

    @jax.jit
    def reference(s, z, mu, v, H0):
        es_r = ref.ExoticScaling(exo_r, s, z, mu, strategy)
        return (es_r.H_exp, es_r.g_exp,
                es_r.H_pow + es_r.g_pow + es_r.W_psd, es_r.apply(v),
                es_r.centering_rhs(z), es_r.set_H(H0, 2),
                es_r.set_H(H0, 2, inv=True))

    H0 = np.zeros((B, 2 + s.shape[1], 2 + s.shape[1]))
    H_exp, g_exp, blocks, Hv, cen, H_set, Hi_set = reference(s, z, mu, v, H0)
    es = port.ExoticScaling(port.ExoticCones(**EXO), *_t(s, z, mu),
                            strategy=strategy)
    _close(es.H_exp, H_exp)
    _close(es.g_exp, g_exp)
    for a, b in zip(es.H_pow + es.g_pow + es.W_psd, blocks):
        _close(a, b)
    _close(es.apply(torch.tensor(v)), Hv)
    _close(es.centering_rhs(torch.tensor(z)), cen)
    _close(es.set_H(torch.tensor(H0), 2), H_set)
    _close(es.set_H(torch.tensor(H0), 2, inv=True), Hi_set)


def test_sanitize_and_inv33_match_reference():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((5, 3, 3)) + 3 * np.eye(3)
    _close(port._inv33(torch.tensor(A)), jax.jit(ref._inv33)(A))
    H = np.einsum('bij,bkj->bik', A, A)
    g = rng.standard_normal((5, 3))
    H[1, 0, 0] = np.nan
    g[2, 1] = np.inf
    H[3] *= 1e30
    s3, z3 = np.abs(rng.standard_normal((2, 5, 3))) + 0.1
    mu = np.abs(rng.standard_normal(5))
    for a, b in zip(port._sanitize_blocks(*_t(H, g, s3, z3, mu)),
                    jax.jit(ref._sanitize_blocks)(H, g, s3, z3,
                                                  mu_floor=mu)):
        _close(a, b)


def test_step_proximity_and_distances_match_reference():
    rng = np.random.default_rng(3)
    B = 6
    s, z = _interior(rng, B)
    ds = rng.standard_normal(s.shape)
    dz = rng.standard_normal(z.shape)
    exo_r, exo = ref.ExoticCones(**EXO), port.ExoticCones(**EXO)
    _close(port.exotic_init(B, exo, torch.float64),
           jax.jit(ref.exotic_init, static_argnums=(0, 1, 2))(B, exo_r,
                                                              np.float64))
    _close(port.exotic_max_step(exo, *_t(s, ds, z, dz)),
           jax.jit(ref.exotic_max_step, static_argnums=0)(exo_r, s, ds, z,
                                                          dz))
    mu = np.sum(s * z, axis=1) / exo_r.degree
    _close(port.exotic_proximity(exo, *_t(s, z, mu)),
           jax.jit(ref.exotic_proximity, static_argnums=0)(exo_r, s, z, mu))
    alpha = np.geomspace(1e-3, 0.9, B)    # short steps pass, long shrink
    kw = dict(beta=0.5, backtracks=3)
    _close(port.exotic_centrality_alpha(exo, *_t(s, ds, z, dz),
                                        exo_r.degree, torch.tensor(alpha),
                                        **kw),
           jax.jit(ref.exotic_centrality_alpha, static_argnums=(0, 5),
                   static_argnames=tuple(kw))(exo_r, s, ds, z, dz,
                                              exo_r.degree, alpha, **kw))
    w = rng.standard_normal(s.shape)
    _close(port.exotic_dual_dist(exo, torch.tensor(w)),
           jax.jit(ref.exotic_dual_dist, static_argnums=0)(exo_r, w))
    _close(port.exotic_primal_dist(exo, torch.tensor(w)),
           jax.jit(ref.exotic_primal_dist, static_argnums=0)(exo_r, w))
    assert exo.dim == exo_r.dim and exo.degree == exo_r.degree
    assert exo.blocks() == exo_r.blocks()


def _solve(prob):
    make_compiled_solver(canonicalize(prob), 'CLARABEL',
                         device='cpu').solve_into_problem(prob)
    return prob


def test_hsde_exp_primal_infeasible_status():
    """tests/test_hsde.py:19-33: exp(y) <= q with q = -1 is primal
    infeasible, certified by the HSDE post-pass."""
    y = ct.Variable(name='y')
    q = ct.Parameter(name='q')
    prob = ct.Problem(ct.Minimize(y), [ct.exp(y) <= q, y >= 0.0])
    q.value = -1.0
    _solve(prob)
    assert prob.status == 'infeasible'
    assert prob.value == np.inf


def test_hsde_pow_primal_infeasible_status():
    """tests/test_hsde.py:75-89: x in PowCone3D needs x >= 0; x == -1 is
    primal infeasible."""
    x = ct.Variable(name='x')
    y = ct.Variable(name='y')
    z = ct.Variable(name='z')
    p1 = ct.Parameter(name='p1')
    p2 = ct.Parameter(name='p2')
    prob = ct.Problem(ct.Maximize(z),
                      [ct.PowCone3D(x, y, z, 0.6), x == p1, y == p2,
                       z >= 0.0])
    p1.value = -1.0
    p2.value = 1.0
    _solve(prob)
    assert prob.status == 'infeasible'


def test_hsde_batch_statuses_and_feasible_rows():
    """tests/test_hsde.py:36-56: in one batch, the infeasible instances get
    -3 and the feasible ones stay optimal at y = 0."""
    y = ct.Variable(name='y')
    q = ct.Parameter(name='q')
    prob = ct.Problem(ct.Minimize(y), [ct.exp(y) <= q, y >= 0.0])
    q.value = 2.0
    fam = canonicalize(prob)
    qi = [pi for pi in fam.param_info if pi.name == 'q'][0]
    theta = np.tile(fam.pack_theta(params=prob.parameters()), (4, 1))
    theta[:, qi.offset] = [2.0, -1.0, 3.0, -0.5]
    out = make_compiled_solver(fam, 'CLARABEL', device='cpu').solve_batch(
        theta)
    assert out['status'].tolist() == [1, -3, 1, -3]
    assert abs(float(out['x'][0, 0])) < 1e-5


def test_hsde_quadratic_objective_epigraph_status():
    """tests/test_hsde.py:94-108: with P != 0 the HSDE pass runs on the
    epigraph form (an extra SOC from an eigendecomposition of P), and the
    infeasible exp-cone instance still certifies as infeasible."""
    y = ct.Variable(name='y')
    q = ct.Parameter(name='q')
    prob = ct.Problem(ct.Minimize(ct.square(y) + y),
                      [ct.exp(y) <= q, y >= 0.0])
    q.value = -1.0
    assert canonicalize(prob).P_map.nnz > 0
    _solve(prob)
    assert prob.status == 'infeasible'
    assert prob.value == np.inf
