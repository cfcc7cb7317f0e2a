"""The port's conic IPM (cvxpygen_tpu_torch/solvers/ipm.py) against the JAX
package's: the symmetric cone calculus, the NT scaling, the step to the
boundary and the Ruiz equilibration (each JAX function under jax.jit:
called eagerly, JAX compiles every operation of its loops one by one),
then
the slice end to end -- the entropy family through both packages'
CompiledConicSolver in the 'ldl' KKT mode and the port's fused K9/K10
routes (their plain versions), float64 (the JAX reference compiled once
for all of them)."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.runtime.solver import CompiledConicSolver as SolverRef
from cvxpygen_tpu.solvers import ipm as ipm_ref
from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
from cvxpygen_tpu_torch.runtime.solver import CompiledConicSolver
from cvxpygen_tpu_torch.solvers import ipm

L, SOCS = 3, (4, 3)
TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, float(np.max(np.abs(b)))))


def _interior(rng, B):
    """Points strictly inside R+^3 x SOC(4) x SOC(3)."""
    v = rng.standard_normal((B, L + sum(SOCS)))
    v[:, :L] = np.abs(v[:, :L]) + 0.1
    o = L
    for d in SOCS:
        v[:, o] = np.linalg.norm(v[:, o + 1:o + d], axis=1) + 0.5
        o += d
    return v


def test_settings_fields_and_defaults_match_reference():
    import dataclasses
    ref = [(f.name, f.default) for f in dataclasses.fields(ipm_ref.IPMSettings)]
    port = [(f.name, f.default) for f in dataclasses.fields(ipm.IPMSettings)]
    assert port == ref
    assert (ipm.IPMSettings.for_dtype(torch.float32, max_iter=7)
            == ipm.IPMSettings(**dataclasses.asdict(
                ipm_ref.IPMSettings.for_dtype(jnp.float32, max_iter=7))))


def test_cone_calculus_matches_reference():
    rng = np.random.default_rng(0)
    u, v = _interior(rng, 5), _interior(rng, 5)
    w = rng.standard_normal(u.shape)
    tu, tv, tw = (torch.tensor(a) for a in (u, v, w))

    @functools.partial(jax.jit, static_argnums=3)
    def reference(u, v, w, inv):
        W_r = ipm_ref.BatchNT(u, v, L, SOCS)
        return (ipm_ref.jprod(u, w, L, SOCS), ipm_ref.jdiv(u, w, L, SOCS),
                ipm_ref.cone_dist(w, L, SOCS),
                ipm_ref.cone_dist(w[:, :L], L, ()), W_r.mul(w, inv=inv),
                W_r.wtw_dense(5, u.shape[1], jnp.float64, inv=inv))

    _close(ipm.cone_e(5, L, SOCS, torch.float64),
           ipm_ref.cone_e(5, L, SOCS, jnp.float64))
    prod, div, dist, dist_l, _, _ = reference(u, v, w, False)
    _close(ipm.jprod(tu, tw, L, SOCS), prod)
    _close(ipm.jdiv(tu, tw, L, SOCS), div)
    _close(ipm.cone_dist(tw, L, SOCS), dist)
    _close(ipm.cone_dist(tw[:, :L], L, ()), dist_l)
    W = ipm.BatchNT(tu, tv, L, SOCS)
    for inv in (False, True):
        mul, wtw = reference(u, v, w, inv)[4:]
        _close(W.mul(tw, inv=inv), mul)
        _close(W.wtw_dense(5, u.shape[1], torch.float64, inv=inv), wtw)
    # the NT point maps z to W^-T s = lambda
    _close(W.mul(tv), W.mul(tu, inv=True), 1e-10)


def test_max_step_cone_matches_reference():
    rng = np.random.default_rng(1)
    v = _interior(rng, 6)
    dv = rng.standard_normal(v.shape) * 3.0
    dv[0] = v[0]                        # along the point: no boundary
    dv[1, L:L + 4] = [1.0, 1.0, 0.0, 0.0]   # a2 = 0: the linear root
    got = ipm.max_step_cone(torch.tensor(v), torch.tensor(dv), L, SOCS)
    ref = jax.jit(ipm_ref.max_step_cone, static_argnums=(2, 3))(v, dv, L,
                                                                 SOCS)
    _close(got, ref)
    assert float(got[0]) == 1e20


def test_ruiz_equilibrate_matches_reference():
    rng = np.random.default_rng(2)
    B, n, mz, mc = 3, 5, 2, L + sum(SOCS)
    A = rng.standard_normal((B, n, n))
    P = A @ np.swapaxes(A, 1, 2)
    data = (P, rng.standard_normal((B, n)), rng.standard_normal((B, mz, n)),
            rng.standard_normal((B, mz)), 10 * rng.standard_normal((B, mc, n)),
            rng.standard_normal((B, mc)))
    blocks = ipm._soc_slices(L, SOCS)
    got = ipm.ruiz_equilibrate_ipm(*(torch.tensor(a) for a in data), blocks, 4)
    ref = jax.jit(ipm_ref.ruiz_equilibrate_ipm, static_argnums=(6, 7))(
        *data, tuple(blocks), 4)
    for a, b in zip(got, ref):
        _close(a, b)


def _entropy(pkg, n):
    x = pkg.Variable(n, name='x')
    c = pkg.Parameter(n, name='c')
    return pkg.Problem(pkg.Maximize(c @ x + pkg.sum(pkg.entr(x))),
                       [pkg.sum(x) == 1.0]), c


def _entropy_batch(fam, prob, cs):
    base = fam.pack_theta(params=prob.parameters())
    ci = [pi for pi in fam.param_info if pi.name == 'c'][0]
    theta = np.tile(base, (cs.shape[0], 1))
    theta[:, ci.offset:ci.offset + ci.flat_size] = cs
    return theta


N_ENT, B_ENT = 8, 8
# The comparison with the JAX package runs the dual-barrier scaling with
# the neighbourhood backtracking off: there the iteration path is a smooth
# function of the data (a 1e-15 relative change of c moves no iteration
# count).  With the default two-secant scaling ('pd') or with
# backtracking, each package makes discrete choices on roundoff-level
# differences -- the scaling's crossover test, the backtracking count --
# and a 1e-15 change of c moves x by about 1e-6 and an instance's
# iteration count by several iterations at the default 1e-8.  There the
# converged answer is held to the analytic optimum instead.
CMP = dict(kkt_solver='ldl', exotic_scaling='dual', exotic_backtracks=0)


@pytest.fixture(scope='module')
def entropy():
    """The entropy family (bench.py:395-457) at n=8, B=8: the JAX package's
    'ldl' solve at CMP, computed once, and the port's family and batch."""
    cs = np.random.default_rng(5).normal(size=(B_ENT, N_ENT))
    prob_r, c_r = _entropy(ct_ref, N_ENT)
    c_r.value = cs[0]
    fam_r = canon_ref(prob_r)
    out_r = SolverRef(fam_r, settings=ipm_ref.IPMSettings(**CMP),
                      dtype=jnp.float64).solve_batch(
        _entropy_batch(fam_r, prob_r, cs))
    out_r = {k: np.asarray(v) for k, v in out_r.items()}
    prob, c = _entropy(ct, N_ENT)
    c.value = cs[0]
    fam = canonicalize(prob)
    return dict(cs=cs, ref=out_r, fam=fam,
                theta=_entropy_batch(fam, prob, cs))


def _port_solve(entropy, **settings):
    solver = CompiledConicSolver(entropy['fam'], device='cpu',
                                 settings=ipm.IPMSettings(**settings))
    assert solver.P_is_zero
    return {k: v.numpy() for k, v in solver.solve_batch(
        entropy['theta']).items()}


def test_entropy_ldl_matches_reference(entropy):
    """The slice end to end in float64: equal status and iterations, x and
    the duals within 1e-6, objectives within 1e-8."""
    out, ref = _port_solve(entropy, **CMP), entropy['ref']
    assert out['x'].shape == (B_ENT, 2 * N_ENT)
    np.testing.assert_array_equal(out['status'], ref['status'])
    assert np.all(out['status'] == 1)
    np.testing.assert_array_equal(out['iters'], ref['iters'])
    np.testing.assert_allclose(out['x'], ref['x'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out['y_canon'], ref['y_canon'], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(out['obj'], ref['obj'], rtol=0, atol=1e-8)


@pytest.mark.parametrize('over', [dict(ldl_inverse=False),
                                  dict(ldl_two_level=True)],
                         ids=['sweep_solve', 'two_level'])
def test_entropy_ldl_variants_match_reference(entropy, over):
    """K8's route (ldl_inverse=False) and the two-level factorization reach
    the reference's 'ldl' answer: equal status, objectives within 1e-6."""
    out, ref = _port_solve(entropy, **CMP, **over), entropy['ref']
    np.testing.assert_array_equal(out['status'], ref['status'])
    np.testing.assert_allclose(out['obj'], ref['obj'], rtol=0, atol=1e-6)


@pytest.mark.parametrize('mode', ['ldl', 'lu', 'auto'])
def test_entropy_default_scaling_reaches_optimum(entropy, mode):
    """The default settings (two-secant scaling, backtracking, 1e-8) in
    each CPU mode ('auto' is 'lu' off CUDA, the reference's off-TPU rule):
    every instance solved, x = softmax(c) and the objective
    logsumexp(c)."""
    out = _port_solve(entropy, kkt_solver=mode)
    cs = entropy['cs']
    assert np.all(out['status'] == 1)
    sm = np.exp(cs) / np.sum(np.exp(cs), axis=1, keepdims=True)
    fam = entropy['fam']
    xv = [v for v in fam.user_vars if v.name == 'x'][0]
    # the stopping rule bounds the objective gap (1e-8 relative); x, at a
    # strongly concave optimum, to about its square root
    np.testing.assert_allclose(out['x'][:, xv.offset:xv.offset + N_ENT], sm,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(-(out['obj'] + out['d']),
                               np.log(np.sum(np.exp(cs), axis=1)), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize('route,over', [('k9', {}), ('k10', {}),
                                        ('k9', dict(ldl_two_level=True))],
                         ids=['k9', 'k10', 'k9_two_level'])
def test_entropy_fused_routes_match_reference(entropy, monkeypatch, route,
                                              over):
    """The slice end to end: the entropy family (n=8, B=8) through the
    port's CompiledConicSolver with the route helper forced to K9 or K10
    (their plain versions on the CPU) against the JAX package's 'ldl'
    solve: equal status and iterations, x within 1e-6 (the two-level
    route: equal status, objectives within 1e-6, the bar of its K6 + K7
    route in tests/test_torch_ipm.py).  K6 runs in neither route."""
    calls = {'fused': 0}
    fused = {'k9': 'ldl_factor_inverse_kernel', 'k10': 'ldl_kinv_kernel'}[
        route]
    real = getattr(ipm, fused)

    def counted(*args, **kw):
        calls['fused'] += 1
        return real(*args, **kw)

    def no_k6(*args, **kw):
        raise AssertionError('K6 ran on a fused route')

    monkeypatch.setattr(ipm, '_kinv_route',
                        lambda device, st, two_level: route)
    monkeypatch.setattr(ipm, fused, counted)
    monkeypatch.setattr(ipm, 'ldl_factor_kernel', no_k6)
    out, ref = _port_solve(entropy, **CMP, **over), entropy['ref']
    assert calls['fused'] > 0
    np.testing.assert_array_equal(out['status'], ref['status'])
    assert np.all(out['status'] == 1)
    if over:
        np.testing.assert_allclose(out['obj'], ref['obj'], rtol=0, atol=1e-6)
        return
    np.testing.assert_array_equal(out['iters'], ref['iters'])
    np.testing.assert_allclose(out['x'], ref['x'], rtol=0, atol=1e-6)


def test_fused_opt_ins_ignored_off_cuda(monkeypatch):
    """CPG_LDL_FUSED / CPG_LDL_BM_FUSED pick the fused kernels on CUDA only,
    by the reference's precedence: FUSED (K9) over BM_FUSED (K10), BM_FUSED
    ignored on the two-level route, both ignored with ldl_inverse=False
    (K6 + K8); on the CPU they change nothing."""
    import dataclasses
    st = ipm.IPMSettings()
    sweep = dataclasses.replace(st, ldl_inverse=False)
    cpu, cuda = torch.device('cpu'), torch.device('cuda')
    for fused in ('0', '1'):
        for bm in ('0', '1'):
            monkeypatch.setenv('CPG_LDL_FUSED', fused)
            monkeypatch.setenv('CPG_LDL_BM_FUSED', bm)
            for two_level in (False, True):
                assert ipm._kinv_route(cpu, st, two_level) == 'k6k7'
                assert ipm._kinv_route(cuda, sweep, two_level) == 'k6k7'
            full = 'k9' if fused == '1' else 'k10' if bm == '1' else 'k6k7'
            assert ipm._kinv_route(cuda, st, False) == full
            assert ipm._kinv_route(cuda, st, True) == (
                'k9' if fused == '1' else 'k6k7')


def test_equality_only_family_matches_reference():
    """A family with no cone rows (mc == 0) takes the IPM's one saddle
    solve: the same x, duals and objective as the JAX package's."""
    def problem(pkg):
        x = pkg.Variable(3, name='x')
        b = pkg.Parameter(name='b')
        b.value = 2.0
        return pkg.Problem(pkg.Minimize(pkg.sum_squares(x) + x[0]),
                           [pkg.sum(x) == b])

    fam_r, fam = canon_ref(problem(ct_ref)), canonicalize(problem(ct))
    theta = np.array([[2.0], [-1.0]])
    ref = SolverRef(fam_r, dtype=jnp.float64).solve_batch(theta)
    out = CompiledConicSolver(fam, device='cpu').solve_batch(theta)
    assert out['status'].tolist() == [1, 1]
    for key in ('x', 'y_canon', 'obj', 'iters'):
        _close(out[key], ref[key])
