"""The port's native host runtime (cvxpygen_tpu_torch/native: ctypes over
cpg_core.cpp) against the JAX package's float64 oracle and its
differentiable solve (autodiff/qp_diff.py::make_diff_solve), on twins of
tests/test_native.py's families built in both packages' modeling layers
from the same seed.

The JAX package's own ``native`` module is not imported here: its build
writes a fixed temp name beside its source and could race with
tests/test_native.py in another worker.  tests/test_torch_emit_c.py holds
the two packages' cpg_core.cpp equal line for line instead."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
import problems as problems_ref
from cvxpygen_tpu.autodiff.qp_diff import make_diff_solve
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.runtime.jax_family import JaxFamily
from cvxpygen_tpu.solvers.admm import ADMMSettings as ADMMSettingsRef
from cvxpygen_tpu.solvers.oracle import solve_family_numpy
from cvxpygen_tpu_torch import native
from cvxpygen_tpu_torch.autodiff.qp_diff import _forward, qp_vjp
from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
from cvxpygen_tpu_torch.ops.build import BUILD_DIR
from cvxpygen_tpu_torch.runtime.torch_family import TorchFamily
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
from test_torch_banded import assign_charging, charging_problem
from test_torch_solver import _problems_torch

# objective against the oracle (tests/test_native.py's bars: 2e-2 for the
# dense QP families, 1e-2 for the SOC family, 1e-3 for the sparse core at
# eps 1e-6) and the user variables' relative distance
OBJ_TOL = {'nonneg_LS': 2e-2, 'MPC': 2e-2, 'ADP': 1e-2, 'charging': 1e-3}
X_TOL = 0.1
# tests/test_native.py::test_native_gradient_matches_jax_vjp
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
TIGHT = dict(eps_abs=1e-11, eps_rel=1e-11, max_iter=400000)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope='module')
def lib():
    """The port's library, built once for the module."""
    return native.get_lib()


def _twins(case, seed=0):
    """(reference problem, port problem) of ``case`` from one seed."""
    if case == 'charging':
        # T=96, the size of tests/test_native.py::test_native_sparse_warm_start
        return tuple(assign_charging(charging_problem(pkg, T=96), T=96)
                     for pkg in (ct_ref, ct))
    pt = _problems_torch()
    (make_r, assign_r), (make_p, assign_p) = (problems_ref.ALL[case],
                                              pt.ALL[case])
    return assign_r(make_r(), seed=seed), assign_p(make_p(), seed=seed)


def _oracle_obj(fam, theta):
    res, _ = solve_family_numpy(fam, theta)
    tt = np.concatenate([theta, [1.0]])
    d = float(np.asarray(fam.d_map @ tt).ravel()[0])
    if fam.d_quad is not None:
        d += float(tt @ (fam.d_quad @ tt))
    return res.obj + d, res.x


def _user_x(fam, x):
    return np.concatenate([x[vi.offset:vi.offset + vi.size]
                           for vi in fam.user_vars])


def test_library_builds_outside_the_package(lib):
    """The library lies in build/cvxpygen_tpu_torch/, keyed on the
    source's hash; nothing is written beside the source."""
    path = native.lib_path()
    assert os.path.dirname(path) == BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith('libcpg_core_')
    assert not [f for f in os.listdir(os.path.dirname(native.SRC))
                if f.endswith(('.so', '.tmp'))]


def test_no_solver_route_reaches_native():
    """NativeQPSolver is the embedded C's counterpart, not a fallback: no
    module of the port outside native/ imports it."""
    import ast
    pkg = os.path.dirname(os.path.dirname(native.SRC))
    users = []
    for root, _, files in os.walk(pkg):
        if os.path.basename(root) == 'native':
            continue
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(root, name)
            for node in ast.walk(ast.parse(open(path).read())):
                if isinstance(node, ast.ImportFrom):
                    mods = [node.module or ''] + [a.name for a in node.names]
                elif isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                else:
                    continue
                if any(m.split('.')[-1] == 'native' for m in mods):
                    users.append(f'{path}:{node.lineno}')
    assert not users, users


@pytest.mark.parametrize('case', ['nonneg_LS', 'MPC', 'ADP', 'charging'])
def test_native_vs_oracle(lib, case):
    """tests/test_native.py::test_native_vs_oracle (nonneg_LS, MPC),
    ::test_native_socp_vs_oracle (ADP) and the sparse/banded core on
    charging T=96 (force_sparse), each against the JAX package's float64
    oracle on the reference twin."""
    ref, port = _twins(case)
    fam_r, fam = canon_ref(ref), canonicalize(port)
    theta = fam.pack_theta(params=port.parameters())
    np.testing.assert_array_equal(
        theta, fam_r.pack_theta(params=ref.parameters()))
    obj_ref, x_ref = _oracle_obj(fam_r, theta)

    ns = native.NativeQPSolver(fam, force_sparse=case == 'charging')
    assert ns.sparse_mode == (case == 'charging')
    if case == 'ADP':
        ns.set_settings(eps_abs=1e-5, eps_rel=1e-5, max_iter=20000)
    if case == 'charging':
        ns.set_settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=200000)
    out = ns.solve(theta)
    assert out['solved'], out
    assert abs(out['obj'] - obj_ref) < OBJ_TOL[case] * max(1.0, abs(obj_ref))
    prim_ref, prim = _user_x(fam_r, x_ref), _user_x(fam, out['x'])
    pn = np.linalg.norm(prim_ref)
    if pn > 1e-6:
        assert np.linalg.norm(prim - prim_ref) / pn < X_TOL


@pytest.mark.parametrize('force_sparse', [False, True])
def test_native_infeasibility_certificates(lib, force_sparse):
    """tests/test_native.py::test_native_infeasibility_certificates: -3 on
    a primal infeasible family, -4 on an unbounded one, in the dense and
    the sparse/banded core."""
    x = ct.Variable(2, name='xv')
    lo = ct.Parameter(2, name='lo')
    hi = ct.Parameter(2, name='hi')
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x)), [x >= lo, x <= hi])
    lo.value = np.array([1.0, 0.0])
    hi.value = np.array([-1.0, 2.0])
    fam = canonicalize(prob)
    ns = native.NativeQPSolver(fam, force_sparse=force_sparse)
    out = ns.solve(fam.pack_theta(params=prob.parameters()))
    assert out['status'] == -3, out
    assert np.isposinf(out['obj']) or out['obj'] >= 1e29

    x2 = ct.Variable(2, name='x2')
    p = ct.Parameter(2, name='pc')
    lo2 = ct.Parameter(2, name='lo2')
    prob2 = ct.Problem(ct.Minimize(p @ x2), [x2 >= lo2])
    p.value = np.array([1.0, -1.0])
    lo2.value = np.zeros(2)
    fam2 = canonicalize(prob2)
    ns2 = native.NativeQPSolver(fam2, force_sparse=force_sparse)
    out2 = ns2.solve(fam2.pack_theta(params=prob2.parameters()))
    assert out2['status'] == -4, out2
    assert np.isneginf(out2['obj']) or out2['obj'] <= -1e29


def test_native_rejects_theta_of_wrong_size(lib):
    """solve() checks theta's size, as gradient() checks its seeds: the
    core reads family.p doubles from it."""
    _, port = _twins('nonneg_LS')
    fam = canonicalize(port)
    theta = np.asarray(fam.pack_theta(params=port.parameters()), float)
    ns = native.NativeQPSolver(fam)
    for bad in (theta[:-1], np.stack([theta, theta])):
        with pytest.raises(ValueError, match='theta of size'):
            ns.solve(bad)


@pytest.mark.parametrize('case,seed,seed_on', [('nonneg_LS', 3, 'x'),
                                               ('MPC', 1, 'y')])
def test_native_gradient_matches_jax_vjp(lib, case, seed, seed_on):
    """The embedded gradient with an x seed (nonneg_LS, tests/
    test_native.py::test_native_gradient_matches_jax_vjp) and a dual seed
    (MPC, ::test_native_gradient_dual_seed_matches_jax) against jax.grad
    of the JAX package's make_diff_solve on the reference twin, and
    against the port's autodiff/qp_diff.py::qp_vjp at its float64 CPU
    solve, all at eps 1e-11."""
    ref, port = _twins(case, seed=seed)
    fam_r, fam = canon_ref(ref), canonicalize(port)
    theta = np.asarray(fam.pack_theta(params=port.parameters()), float)
    np.testing.assert_array_equal(
        theta, fam_r.pack_theta(params=ref.parameters()))
    rng = np.random.default_rng(1 if seed_on == 'x' else 2)
    g = rng.standard_normal(fam.n if seed_on == 'x' else fam.m)

    dsolve = make_diff_solve(JaxFamily.from_family(fam_r), settings=(
        ADMMSettingsRef(**TIGHT, use_pallas='never')))

    def loss(th):
        return jnp.sum(dsolve(th[None, :])[seed_on][0] * jnp.asarray(g))

    g_jax = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(theta)))

    tf = TorchFamily.from_family(fam, device='cpu', dtype=torch.float64)
    st = ADMMSettings(**TIGHT, kkt_solver='inv', use_pallas='never')
    th = torch.as_tensor(theta)[None, :]
    res, P, A, q, _, l, u = _forward(tf, th, st, shared=False)
    assert bool(res['solved'][0])
    gx = torch.zeros_like(res['x'])
    gy = torch.zeros_like(res['y'])
    (gx if seed_on == 'x' else gy)[0] = torch.as_tensor(g)
    g_vjp = qp_vjp(tf, th, res['x'], res['y'], res['z'], P, q, A, l, u, gx,
                   gy, torch.zeros(1, dtype=torch.float64))[0].numpy()

    ns = native.NativeQPSolver(fam)
    ns.set_settings(**TIGHT)
    out = ns.solve(theta)
    assert out['solved']
    g_c = ns.gradient(**{f'g{seed_on}': g})
    assert g_c.shape == (fam.p,)
    np.testing.assert_allclose(g_c, g_jax, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(g_c, g_vjp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
