"""QP differentiation of cvxpygen_tpu_torch (autodiff/qp_diff.py's autograd
function, autodiff/torch_layer.py's TorchLayer, CpgRuntime.cpg_gradient)
against the JAX package's, float64 on the CPU."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
from cvxpygen_tpu import cpg as cpg_ref
from cvxpygen_tpu.autodiff import qp_diff as qp_diff_ref
from cvxpygen_tpu.autodiff.torch_layer import TorchLayer as TorchLayerRef
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.runtime.jax_family import JaxFamily
from cvxpygen_tpu.solvers.admm import ADMMSettings as SettingsRef
from cvxpygen_tpu_torch import cpg
from cvxpygen_tpu_torch.autodiff.qp_diff import make_diff_solve
from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.runtime.torch_family import TorchFamily
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
from problems import (ADP_problem, MPC_problem, assign_ADP, assign_MPC,
                      assign_nonneg_LS, nonneg_LS_problem)

B = 4
_KW = dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000, kkt_solver='inv',
           use_pallas='never')


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


def _batch(name, shared):
    """(reference family, theta (B, p)): shared batches vary only the
    vector parameter, the others every parameter the family has."""
    if name == 'MPC':
        prob = assign_MPC(MPC_problem(H=3), seed=0)
        vary = ['x_init']
    else:
        prob = assign_nonneg_LS(nonneg_LS_problem(m=5, n=3, sparse=False))
        vary = ['b'] if shared else ['A', 'b']
    fam = canon_ref(prob)
    rng = np.random.default_rng(11)
    theta = np.tile(fam.pack_theta(params=prob.parameters()), (B, 1))
    for pi in fam.param_info:
        if pi.name in vary:
            sl = slice(pi.offset, pi.offset + pi.flat_size)
            theta[:, sl] += 0.5 * rng.standard_normal((B, pi.flat_size))
    return fam, theta


def _seeds(fam):
    rng = np.random.default_rng(5)
    return dict(x=rng.standard_normal((B, fam.n)),
                y=rng.standard_normal((B, fam.m)),
                obj=rng.standard_normal(B))


@pytest.fixture(scope='module')
def reference_vjp():
    """``jax.vjp`` of the JAX package's differentiable solve for every case,
    computed once per module: one jitted program per family holds its
    shared and per-instance cases (one compile instead of two)."""
    out = {}
    for name in ('nonneg_LS', 'MPC'):
        cases = [(shared,) + _batch(name, shared) for shared in (False, True)]

        def vjps(thetas):
            res = []
            for (shared, fam, _), th in zip(cases, thetas):
                solve_ref = qp_diff_ref.make_diff_solve(
                    JaxFamily.from_family(fam), SettingsRef(**_KW),
                    shared_PA=shared)
                o, vjp = jax.vjp(solve_ref, th)
                g = {k: jnp.asarray(v) for k, v in _seeds(fam).items()}
                res.append((o, vjp(g)[0]))
            return res

        res = jax.jit(vjps)([jnp.asarray(c[2]) for c in cases])
        for (shared, _, _), r in zip(cases, res):
            out[name, shared] = r
    return out


@pytest.mark.parametrize('shared', [False, True])
@pytest.mark.parametrize('name', ['nonneg_LS', 'MPC'])
def test_dtheta_matches_reference_vjp(reference_vjp, name, shared):
    fam, theta = _batch(name, shared)
    g = _seeds(fam)
    out_ref, dtheta_ref = reference_vjp[name, shared]

    tf = TorchFamily.from_family(family_from_arrays(family_to_arrays(fam)),
                                 device='cpu')
    solve = make_diff_solve(tf, ADMMSettings(**_KW), shared_PA=shared)
    th = torch.tensor(theta, requires_grad=True)
    out = solve(th)
    loss = sum((out[k] * torch.tensor(g[k])).sum() for k in ('x', 'y', 'obj'))
    loss.backward()
    for k in ('x', 'y', 'obj'):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(out_ref[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    dref = np.asarray(dtheta_ref)
    scale = np.maximum(1.0, np.abs(dref).max(axis=1, keepdims=True))
    assert np.all(np.abs(th.grad.numpy() - dref) / scale <= 1e-6), \
        float(np.max(np.abs(th.grad.numpy() - dref) / scale))


def _nonneg_ls(pkg, m=4, n=3):
    """tests/test_torch_layer.py's family."""
    x = pkg.Variable(n, name='x', nonneg=True)
    A = pkg.Parameter((m, n), name='A')
    b = pkg.Parameter(m, name='b')
    prob = pkg.Problem(pkg.Minimize(pkg.sum_squares(A @ x - b)))
    return prob, A, b, x


@pytest.fixture(scope='module')
def layers():
    """tests/test_torch_layer.py's family behind the reference's TorchLayer
    and the port's, built once for the module.  The reference layer's
    solve runs under jax.jit: called eagerly, JAX compiles each operation
    of the solve one by one."""
    out = []
    for pkg, Layer in ((ct_ref, TorchLayerRef), (ct, ct.TorchLayer)):
        prob, A, b, x = _nonneg_ls(pkg)
        kw = {} if pkg is ct_ref else dict(device='cpu')
        layer = Layer(prob, parameters=[A, b], variables=[x], **kw)
        if pkg is ct_ref:
            layer._solve_x = jax.jit(layer._solve_x)
        out.append(layer)
    return out


@pytest.mark.parametrize('batched', ['both', 'b_only', 'none'])
def test_torch_layer_matches_reference(layers, batched):
    """The JAX package's TorchLayer cases (tests/test_torch_layer.py):
    batched A and b, unbatched A broadcast against batched b, and one
    unbatched instance; outputs and parameter gradients."""
    rng = np.random.default_rng(1)
    Av = rng.standard_normal((3, 4, 3))
    bv = rng.standard_normal((3, 4))
    w = rng.standard_normal(3)
    if batched == 'b_only':
        Av = Av[0]
    elif batched == 'none':
        Av, bv = Av[0], bv[0]
    results = []
    for layer in layers:
        At = torch.tensor(Av, requires_grad=True)
        bt = torch.tensor(bv, requires_grad=True)
        (xt,) = layer(At, bt)
        (xt * torch.tensor(w)).sum().backward()
        results.append((xt.detach().numpy(), At.grad.numpy(),
                        bt.grad.numpy()))
    for ref, port in zip(*results):
        assert port.shape == ref.shape
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


def test_cpg_gradient_matches_reference(tmp_path):
    """tests/test_codegen.py::test_gradient_package's family and flow."""
    grads = []
    for pkg, gen, name in ((ct_ref, cpg_ref, 'ref'), (ct, cpg, 'port')):
        prob, A, b, x = _nonneg_ls(pkg, m=6, n=4)
        np.random.seed(0)
        A.value = np.random.randn(6, 4)
        b.value = np.random.randn(6)
        kw = {} if pkg is ct_ref else dict(device='cpu')
        mod = gen.generate_code(prob, code_dir=str(tmp_path / name),
                                solver='OSQP', gradient=True, **kw)
        prob.solve(method='CPG', eps_abs=1e-9, eps_rel=1e-9, max_iter=20000)
        x.gradient = 0.1 * np.ones(4)
        g = mod.cpg_gradient(prob)
        assert A.gradient is not None and b.gradient is not None
        grads.append(g)
    for k in ('A', 'b'):
        np.testing.assert_allclose(grads[1][k], grads[0][k], rtol=0,
                                   atol=1e-6)


def test_cone_families_raise(tmp_path):
    """Cone families and conic engines no longer raise: TorchLayer takes an
    SOC family to the conic differentiation, generate_code(gradient=True)
    builds a gradient package for it, and a QP family differentiates
    through the IPM (its slack giving the rows' values) as through the
    ADMM."""
    u = ct.Variable(2, name='u')
    f = ct.Parameter(2, name='f')
    f.value = np.ones(2)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(u - f)),
                      [ct.norm(u, 2) <= 1.0])
    layer = ct.TorchLayer(prob, parameters=[f], variables=[u], device='cpu')
    assert layer._conic and not layer._banded
    mod = cpg.generate_code(prob, code_dir=str(tmp_path / 'c'),
                            gradient=True, device='cpu')
    assert mod._runtime.solver.solver_name == 'IPM'
    prob.solve(method='CPG')
    u.gradient = np.array([1.0, 0.0])
    # u = f / |f| on the boundary: du0/df = (I - u u') / |f| row 0
    np.testing.assert_allclose(mod.cpg_gradient(prob)['f'],
                               [0.5 / np.sqrt(2), -0.5 / np.sqrt(2)],
                               rtol=0, atol=1e-6)
    x = ct.Variable(2, name='x')
    b = ct.Parameter(2, name='b')
    b.value = np.array([1.0, -1.0])
    qp = ct.Problem(ct.Minimize(ct.sum_squares(x - b)), [x >= 0])
    grads = []
    for solver in ('IPM', 'ADMM'):
        mod = cpg.generate_code(qp, code_dir=str(tmp_path / solver),
                                solver=solver, gradient=True, device='cpu')
        qp.solve(method='CPG')
        x.gradient = np.ones(2)
        grads.append(mod.cpg_gradient(qp)['b'])
    np.testing.assert_allclose(grads[0], [1.0, 0.0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-9)


def test_long_horizon_banded_family_raises():
    """n + m > 1500 with a banded KKT no longer raises: TorchLayer takes the
    banded vjp (autodiff/qp_diff_banded.py), as the reference's does."""
    T = 600
    x = ct.Variable(T, name='x')
    r = ct.Parameter(T, name='r')
    r.value = np.zeros(T)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x - r)
                                  + ct.sum_squares(ct.diff(x))),
                      [x >= 0, x <= 1])
    layer = ct.TorchLayer(prob, parameters=[r], variables=[x], device='cpu')
    assert layer._banded and not layer._conic
