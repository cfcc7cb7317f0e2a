"""Banded QP differentiation of cvxpygen_tpu_torch
(autodiff/qp_diff_banded.py and TorchLayer's routing) against the JAX
package's autodiff/qp_diff_banded.py and the port's dense qp_vjp, on the
charging family of tests/test_admm_banded.py, float64 on the CPU."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
from cvxpygen_tpu.autodiff import qp_diff_banded as banded_ref
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.runtime.jax_family import JaxFamily
from cvxpygen_tpu.solvers.admm import ADMMSettings as SettingsRef
from cvxpygen_tpu.solvers.admm_banded import \
    build_banded_structure as structure_ref
from cvxpygen_tpu_torch.autodiff.qp_diff import qp_vjp
from cvxpygen_tpu_torch.autodiff.qp_diff_banded import (banded_vjp,
                                                        make_diff_solve_banded)
from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
from cvxpygen_tpu_torch.runtime.torch_family import (TorchFamily, canon_batch,
                                                     canon_batch_sparse,
                                                     qp_bounds_batch)
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
from cvxpygen_tpu_torch.solvers.admm_banded import (admm_solve_banded,
                                                    banded_index,
                                                    build_banded_structure)
from test_torch_banded import assign_charging, charging_problem

T = 24
B = 2
# the reference test's settings (tests/test_qp_diff_banded.py:76-77)
_KW = dict(eps_abs=1e-10, eps_rel=1e-10, max_iter=200000,
           use_pallas='never')
# against the JAX package's banded vjp: the same forward iterations
REF_TOL = 1e-6
# against the dense vjp on the same solve: the reference test's bar
DENSE_RTOL, DENSE_ATOL = 2e-4, 1e-7


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


def _batch(pkg):
    prob = charging_problem(pkg, T=T)
    thetas = []
    for i in range(B):
        assign_charging(prob, T=T, seed=i)
        thetas.append((canon_ref if pkg is ct_ref else canonicalize)(
            prob).pack_theta(params=prob.parameters()))
    return prob, np.stack(thetas)


def _seeds(n, m):
    rng = np.random.default_rng(1)
    return dict(x=rng.standard_normal((B, n)), y=rng.standard_normal((B, m)),
                obj=rng.standard_normal(B))


@pytest.fixture(scope='module')
def reference():
    """The JAX package's banded solve and its vjp, one jitted program."""
    prob, theta = _batch(ct_ref)
    fam = canon_ref(prob)
    struct = structure_ref(fam.P_idx, fam.A_idx, fam.n, fam.m)
    solve = banded_ref.make_diff_solve_banded(
        JaxFamily.from_family(fam, force_scatter=True), struct,
        SettingsRef(**_KW))
    g = {k: jnp.asarray(v) for k, v in _seeds(fam.n, fam.m).items()}

    def program(th):
        o, vjp = jax.vjp(solve, th)
        return o, vjp(g)[0]

    return jax.jit(program)(jnp.asarray(theta))


def test_banded_vjp_matches_reference(reference):
    out_ref, dtheta_ref = reference
    prob, theta = _batch(ct)
    fam = canonicalize(prob)
    tf = TorchFamily.from_family(fam, device='cpu', force_scatter=True)
    solve = make_diff_solve_banded(
        tf, build_banded_structure(fam.P_idx, fam.A_idx, fam.n, fam.m),
        ADMMSettings(**_KW))
    th = torch.tensor(theta, requires_grad=True)
    out = solve(th)
    g = _seeds(fam.n, fam.m)
    sum((out[k] * torch.tensor(g[k])).sum() for k in g).backward()
    for k in ('x', 'y', 'obj'):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(out_ref[k]), rtol=0,
                                   atol=1e-8, err_msg=k)
    dref = np.asarray(dtheta_ref)
    scale = np.maximum(1.0, np.abs(dref).max(axis=1, keepdims=True))
    err = float(np.max(np.abs(th.grad.numpy() - dref) / scale))
    assert err <= REF_TOL, err


@pytest.mark.parametrize('seed', ['x', 'obj'])
def test_banded_vjp_matches_dense_vjp(seed):
    """The banded backward and the dense one (autodiff/qp_diff.py::qp_vjp)
    at the same banded solve's x, y, z: the seed on x, and on the objective
    (its Px + q fold)."""
    prob, theta = _batch(ct)
    fam = canonicalize(prob)
    tf = TorchFamily.from_family(fam, device='cpu', force_scatter=True)
    st = build_banded_structure(fam.P_idx, fam.A_idx, fam.n, fam.m)
    ix = banded_index(st, 'cpu')
    th = torch.tensor(theta)
    data = canon_batch_sparse(tf, th)
    l, u = qp_bounds_batch(tf, data['b'])
    res = admm_solve_banded(st, data['pvals'], data['q'], data['avals'], l,
                            u, fam.n_zero, ADMMSettings(**_KW), index=ix)
    assert bool((res['status'] == 1).all())
    g = _seeds(fam.n, fam.m)
    gx = torch.tensor(g['x']) if seed == 'x' else torch.zeros((B, fam.n),
                                                               dtype=th.dtype)
    gobj = torch.tensor(g['obj']) if seed == 'obj' else torch.zeros(B)
    gy = torch.zeros((B, fam.m), dtype=th.dtype)
    d_band = banded_vjp(tf, st, ix, th, res['x'], res['y'], res['z'],
                        data['pvals'], data['avals'], data['q'], l, u, gx,
                        gy, gobj)
    tf_dense = TorchFamily.from_family(fam, device='cpu')
    dense = canon_batch(tf_dense, th)
    d_dense = qp_vjp(tf_dense, th, res['x'], res['y'], res['z'], dense['P'],
                     dense['q'], dense['A'], l, u, gx, gy, gobj)
    np.testing.assert_allclose(d_band.numpy(), d_dense.numpy(),
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)


def _charging_with_soc(T):
    """The charging family with one SOC row: conic and banded."""
    prob = charging_problem(ct, T=T)
    u = prob.var_dict['u']
    return ct.Problem(prob.objective,
                      prob.constraints + [ct.norm(u, 2) <= 10.0])


@pytest.mark.parametrize('case', ['auto', 'dense', 'forced', 'conic'])
def test_torch_layer_routes(case):
    """TorchLayer's routes, by construction alone: charging T=288 (n + m =
    2021 > 1500) takes the banded vjp under banded='auto' and the dense one
    under banded=False; banded=True forces the banded vjp at T=24; a cone
    family takes the conic differentiation before any band check (the
    reference's TorchLayer solves such a family as a box QP)."""
    Tc = 24 if case == 'forced' else 288
    prob = (_charging_with_soc(Tc) if case == 'conic'
            else assign_charging(charging_problem(ct, T=Tc), T=Tc))
    fam = canonicalize(prob)
    assert (fam.n + fam.m > 1500) == (Tc == 288)
    banded = {'auto': 'auto', 'dense': False, 'forced': True,
              'conic': 'auto'}[case]
    layer = ct.TorchLayer(prob, parameters=[prob.param_dict['p'],
                                            prob.param_dict['gamma']],
                          variables=[prob.var_dict['u']], device='cpu',
                          banded=banded)
    assert layer._banded == (case in ('auto', 'forced'))
    assert layer._conic == (case == 'conic')


def test_torch_layer_banded_gradient():
    """The banded route end to end through the layer at T=24 (banded=True):
    dL/dp of a weighted sum of u equals the autograd function's."""
    prob, theta = _batch(ct)
    p, gamma = prob.param_dict['p'], prob.param_dict['gamma']
    fam = canonicalize(prob)
    st = ADMMSettings(**_KW)
    layer = ct.TorchLayer(prob, parameters=[p, gamma],
                          variables=[prob.var_dict['u']], settings=st,
                          device='cpu', banded=True)
    pi = [q for q in fam.param_info if q.name == 'p'][0]
    pv = torch.tensor(theta[:, pi.offset:pi.offset + pi.flat_size],
                      requires_grad=True)
    w = torch.tensor(np.random.default_rng(2).standard_normal(T))
    (uval,) = layer(pv, torch.tensor(50.0, dtype=torch.float64))
    (uval * w).sum().backward()
    solve = make_diff_solve_banded(
        TorchFamily.from_family(fam, device='cpu', force_scatter=True),
        build_banded_structure(fam.P_idx, fam.A_idx, fam.n, fam.m), st)
    th = torch.tensor(theta, requires_grad=True)
    vi = [v for v in fam.user_vars if v.name == 'u'][0]
    (solve(th)['x'][:, vi.offset:vi.offset + vi.size] * w).sum().backward()
    np.testing.assert_allclose(
        pv.grad.numpy(), th.grad[:, pi.offset:pi.offset + pi.flat_size],
        rtol=0, atol=1e-12)


@pytest.mark.parametrize('case', ['banded', 'conic'])
def test_torch_layer_without_card_raises(case, monkeypatch):
    """With no card and no device the layer refuses, whatever its route."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    prob = (_charging_with_soc(288) if case == 'conic'
            else assign_charging(charging_problem(ct, T=288), T=288))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.TorchLayer(prob, parameters=[prob.param_dict['p'],
                                        prob.param_dict['gamma']],
                      variables=[prob.var_dict['u']])
