"""Conic differentiation of cvxpygen_tpu_torch (autodiff/conic_diff.py: the
projection Jacobians, the autograd function, TorchLayer's conic route and
generate_code(gradient=True) on cone families) against the JAX package's
autodiff/conic_diff.py, float64 on the CPU.  The JAX references run under
jax.jit, one program per family."""
import types

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
import problems as problems_ref
from cvxpygen_tpu.autodiff import conic_diff as conic_diff_ref
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.ops.cones import ConeLayout as LayoutRef
from cvxpygen_tpu.runtime.jax_family import JaxFamily
from cvxpygen_tpu.solvers.conic_admm import \
    ConicADMMSettings as ConicSettingsRef
from cvxpygen_tpu.solvers.ipm import IPMSettings as IPMSettingsRef
from cvxpygen_tpu_torch import cpg
from cvxpygen_tpu_torch.autodiff import conic_diff
from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
from cvxpygen_tpu_torch.ops.cones import ConeLayout, project_cone_np
from cvxpygen_tpu_torch.runtime.torch_family import TorchFamily
from cvxpygen_tpu_torch.solvers.conic_admm import ConicADMMSettings
from cvxpygen_tpu_torch.solvers.ipm import IPMSettings

# projection Jacobians: the same arithmetic in both packages
JAC_TOL = 1e-10
# dtheta of the same forward iterations, relative to max(1, |dtheta|_inf)
DTHETA_TOL = 1e-6
# the forwards' x at the same iterations
X_TOL = 1e-9
B = 4

# the runtime's float64 gradient settings (codegen/runtime.py), with the
# CPU's 'auto' KKT mode of both packages ('lu' for the IPM, 'inv' for the
# conic ADMM) pinned
IPM_KW = dict(max_iter=100, tol_feas=1e-10, tol_gap=1e-10, kkt_solver='lu')
EXP_KW = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000, kkt_solver='inv')
SDP_KW = dict(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000, kkt_solver='inv')

LAYOUT = dict(n_nonneg=3, socs=(3,), n_exp=1, psds=(3,), pows=(0.3,))
KINDS = ('nonneg', 'soc', 'exp', 'psd', 'pow')
CASES = ('generic', 'interior', 'polar', 'face')


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


def _block(kind, case, rng):
    """One cone block's point of the given case: the interior of the cone,
    the interior of its polar, a face (exp: r, s <= 0; pow: u3 = 0; SOC:
    w = 0; PSD: a repeated eigenvalue) or a generic point."""
    if kind == 'nonneg':
        return rng.normal(size=3)
    if kind == 'soc':
        w = rng.normal(size=2)
        t = {'generic': rng.normal(), 'interior': np.linalg.norm(w) + 0.5,
             'polar': -np.linalg.norm(w) - 0.5, 'face': 0.7}[case]
        return np.concatenate([[t], 0 * w if case == 'face' else w])
    if kind == 'exp':
        if case == 'interior':
            r, s = rng.normal(), rng.uniform(0.5, 2.0)
            return np.array([r, s, s * np.exp(r / s) + rng.uniform(0.1, 1)])
        if case == 'polar':
            u1, u2 = -rng.uniform(0.5, 2.0), rng.normal()
            u3 = -u1 * np.exp(u2 / u1) / np.e + rng.uniform(0.1, 1)
            return -np.array([u1, u2, u3])
        if case == 'face':
            return np.array([-rng.uniform(0.1, 1), -rng.uniform(0.1, 1),
                             rng.normal()])
        return 2.0 * rng.normal(size=3)
    if kind == 'psd':
        M = rng.normal(size=(3, 3))
        M = {'generic': M + M.T, 'interior': M @ M.T + np.eye(3),
             'polar': -(M @ M.T) - np.eye(3)}.get(case)
        if M is None:
            Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            M = Q @ np.diag([1.5, 1.5, -0.7]) @ Q.T
        r, c, sc = (np.asarray(a) for a in
                    conic_diff.svec_indices(3))
        return M[r, c] * sc
    a = LAYOUT['pows'][0]
    if case == 'interior':
        x1, x2 = rng.uniform(0.5, 2.0, 2)
        return np.array([x1, x2, 0.5 * x1 ** a * x2 ** (1 - a)])
    if case == 'polar':
        u, v = rng.uniform(0.5, 2.0, 2)
        w = 0.5 * (u / a) ** a * (v / (1 - a)) ** (1 - a)
        return -np.array([u, v, w])
    if case == 'face':
        return np.array([rng.normal(), rng.normal(), 0.0])
    return 2.0 * rng.normal(size=3)


@pytest.fixture(scope='module')
def jacobians():
    """u (rows, mc) with every case of every cone, and DP of both
    packages; the JAX one under jax.jit."""
    rng = np.random.default_rng(0)
    rows = [np.concatenate([_block(k, case, rng) for k in KINDS])
            for _ in range(4) for case in CASES]
    u = np.stack(rows)
    layout_ref = LayoutRef(**LAYOUT)
    DP_ref = jax.jit(lambda v: conic_diff_ref._proj_jacobian(
        v, layout_ref, jnp.float64))(jnp.asarray(u))
    DP = conic_diff.proj_jacobian(torch.tensor(u), ConeLayout(**LAYOUT))
    return u, np.asarray(DP_ref), DP.numpy()


@pytest.mark.parametrize('kind', KINDS)
def test_projection_jacobian_matches_reference(jacobians, kind):
    u, DP_ref, DP = jacobians
    blocks = {b[0]: (b[1], b[2]) for b in ConeLayout(**LAYOUT).blocks()}
    off, length = blocks[kind]
    sl = slice(off, off + length)
    err = np.abs(DP[:, sl, sl] - DP_ref[:, sl, sl]).max()
    assert err <= JAC_TOL, err
    assert np.all(np.isfinite(DP[:, sl, sl]))
    # the interior of the cone gives I and the polar's 0 (the projection is
    # the identity there and zero there): selected exactly, except PSD's,
    # which Daleckii-Krein's products give to roundoff
    for i, case in enumerate(CASES * 4):
        if kind != 'nonneg' and case in ('interior', 'polar'):
            want = np.eye(length) if case == 'interior' else 0.0
            np.testing.assert_allclose(DP[i, sl, sl], want, rtol=0,
                                       atol=1e-14 if kind == 'psd' else 0)
    # and the block agrees with central differences of the projection where
    # it is smooth (the generic points)
    lay = ConeLayout(**{k: v for k, v in LAYOUT.items()
                        if k == {'nonneg': 'n_nonneg', 'soc': 'socs',
                                 'exp': 'n_exp', 'psd': 'psds',
                                 'pow': 'pows'}[kind]})
    for i in range(0, len(u), len(CASES)):
        v, h = u[i, sl], 1e-6
        fd = np.stack([(project_cone_np(v + h * e, lay)
                        - project_cone_np(v - h * e, lay)) / (2 * h)
                       for e in np.eye(length)], axis=1)
        assert np.abs(DP[i, sl, sl] - fd).max() <= 1e-4


def test_psd_jacobian_invariant_to_eigenvectors():
    """Daleckii-Krein reads each eigenvector twice: flipped signs, and
    another basis of a repeated eigenvalue's eigenspace (the freedom
    LAPACK and cuSOLVER use differently), give the same DP."""
    rng = np.random.default_rng(3)
    Q = torch.tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0])[None]
    lam = torch.tensor([[-0.7, 1.5, 1.5]], dtype=torch.float64)
    DP = conic_diff.daleckii_krein(lam, Q, 3)
    signs = torch.tensor([-1.0, 1.0, -1.0], dtype=torch.float64)
    c, s = np.cos(0.4), np.sin(0.4)
    R = torch.tensor([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=torch.float64)
    for Q2 in (Q * signs, Q @ R):
        err = (conic_diff.daleckii_krein(lam, Q2, 3) - DP).abs().max()
        assert float(err) <= 1e-14, float(err)


def _adp_pair():
    pt = types.ModuleType('problems_torch')
    src = open(problems_ref.__file__).read()
    exec(compile(src, problems_ref.__file__, 'exec'), pt.__dict__)
    pt.ct = ct
    return (problems_ref.assign_ADP(problems_ref.ADP_problem()),
            pt.assign_ADP(pt.ADP_problem()))


def _sdp(pkg, Aval=None):
    """tests/test_conic_diff_exotic.py:79-108: min t s.t. t I >= A."""
    t = pkg.Variable(name='t')
    A = pkg.Parameter((3, 3), name='A')
    A.value = np.eye(3) if Aval is None else Aval
    return pkg.Problem(pkg.Minimize(t), [pkg.multiply(t, np.eye(3)) >> A]), A


def _exp(pkg):
    """tests/test_conic_diff_exotic.py:135-170's family."""
    x = pkg.Variable(2, name='x')
    p = pkg.Parameter(2, name='p')
    p.value = np.array([0.5, -0.3])
    return pkg.Problem(pkg.Minimize(pkg.sum(pkg.exp(x - p))
                                    + pkg.sum_squares(x))), x, p


def _family_batch(name):
    """(reference problem, port problem, theta (B, p)) of a family."""
    if name == 'ADP':
        ref, port = _adp_pair()
        fam = canonicalize(port)
        base = fam.pack_theta(params=port.parameters())
        fi = [pi for pi in fam.param_info if pi.name == 'f'][0]
        theta = np.tile(base, (B, 1))
        theta[1:, fi.offset:fi.offset + fi.flat_size] *= \
            np.random.default_rng(1).uniform(0.5, 1.5, (B - 1, fi.flat_size))
        return ref, port, theta
    if name == 'SDP':
        (ref, _), (port, A) = _sdp(ct_ref), _sdp(ct)
        fam = canonicalize(port)
        rng = np.random.default_rng(2)
        thetas = []
        for _ in range(B):
            M = rng.normal(size=(3, 3))
            A.value = 0.5 * (M + M.T)
            thetas.append(fam.pack_theta(params=port.parameters()))
        return ref, port, np.stack(thetas)
    (ref, _, _), (port, _, _) = _exp(ct_ref), _exp(ct)
    fam = canonicalize(port)
    return ref, port, fam.pack_theta(params=port.parameters())[None]


def _settings(name):
    """(reference settings, port settings) of the family's forward."""
    if name == 'ADP':
        return IPMSettingsRef(**IPM_KW), IPMSettings(**IPM_KW)
    kw = SDP_KW if name == 'SDP' else EXP_KW
    return ConicSettingsRef(**kw), ConicADMMSettings(**kw)


def _seeds(fam, rows):
    rng = np.random.default_rng(5)
    return dict(x=rng.standard_normal((rows, fam.n)),
                y=rng.standard_normal((rows, fam.m)),
                obj=rng.standard_normal(rows))


def _user_seed(fam, rows):
    """cpg_gradient's seed: ones on the user variables, nothing on obj."""
    gx = np.zeros((rows, fam.n))
    for vi in fam.user_vars:
        gx[:, vi.offset:vi.offset + vi.size] = 1.0
    return dict(x=gx, y=np.zeros((rows, fam.m)), obj=np.zeros(rows))


@pytest.fixture(scope='module')
def reference():
    """The JAX package's forward and dtheta for two seeds per family (the
    random one and cpg_gradient's), one jitted program per family."""
    out = {}
    for name in ('ADP', 'SDP', 'exp'):
        ref, _, theta = _family_batch(name)
        fam = canon_ref(ref)
        solve = conic_diff_ref.make_conic_diff_solve(
            JaxFamily.from_family(fam), _settings(name)[0])
        seeds = [{k: jnp.asarray(v) for k, v in s.items()}
                 for s in (_seeds(fam, len(theta)),
                           _user_seed(fam, len(theta)))]

        def program(th):
            o, vjp = jax.vjp(solve, th)
            return o, [vjp(s)[0] for s in seeds]

        out[name] = jax.jit(program)(jnp.asarray(theta))
    return out


def _port_solve(name, port):
    tf = TorchFamily.from_family(canonicalize(port), device='cpu')
    return conic_diff.make_conic_diff_solve(tf, _settings(name)[1])


def _assert_dtheta(got, ref):
    ref = np.asarray(ref)
    scale = np.maximum(1.0, np.abs(ref).max(axis=1, keepdims=True))
    err = float(np.max(np.abs(got - ref) / scale))
    assert err <= DTHETA_TOL, err


@pytest.mark.parametrize('name', ['ADP', 'SDP'])
def test_dtheta_matches_reference_vjp(reference, name):
    """ADP through the IPM forward and the max-eigenvalue SDP through the
    conic ADMM, at settings where both packages run the same iterations."""
    _, port, theta = _family_batch(name)
    fam = canonicalize(port)
    out_ref, (dtheta_ref, _) = reference[name]
    g = _seeds(fam, B)
    th = torch.tensor(theta, requires_grad=True)
    out = _port_solve(name, port)(th)
    sum((out[k] * torch.tensor(g[k])).sum() for k in g).backward()
    for k in ('x', 'y', 'obj'):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(out_ref[k]), rtol=0,
                                   atol=X_TOL, err_msg=k)
    _assert_dtheta(th.grad.numpy(), dtheta_ref)
    if name == 'SDP':
        # d lambda_max / dA = v v' at the top eigenvector (a simple one here)
        t_off = [vi.offset for vi in fam.var_info if vi.name == 't'][0]
        th.grad = None
        _port_solve(name, port)(th)['x'][:, t_off].sum().backward()
        for i in range(B):
            dA = fam.unpack_theta_grad(th.grad[i].numpy())['A']
            A = fam.unpack_theta_grad(theta[i])['A']
            v = np.linalg.eigh(A)[1][:, -1]
            assert np.abs(dA - np.outer(v, v)).max() <= 1e-5


def test_torch_layer_routes_cone_families():
    """TorchLayer takes a cone family to the conic differentiation (the
    reference's JaxLayer route): ADP's dtheta through the layer is the
    autograd function's."""
    _, port, theta = _family_batch('ADP')
    u = port.var_dict['u']
    layer = ct.TorchLayer(port, parameters=list(port.parameters()),
                          variables=[u], settings=IPMSettings(**IPM_KW),
                          device='cpu')
    assert layer._conic and not layer._banded
    fam = canonicalize(port)
    fi = [pi for pi in fam.param_info if pi.name == 'f'][0]
    tensors = [torch.tensor(np.asarray(p.value, dtype=float))
               for p in port.parameters()]
    k = [p.name() for p in port.parameters()].index('f')
    tensors[k] = torch.tensor(theta[:, fi.offset:fi.offset + fi.flat_size],
                              requires_grad=True)
    (uval,) = layer(*tensors)
    uval.sum().backward()
    th = torch.tensor(theta, requires_grad=True)
    x = _port_solve('ADP', port)(th)['x']
    vi = fam.user_vars[0]
    x[:, vi.offset:vi.offset + vi.size].sum().backward()
    np.testing.assert_allclose(
        tensors[k].grad.numpy(),
        th.grad[:, fi.offset:fi.offset + fi.flat_size].numpy(),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize('name', ['ADP', 'exp'])
def test_cpg_gradient_matches_reference(reference, name, tmp_path):
    """generate_code(gradient=True) -> cpg_gradient on an SOC family (the
    IPM) and an exp family (SCS): the seed ones on the user variables,
    against the JAX package's conic vjp of the same theta at the runtime's
    float64 settings."""
    _, port, theta = _family_batch(name)
    fam = canonicalize(port)
    mod = cpg.generate_code(port, code_dir=str(tmp_path / name),
                            gradient=True, device='cpu')
    assert mod._runtime.solver.solver_name == (
        'IPM' if name == 'ADP' else 'CONIC_ADMM')
    port.solve(method='CPG')
    assert port.status == 'optimal'
    for v in port.variables():
        v.gradient = np.ones(v.shape)
    grads = mod.cpg_gradient(port)
    dtheta_ref = np.asarray(reference[name][1][1][0])
    want = fam.unpack_theta_grad(dtheta_ref)
    assert set(grads) == set(want)
    scale = max(1.0, float(np.abs(dtheta_ref).max()))
    for k in want:
        err = float(np.abs(grads[k] - want[k]).max()) / scale
        assert err <= DTHETA_TOL, (k, err)


@pytest.mark.parametrize('family', ['PSD', 'pow'])
def test_cpg_gradient_on_every_engine(family, tmp_path):
    """gradient=True on a PSD and a power-cone family through both conic
    engines: the gradient is routed by the family (the conic
    differentiation re-solves the last theta), so the two packages give
    the same finite gradient; the SDP's is v v' at the top eigenvector."""
    rng = np.random.default_rng(4)
    if family == 'PSD':
        M = rng.normal(size=(3, 3))
        prob, A = _sdp(ct, 0.5 * (M + M.T))
        target = prob.variables()[0]
    else:
        x = ct.Variable(3, name='x')
        c = ct.Parameter(3, name='c')
        c.value = np.array([1.0, 2.0, -0.5])
        prob = ct.Problem(ct.Minimize(ct.sum_squares(x - c)),
                          [ct.PowCone3D(x[0], x[1], x[2], 0.3)])
        target = x
    grads = []
    for solver in ('SCS', 'IPM'):
        mod = cpg.generate_code(prob, code_dir=str(tmp_path / solver),
                                solver=solver, gradient=True, device='cpu')
        prob.solve(method='CPG')
        target.gradient = np.ones(target.shape)
        grads.append(mod.cpg_gradient(prob))
    for k in grads[0]:
        assert np.all(np.isfinite(grads[0][k]))
        np.testing.assert_array_equal(grads[0][k], grads[1][k])
    if family == 'PSD':
        v = np.linalg.eigh(A.value)[1][:, -1]
        assert np.abs(grads[0]['A'] - np.outer(v, v)).max() <= 1e-5
