"""The explicit solver of cvxpygen_tpu_torch (solvers/explicit.py's copied
region enumeration and torch evaluator, codegen/runtime.py's
ExplicitRuntime, generate_code(solver='explicit')) against the JAX
package's, on the families of tests/test_explicit.py, float64 on the CPU
(the evaluator itself is float32 in both)."""
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
from cvxpygen_tpu import cpg as cpg_ref
from cvxpygen_tpu.solvers.explicit import explicit_evaluate as evaluate_ref
from cvxpygen_tpu_torch import cpg
from cvxpygen_tpu_torch.codegen.runtime import ExplicitRuntime
from cvxpygen_tpu_torch.solvers import explicit as explicit_mod
from cvxpygen_tpu_torch.solvers.explicit import (ExplicitError,
                                                 explicit_evaluate)

# the evaluator's x against the JAX package's on the same table (float32
# products of both; ties between regions aside)
X_TOL = 1e-6
# solve(method='CPG') against the float64 oracle (tests/test_explicit.py)
ORACLE_TOL = 1e-5
CASES = {
    'regression': dict(),
    'power': dict(),
    'dual': dict(dual=True),
    'stored': dict(stored=True),
    'fp16': dict(fp16=True),
}


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


def _regression(pkg, q=10, d=5, seed=1):
    """tests/test_explicit.py:12-19."""
    np.random.seed(seed)
    A = np.random.randn(q, d)
    x = pkg.Variable(d, name='x')
    b = pkg.Parameter(q, name='b')
    constr = [pkg.diff(x) >= 0, pkg.Constant(-np.ones(q)) <= b, b <= 1]
    return pkg.Problem(pkg.Minimize(pkg.sum_squares(A @ x - b)), constr), \
        x, b


def _power(pkg):
    """tests/test_explicit.py:39-75, the power-scheduling QP."""
    C, D, h, Q = 1, 1, 0.05, 1
    qtar, alpha, beta = 0.5, 0.1, 0.1
    g = pkg.Variable(name='g')
    s = pkg.Variable(name='s')
    b = pkg.Variable(name='b')
    qplus = pkg.Variable(name='qplus')
    L = pkg.Parameter(name='L')
    S = pkg.Parameter(name='S')
    P = pkg.Parameter(name='P')
    q = pkg.Parameter(name='q')
    obj = P * g * h + alpha * (qplus - qtar) ** 2 + beta * b ** 2
    constr = [
        L == s + b + g,
        pkg.Constant(0) <= s, s <= S, pkg.Constant(-C) <= b, b <= D, g >= 0,
        qplus == q - h * b, pkg.Constant(0) <= qplus, qplus <= Q,
        pkg.Constant(0) <= L, L <= 1,
        pkg.Constant(0) <= S, S <= 0.5,
        pkg.Constant(1) <= P, P <= 2,
        pkg.Constant(0) <= q, q <= Q,
    ]
    return pkg.Problem(pkg.Minimize(obj), constr)


def _problem(pkg, case):
    """(problem, its solver_opts, the values to solve at)."""
    if case == 'power':
        prob = _power(pkg)
        rng = np.random.default_rng(2)
        vals = dict(L=rng.random(), S=0.5 * rng.random(), P=1 + rng.random(),
                    q=rng.random())
        return prob, {}, vals
    small = case in ('dual', 'stored')
    prob, x, b = _regression(pkg, *((4, 3) if small else (6, 4) if
                                    case == 'fp16' else (10, 5)))
    opts = {k: v for k, v in CASES[case].items() if k != 'stored'}
    if case == 'stored':
        opts['stored_vars'] = [x[[0, 2]]]
    n_b = b.shape[0]
    vals = dict(b=-0.5 + np.random.default_rng(3).random(n_b))
    return prob, opts, vals


@pytest.fixture(scope='module')
def packages(tmp_path_factory):
    """Each case generated by both packages (the region enumeration runs
    at generate time), once for the module."""
    out = {}
    for case in CASES:
        mods = []
        for pkg, gen in ((ct_ref, cpg_ref), (ct, cpg)):
            prob, opts, _ = _problem(pkg, case)
            kw = {} if pkg is ct_ref else dict(device='cpu')
            d = tmp_path_factory.mktemp(f'{case}_{pkg.__name__}')
            mods.append((gen.generate_code(prob, code_dir=str(d),
                                           solver='explicit', gradient=True,
                                           solver_opts=opts, **kw), prob))
        out[case] = mods
    return out


@pytest.mark.parametrize('case', list(CASES))
def test_explicit_data_matches_reference(packages, case):
    """The copied enumeration gives the JAX package's table bit for bit."""
    (ref, _), (port, _) = packages[case]
    a, b = ref._runtime.data, port._runtime.data
    assert isinstance(port._runtime, ExplicitRuntime)
    assert a.n_regions == b.n_regions and a.coverage == b.coverage
    for k in ('FB', 'TEST', 'DUAL', 'th_sel', 'th_lb', 'th_ub', 'store_idx'):
        va, vb = getattr(a, k), getattr(b, k)
        if va is None:
            assert vb is None, k
            continue
        assert va.dtype == vb.dtype, k
        np.testing.assert_array_equal(vb, va, err_msg=k)


@pytest.mark.parametrize('case', ['regression', 'power', 'dual'])
def test_evaluator_matches_reference(packages, case, monkeypatch):
    """explicit_evaluate on 512 parameter points spread over (and a little
    beyond) the domain box: x (and y) within X_TOL of the JAX evaluator's
    and the same region wherever the winning slack clears the runner-up's
    by more than float32 roundoff."""
    (ref, _), (port, _) = packages[case]
    data = port._runtime.data
    rng = np.random.default_rng(4)
    p = ref._runtime.family.p
    lo, hi = data.th_lb, data.th_ub
    theta = np.zeros((512, p))
    theta[:, data.th_sel] = lo + (hi - lo) * rng.uniform(-0.05, 1.05,
                                                         (512, len(lo)))
    want_dual = case == 'dual'
    x_r, y_r, reg_r = evaluate_ref(ref._runtime.data, theta,
                                   want_dual=want_dual)
    x, y, reg = explicit_evaluate(data, torch.tensor(theta),
                                  want_dual=want_dual)
    assert x.dtype == torch.float32 and x.device.type == 'cpu'
    np.testing.assert_allclose(x.numpy(), np.asarray(x_r), rtol=0,
                               atol=X_TOL)
    if want_dual:
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=0,
                                   atol=X_TOL)
    th = np.clip(theta[:, data.th_sel], lo, hi)
    tt = np.concatenate([th, np.ones((512, 1))], axis=1)
    mslack = np.min(np.einsum('rtp,bp->brt', data.TEST.astype(float), tt),
                    axis=2)
    top2 = np.sort(mslack, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(reg.numpy()[clear], np.asarray(reg_r)[clear])
    # a chunked evaluation (the card's rule for large batches) changes
    # nothing
    monkeypatch.setattr(explicit_mod, '_SLACK_FLOATS',
                        7 * data.TEST.shape[0] * data.TEST.shape[1])
    x2, _, reg2 = explicit_evaluate(data, torch.tensor(theta))
    assert torch.equal(x2, x) and torch.equal(reg2, reg)


def test_evaluator_device_rule(packages, monkeypatch):
    """A theta that is not a tensor, with no device given, follows the
    port's device rule: with no card it raises resolve_device's error;
    device='cpu' gives the evaluation of the same theta as a CPU tensor,
    bit for bit."""
    (_, _), (port, _) = packages['regression']
    data = port._runtime.data
    lo, hi = data.th_lb, data.th_ub
    theta = np.zeros((64, port._runtime.family.p))
    theta[:, data.th_sel] = lo + (hi - lo) * np.random.default_rng(
        5).random((64, len(lo)))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        explicit_evaluate(data, theta)
    x, _, reg = explicit_evaluate(data, theta, device='cpu')
    x_t, _, reg_t = explicit_evaluate(data, torch.tensor(theta))
    assert x.device.type == 'cpu'
    assert torch.equal(x, x_t) and torch.equal(reg, reg_t)


@pytest.mark.parametrize('case', list(CASES))
def test_cpg_solve_matches_reference(packages, case):
    """solve(method='CPG') through both packages' explicit runtimes, and
    the port's against the float64 oracle; duals where stored; the region
    feedback gradient (the JAX package's host transpose)."""
    (ref, prob_r), (port, prob) = packages[case]
    _, _, vals = _problem(ct, case)
    results = []
    for mod, pr in ((ref, prob_r), (port, prob)):
        for name, v in vals.items():
            pr.param_dict[name].value = v
        pr.solve()
        x_oracle = [np.asarray(v.value, dtype=float).copy()
                    for v in pr.variables()]
        d_oracle = np.asarray(pr.constraints[0].dual_value, dtype=float)
        obj = pr.solve(method='CPG')
        xs = [np.asarray(v.value, dtype=float).copy()
              for v in pr.variables()]
        for v in pr.variables():
            v.gradient = np.ones(v.shape)
        grads = mod.cpg_gradient(pr)
        results.append(dict(obj=obj, xs=xs, grads=grads,
                            dual=pr.constraints[0].dual_value))
    ref_res, port_res = results
    # fp16 storage: the reference test's bar (tests/test_explicit.py:205)
    rtol, atol = (2e-3, 2e-3) if case == 'fp16' else (0, ORACLE_TOL)
    stored = port._runtime.data.store_idx
    for got, want in zip(port_res['xs'], x_oracle):
        if case == 'stored':
            got, want = got[[0, 2]], want[[0, 2]]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert len(stored) == (2 if case == 'stored' else port._runtime.family.n)
    for got, want in zip(port_res['xs'], ref_res['xs']):
        np.testing.assert_allclose(got, want, rtol=0, atol=X_TOL)
    assert abs(port_res['obj'] - ref_res['obj']) <= X_TOL * max(
        1.0, abs(ref_res['obj']))
    if case == 'dual':
        np.testing.assert_allclose(np.asarray(port_res['dual']), d_oracle,
                                   rtol=0, atol=1e-4)
    for k in ref_res['grads']:
        np.testing.assert_allclose(port_res['grads'][k],
                                   ref_res['grads'][k], rtol=0, atol=X_TOL)


def test_domain_and_caps(tmp_path, monkeypatch):
    """tests/test_explicit.py's options: an unbounded parameter raises
    naming it, theta_box opts into a box, max_regions and max_floats cap
    the table with a warning, and a package without a card and without a
    device raises."""
    x = ct.Variable(2, name='x')
    b = ct.Parameter(2, name='bfree')
    b.value = np.zeros(2)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x - b)), [x >= 0])
    with pytest.raises(ExplicitError, match='bfree'):
        cpg.generate_code(prob, code_dir=str(tmp_path / 'u'),
                          solver='explicit', device='cpu')
    cpg.generate_code(prob, code_dir=str(tmp_path / 'u2'), solver='explicit',
                      solver_opts={'theta_box': 1.5}, device='cpu')
    b.value = np.array([0.7, -0.9])
    prob.solve(method='CPG')
    np.testing.assert_allclose(x.value, np.maximum(b.value, 0.0), atol=1e-5)
    reg, _, _ = _regression(ct, 6, 4)
    for opts, word in (({'max_regions': 2}, 'max_regions'),
                       ({'max_floats': 200.0}, 'max_floats')):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            mod = cpg.generate_code(reg, code_dir=str(tmp_path / word),
                                    solver='explicit', solver_opts=opts,
                                    device='cpu')
        assert word in ' '.join(str(m.message) for m in w)
        assert mod._runtime.data.n_regions <= 10
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cpg.generate_code(reg, code_dir=str(tmp_path / 'nocard'),
                          solver='explicit')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExplicitRuntime.from_saved(mod._runtime.family, mod._runtime.data)
