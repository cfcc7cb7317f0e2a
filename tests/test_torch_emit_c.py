"""The embedded-C artifact of cvxpygen_tpu_torch (codegen/emit_c.py and the
LICENSE, c/ and README.html of cpg.generate_code) against the JAX
package's: each family is built in both packages' modeling layers from
the same seed and generated by both, and the c/ files must match byte for
byte (PSD families get none in either); one c/ project is built and run."""
import os
import re
import subprocess

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import cvxpygen_tpu as ct_ref
import cvxpygen_tpu_torch as ct
import problems as problems_ref
from cvxpygen_tpu import cpg as cpg_ref
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.solvers.oracle import solve_family_numpy
from cvxpygen_tpu_torch import cpg
from test_torch_banded import assign_charging, charging_problem
from test_torch_explicit import _regression
from test_torch_solver import _problems_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the emitted files of a solver family (an explicit family emits
# cpg_explicit.c and the Makefile)
C_FILES = ('cpg_core.cpp', 'cpg_core.h', 'cpg_family.h', 'cpg_data.c',
           'cpg_example.c', 'Makefile')
# the C example's objective against the float64 oracle (tests/
# test_native.py::test_standalone_c_artifact)
OBJ_TOL = 1e-2


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


def _entropy(pkg, n=6, seed=5):
    """tests/test_native.py::_entropy_problem, the exp-cone family."""
    rng = np.random.default_rng(seed)
    x = pkg.Variable(n, name='x')
    c = pkg.Parameter(n, name='c')
    prob = pkg.Problem(pkg.Maximize(c @ x + pkg.sum(pkg.entr(x))),
                       [pkg.sum(x) == 1.0])
    c.value = rng.normal(size=n)
    return prob


def _psd(pkg, s=3, seed=0):
    """tests/test_psd.py::test_psd_variable_projection's family."""
    X = pkg.Variable((s, s), name='X', PSD=True)
    A = pkg.Parameter((s, s), name='A')
    M = np.random.default_rng(seed).standard_normal((s, s))
    A.value = M + M.T
    return pkg.Problem(pkg.Minimize(pkg.sum_squares(X - A)), [])


def _family(pkg, case):
    """(problem, generate_code's solver) of ``case`` in ``pkg``."""
    pt = problems_ref if pkg is ct_ref else _problems_torch()
    if case in ('nonneg_LS', 'MPC', 'ADP'):
        make, assign = pt.ALL[case]
        return assign(make()), None
    if case == 'exp':
        return _entropy(pkg), None
    if case == 'explicit':
        return _regression(pkg)[0], 'explicit'
    if case == 'charging':
        # T=288 (examples/embedded_c.py:67): above the dense-emission
        # threshold, so the sparse COO + RCM-banded emission
        return assign_charging(charging_problem(pkg, T=288), T=288), 'OSQP'
    return _psd(pkg), None


CASES = ('nonneg_LS', 'MPC', 'ADP', 'exp', 'explicit', 'charging', 'psd')


@pytest.fixture(scope='module')
def packages(tmp_path_factory):
    """Each case generated by both packages once for the module:
    {case: (reference package dir, port package dir)}."""
    out = {}
    for case in CASES:
        dirs = []
        for pkg, gen, kw in ((ct_ref, cpg_ref, {}),
                             (ct, cpg, dict(device='cpu'))):
            prob, solver = _family(pkg, case)
            d = str(tmp_path_factory.mktemp(f'{case}_{pkg.__name__}'))
            gen.generate_code(prob, code_dir=d, solver=solver,
                              wrapper=False, **kw)
            dirs.append(d)
        out[case] = tuple(dirs)
    return out


def core_lines_equal(a, b):
    """The two packages' cpg_core.cpp agree line for line, apart from at
    most one line that is a comment in both (the port's header comment
    names no path outside the project)."""
    la, lb = a.decode().split('\n'), b.decode().split('\n')
    if len(la) != len(lb):
        return False
    diff = [(x, y) for x, y in zip(la, lb) if x != y]
    return len(diff) <= 1 and all(x.startswith('//') and y.startswith('//')
                                  for x, y in diff)


def test_core_source_matches_reference():
    """native/cpg_core.cpp is the JAX package's core: every line of code
    identical, so both packages' artifacts compute the same thing."""
    with open(os.path.join(REPO, 'cvxpygen_tpu', 'native',
                           'cpg_core.cpp'), 'rb') as f:
        ref = f.read()
    with open(os.path.join(REPO, 'cvxpygen_tpu_torch', 'native',
                           'cpg_core.cpp'), 'rb') as f:
        port = f.read()
    assert core_lines_equal(ref, port)


@pytest.mark.parametrize('case', CASES)
def test_c_files_match_reference(packages, case):
    """The port's c/ is the JAX package's, byte for byte (cpg_core.cpp
    line for line, as above); PSD families get no c/ in either."""
    ref, port = (os.path.join(d, 'c') for d in packages[case])
    if case == 'psd':
        assert not os.path.exists(ref) and not os.path.exists(port)
        return
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names
    expect = (['Makefile', 'cpg_explicit.c'] if case == 'explicit'
              else sorted(C_FILES))
    assert names == expect
    for name in names:
        with open(os.path.join(ref, name), 'rb') as f:
            a = f.read()
        with open(os.path.join(port, name), 'rb') as f:
            b = f.read()
        if name == 'cpg_core.cpp':
            assert core_lines_equal(a, b), name
        else:
            assert a == b, (case, name)
    if case == 'charging':
        src = open(os.path.join(port, 'cpg_data.c')).read()
        assert 'cpg_native_set_scatter' in src and 'cpg_native_set_perm' in src


def test_readme_and_license(packages):
    """tests/test_codegen.py::test_readme_artifact on the port's MPC
    package, plus the LICENSE copy and c/ in the file tree and the API
    table."""
    d = packages['MPC'][1]
    html = open(os.path.join(d, 'README.html')).read()
    for pname in ['Psqrt', 'Qsqrt', 'Rsqrt', 'A', 'B', 'x_init']:
        assert pname in html
    assert 'U' in html and 'X' in html
    tree = html.split('<h2>Generated files</h2>')[1].split('</pre>')[0]
    assert '\nc/\n' in tree and '  cpg_core.cpp' in tree
    for entry in ('_runtime.solver.solve_batch(theta)', 'TorchLayer',
                  'device=', 'dtype=', 'c/ (make && ./cpg_example)'):
        assert entry in html, entry
    assert 'device: cpu' in html
    with open(os.path.join(REPO, 'LICENSE'), 'rb') as f:
        lic = f.read()
    with open(os.path.join(d, 'LICENSE'), 'rb') as f:
        assert f.read() == lic
    # a PSD package has neither c/ nor its API row
    html = open(os.path.join(packages['psd'][1], 'README.html')).read()
    assert 'cpg_example' not in html


def test_c_example_builds_and_solves(packages):
    """`make && ./cpg_example` on the port's nonneg_LS package: status 1
    and the objective within OBJ_TOL of the JAX package's float64
    oracle."""
    cdir = os.path.join(packages['nonneg_LS'][1], 'c')
    subprocess.run(['make'], cwd=cdir, check=True, capture_output=True)
    out = subprocess.run(['./cpg_example'], cwd=cdir, check=True,
                         capture_output=True, text=True).stdout
    assert 'status = 1' in out, out
    obj_c = float(re.search(r'obj = ([-\d.e+]+)', out).group(1))
    prob, _ = _family(ct_ref, 'nonneg_LS')
    fam = canon_ref(prob)
    theta = fam.pack_theta(params=prob.parameters())
    res, _ = solve_family_numpy(fam, theta)
    obj_ref = res.obj + float(np.asarray(
        fam.d_map @ np.concatenate([theta, [1.0]])).ravel()[0])
    assert abs(obj_c - obj_ref) < OBJ_TOL * max(1.0, abs(obj_ref)), \
        (obj_c, obj_ref)
