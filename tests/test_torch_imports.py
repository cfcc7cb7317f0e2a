"""The port stands alone: cvxpygen_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and the port's settings keep the
reference's fields and defaults."""
import ast
import dataclasses
import os
import subprocess
import sys

import cvxpygen_tpu_torch
from cvxpygen_tpu.solvers.admm import ADMMSettings as SettingsRef
from cvxpygen_tpu.solvers.conic_admm import \
    ConicADMMSettings as ConicSettingsRef
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
from cvxpygen_tpu_torch.solvers.conic_admm import ConicADMMSettings

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.dirname(os.path.abspath(cvxpygen_tpu_torch.__file__))


def _port_sources():
    out = [os.path.join(_ROOT, 'chip_smoke.py')]
    for root, _, files in os.walk(_PKG):
        out += [os.path.join(root, f) for f in files if f.endswith('.py')]
    return out


def _forbidden(name):
    top = name.split('.')[0]
    return top == 'cvxpygen_tpu' or top.startswith('jax')


def test_no_jax_or_reference_imports():
    sources = _port_sources()
    assert len(sources) > 15
    bad = []
    for path in sources:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            bad += [f'{path}:{node.lineno} {n}' for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ('import sys, cvxpygen_tpu_torch, cvxpygen_tpu_torch.cpg, '
            'cvxpygen_tpu_torch.runtime.solver, '
            'cvxpygen_tpu_torch.ops.admm_shared_kernel, '
            'cvxpygen_tpu_torch.ops.admm_kernel, '
            'cvxpygen_tpu_torch.ops.admm_full_kernel, '
            'cvxpygen_tpu_torch.ops.block_tridiag, '
            'cvxpygen_tpu_torch.ops.banded_grouped, '
            'cvxpygen_tpu_torch.ops.banded_shared_kernel, '
            'cvxpygen_tpu_torch.solvers.admm_banded, '
            'cvxpygen_tpu_torch.solvers.admm_banded_shared, '
            'cvxpygen_tpu_torch.ops.ldl_batched, '
            'cvxpygen_tpu_torch.ops.ldl_kernel, '
            'cvxpygen_tpu_torch.solvers.ipm, '
            'cvxpygen_tpu_torch.solvers.ipm_cones, '
            'cvxpygen_tpu_torch.solvers.ipm_hsde, '
            'cvxpygen_tpu_torch.solvers.registry, '
            'cvxpygen_tpu_torch.ops.cones, '
            'cvxpygen_tpu_torch.solvers.conic_admm, '
            'cvxpygen_tpu_torch.solvers.conic_admm_shared, '
            'cvxpygen_tpu_torch.autodiff, '
            'cvxpygen_tpu_torch.autodiff.qp_diff, '
            'cvxpygen_tpu_torch.autodiff.torch_layer, '
            'cvxpygen_tpu_torch.codegen.runtime; '
            'print(sorted(m for m in sys.modules if m == "cvxpygen_tpu" '
            'or m.startswith("cvxpygen_tpu.") or m.split(".")[0] == "jax"))')
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=_ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == '[]'


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_settings_fields_and_defaults_match_reference():
    assert _fields(ADMMSettings) == _fields(SettingsRef)


def test_conic_admm_settings_fields_and_defaults_match_reference():
    assert _fields(ConicADMMSettings) == _fields(ConicSettingsRef)
