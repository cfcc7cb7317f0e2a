"""Public code-generation API (parity: reference cvxpygen/cpg.py:17-30).

``generate_code(problem, code_dir, solver, ...)`` compiles the problem
family offline and writes a Python package directory whose ``cpg_solver``
module mirrors the reference's generated wrapper
(templates/cpg_solver.py.jinja2): ``cpg_solve``, ``forward``, ``backward``,
``cpg_gradient``.  With ``wrapper=True`` it is imported at once and
``problem.register_solve('CPG', cpg_solve)`` is called (reference
compiler.py:33-40).

The artifact is the pickled Family (the parametric canonicalization maps --
the reference's cpg_workspace.c as arrays); the torch solve path is built
when the package is imported.  The port generates ADMM packages for
QP-form families (dense, or block-banded with ``solver='BANDED'``, which
ADMM also picks for banded families with n >= 512) and interior-point
packages (``'IPM'`` and the reference's ECOS/CLARABEL/QOCO aliases) for any
family; the embedded-C artifact, the explicit solver, the conic ADMM
engine (SCS) and gradients arrive with later slices (ROADMAP.md).
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import pickle
import sys

from .canon.canonicalizer import canonicalize
from .runtime.solver import IPM_SOLVERS

_QP_SOLVERS = ('ADMM', 'OSQP', 'BANDED', 'ADMM_BANDED')


def default_solver(fam):
    """The reference's default engine for a canonicalized family
    (cvxpygen_tpu/cpg.py:48-55): exp/PSD/pow cones -> SCS (the conic ADMM),
    SOC-only -> IPM, QP-form -> ADMM."""
    if fam.n_exp or fam.psd_dims or fam.pow_alphas:
        return 'SCS'
    if fam.soc_dims:
        return 'IPM'
    return 'ADMM'


def generate_code(problem, code_dir='cpg_code', solver=None, solver_opts=None,
                  enable_settings=None, prefix='', gradient=False,
                  wrapper=True, dtype=None, device=None):
    """Compile ``problem`` into a solver package at ``code_dir``.

    Arguments mirror the reference (README.md:85-93).  ``device`` is where
    the generated solver runs: CUDA when left unset (raising if there is no
    card), or e.g. ``'cpu'``.  ``dtype`` (``'float32'``/``'float64'``)
    defaults to float32 on CUDA and float64 on the CPU."""
    fam = canonicalize(problem)
    has_cones = bool(fam.soc_dims or fam.n_exp or fam.psd_dims
                     or fam.pow_alphas)
    if solver is None:
        solver = default_solver(fam)
    if solver.lower() == 'explicit':
        raise NotImplementedError('the explicit solver is not ported yet: '
                                  'ROADMAP.md queue 1 item 10')
    if solver.upper() in ('SCS', 'CONIC_ADMM'):
        raise NotImplementedError('the conic ADMM engine (SCS) is not '
                                  'ported yet: ROADMAP.md queue 1 item 8')
    if solver.upper() not in _QP_SOLVERS + IPM_SOLVERS:
        raise ValueError(f'unsupported solver {solver!r}')
    if has_cones and solver.upper() in _QP_SOLVERS:
        raise ValueError(f'{solver}: QP-form solver but family has cones')
    if gradient:
        raise NotImplementedError(
            'gradient=True needs the QP differentiation, which is not '
            'ported yet: ROADMAP.md queue 1 item 6')

    os.makedirs(code_dir, exist_ok=True)
    with open(os.path.join(code_dir, 'family.pkl'), 'wb') as f:
        pickle.dump(fam, f)
    cfg = dict(solver=solver.upper(), prefix=prefix, gradient=gradient,
               enable_settings=list(enable_settings or []),
               solver_opts={k: v for k, v in dict(solver_opts or {}).items()
                            if isinstance(v, (int, float, str, bool))},
               dtype=None if dtype is None else str(dtype).replace(
                   'torch.', ''),
               device=None if device is None else str(device))
    with open(os.path.join(code_dir, 'cpg_solver.py'), 'w') as f:
        f.write(_SOLVER_TEMPLATE % dict(cfg=json.dumps(cfg)))
    with open(os.path.join(code_dir, '__init__.py'), 'w') as f:
        f.write('')
    print(f'CVXPYgen-torch: generated solver package at {code_dir} '
          f'(solver={cfg["solver"]}, n={fam.n}, m={fam.m}, p={fam.p})')

    if wrapper:
        mod = _import_generated(code_dir)
        problem.register_solve('CPG', mod.cpg_solve)
        return mod
    return None


def _import_generated(code_dir):
    """Load the generated cpg_solver module from its file, under a
    path-unique module name (several generated packages may share a
    basename)."""
    path = os.path.join(os.path.abspath(code_dir), 'cpg_solver.py')
    tag = hashlib.sha1(path.encode()).hexdigest()[:10]
    name = (f'cpg_torch_generated_{os.path.basename(os.path.normpath(code_dir))}'
            f'_{tag}')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_SOLVER_TEMPLATE = '''"""Generated by cvxpygen_tpu_torch.cpg.generate_code (parity artifact of
the reference's generated cpg_solver.py).  Do not edit."""
import json
import os
import pickle

import torch

from cvxpygen_tpu_torch.codegen.runtime import CpgRuntime

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, 'family.pkl'), 'rb') as _f:
    family = pickle.load(_f)
_CFG = json.loads(%(cfg)r)

_runtime = CpgRuntime(
    family, solver_name=_CFG['solver'], prefix=_CFG['prefix'],
    gradient=_CFG['gradient'], enable_settings=_CFG['enable_settings'],
    solver_opts=_CFG.get('solver_opts'),
    dtype=getattr(torch, _CFG['dtype']) if _CFG.get('dtype') else None,
    device=_CFG.get('device'))


def cpg_solve(prob, updated_params=None, **kwargs):
    return _runtime.cpg_solve(prob, updated_params=updated_params, **kwargs)


def cpg_gradient(prob):
    return _runtime.cpg_gradient(prob)


def forward(prob, updated_params=None, **kwargs):
    return _runtime.forward(prob, updated_params=updated_params, **kwargs)


def backward(prob, **kwargs):
    return _runtime.backward(prob, **kwargs)
'''
