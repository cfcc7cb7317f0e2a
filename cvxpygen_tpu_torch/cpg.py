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
ADMM also picks for banded families with n >= 512), conic ADMM packages
(``'SCS'``/``'CONIC_ADMM'``, the default for exp/PSD/pow families),
interior-point packages (``'IPM'`` and the reference's ECOS/CLARABEL/QOCO
aliases) for any family, and explicit packages (``'explicit'``: the region
table, enumerated here and pickled as ``explicit.pkl``).  ``gradient=True``
differentiates any family on any engine.  The embedded-C artifact, the
README.html and the LICENSE copy arrive with a later slice (ROADMAP.md
queue 1 item 12).
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import pickle
import sys

from .canon.canonicalizer import canonicalize
from .runtime.solver import CONIC_ADMM_SOLVERS, IPM_SOLVERS

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
    defaults to float32 on CUDA and float64 on the CPU; the explicit
    solver evaluates its table in float32 whatever it says.
    ``solver='explicit'`` takes the reference's ``solver_opts``: ``dual``
    (store dual feedbacks: explicit level 2), ``max_regions``,
    ``max_floats``, ``fp16``, ``stored_vars`` and ``theta_box``."""
    fam = canonicalize(problem)
    has_cones = bool(fam.soc_dims or fam.n_exp or fam.psd_dims
                     or fam.pow_alphas)
    if solver is None:
        solver = default_solver(fam)
    opts = dict(solver_opts or {})
    explicit_level = 0
    if solver.lower() == 'explicit':
        # 'explicit' -> (PDAQP, 1|2) (reference generator.py:161-173)
        explicit_level = 2 if opts.get('dual') else 1
        solver = 'EXPLICIT'
    elif solver.upper() not in (_QP_SOLVERS + CONIC_ADMM_SOLVERS
                                + IPM_SOLVERS):
        raise ValueError(f'unsupported solver {solver!r}')
    if has_cones and solver.upper() in _QP_SOLVERS:
        raise ValueError(f'{solver}: QP-form solver but family has cones')

    os.makedirs(code_dir, exist_ok=True)
    with open(os.path.join(code_dir, 'family.pkl'), 'wb') as f:
        pickle.dump(fam, f)
    if explicit_level:
        # the region enumeration runs here, at generate time (the
        # reference's MPQP(...).solve(), pdaqp.py:201-219), and the table
        # is the persisted artifact
        from .codegen.runtime import ExplicitRuntime
        try:
            theta_ref = fam.pack_theta(params=problem.parameters())
        except ValueError:
            theta_ref = None
        rt = ExplicitRuntime(fam, explicit=explicit_level, prefix=prefix,
                             gradient=gradient, solver_opts=opts,
                             theta_ref=theta_ref, device=device)
        with open(os.path.join(code_dir, 'explicit.pkl'), 'wb') as f:
            pickle.dump(rt.data, f)
        print(f'CVXPYgen-torch explicit: {rt.data.n_regions} regions '
              f'(max_regions={opts.get("max_regions", 500)}, sampled '
              f'domain coverage {100 * rt.data.coverage:.1f}%)')
        opts.pop('stored_vars', None)  # consumed; not serializable
    cfg = dict(solver=solver.upper(), prefix=prefix, gradient=gradient,
               enable_settings=list(enable_settings or []),
               solver_opts={k: v for k, v in opts.items()
                            if isinstance(v, (int, float, str, bool))},
               explicit=explicit_level,
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

if _CFG.get('explicit'):
    from cvxpygen_tpu_torch.codegen.runtime import ExplicitRuntime
    with open(os.path.join(_HERE, 'explicit.pkl'), 'rb') as _f:
        _data = pickle.load(_f)
    _runtime = ExplicitRuntime.from_saved(
        family, _data, explicit=_CFG['explicit'], prefix=_CFG['prefix'],
        gradient=_CFG['gradient'], device=_CFG.get('device'))
else:
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
