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
differentiates any family on any engine.  Every package also holds a
copy of the repository's LICENSE, a ``README.html`` (the problem summary,
the file tree and the API table) and, for every family but PSD ones and
large conic ones, ``c/``: a standalone C project (codegen/emit_c.py) that
builds with ``make`` and solves the family without Python.  These are
host work and come out the same whatever ``device`` says.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import pickle
import shutil
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
    # the problem's current values (None where a value is unset): the
    # explicit enumeration's reference point and the C example's theta
    try:
        theta0 = fam.pack_theta(params=problem.parameters())
    except ValueError:
        theta0 = None
    if explicit_level:
        # the region enumeration runs here, at generate time (the
        # reference's MPQP(...).solve(), pdaqp.py:201-219), and the table
        # is the persisted artifact
        from .codegen.runtime import ExplicitRuntime
        rt = ExplicitRuntime(fam, explicit=explicit_level, prefix=prefix,
                             gradient=gradient, solver_opts=opts,
                             theta_ref=theta0, device=device)
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
    # LICENSE in the artifact (the reference's writer emits one,
    # writer.py:77)
    lic_src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'LICENSE')
    if os.path.exists(lic_src):
        shutil.copy(lic_src, os.path.join(code_dir, 'LICENSE'))
    # the standalone C project (the reference's cpg_example.c + CMakeLists,
    # buildable without Python): the ADMM core for QP/SOC/exp/pow families,
    # the lookup-table evaluator for explicit ones; PSD families get none
    if explicit_level:
        from .codegen.emit_c import write_c_artifact_explicit
        c_dir = write_c_artifact_explicit(code_dir, fam, rt.data,
                                          theta_default=theta0)
    else:
        from .codegen.emit_c import write_c_artifact
        c_dir = write_c_artifact(code_dir, fam, theta_default=theta0)
    _write_readme(code_dir, fam, cfg, c_dir=c_dir)
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


def _write_readme(code_dir, fam, cfg, c_dir=None):
    """The package's README.html (the reference's templates/
    README.html.jinja2: problem summary tables, the file tree and the API
    table; reference utils.py:1455-1532), naming this package's entry
    points."""
    params_rows = ''.join(
        f'<tr><td>{pi.name}</td><td>{pi.shape}</td><td>{pi.flat_size}</td></tr>'
        for pi in fam.param_info)
    vars_rows = ''.join(
        f'<tr><td>{vi.name}</td><td>{vi.shape}</td><td>{vi.size}</td></tr>'
        for vi in fam.user_vars)

    tree_lines = []
    base = os.path.abspath(code_dir)
    for root, dirs, files in os.walk(base):
        dirs.sort()
        rel = os.path.relpath(root, base)
        depth = 0 if rel == '.' else rel.count(os.sep) + 1
        if rel != '.':
            tree_lines.append('  ' * (depth - 1) + os.path.basename(root) + '/')
        for fn in sorted(files):
            tree_lines.append('  ' * depth + fn)
    tree_lines.append('README.html')
    tree = '\n'.join(tree_lines)

    device = cfg['device'] or 'cuda'
    api_rows = [
        ('cpg_solve(prob, updated_params=None, **settings)',
         "solve via problem.solve(method='CPG'); caches theta, "
         'warm-starts, honors per-solver settings'),
        ('cpg_gradient(prob)',
         'implicit differentiation: var.gradient seeds -> param.gradient'),
        ('forward(prob, ...) / backward(prob)',
         'CVXPYlayers-style differentiable interface'),
        ('_runtime.solve_batch(theta)',
         f'batched lookup-table evaluation over theta (B, p) on the '
         f'package\'s device ({device}), in float32') if cfg['explicit'] else
        ('_runtime.solver.solve_batch(theta)',
         f'batched torch solve over theta (B, p) on the package\'s device '
         f'({device}); shared-KKT fast path auto-detected when the batch '
         'varies only vector params'),
        ('cvxpygen_tpu_torch.TorchLayer(problem, parameters, variables)',
         'differentiable torch layer over the same family: batched '
         'forward on the device, autograd backward'),
        ("generate_code(..., device=, dtype=)",
         'where the package solves (CUDA unless set) and its working dtype '
         '(float32 on CUDA, float64 on the CPU unless set)'),
    ]
    if c_dir:
        api_rows.append(('c/ (make && ./cpg_example)',
                         'standalone C project: embedded solver core + '
                         'family data, no Python required'))
    api_table = ''.join(f'<tr><td><code>{a}</code></td><td>{b}</td></tr>'
                        for a, b in api_rows)

    html = f"""<html><head><title>CVXPYgen-torch generated solver</title></head>
<body>
<h1>CVXPYgen-torch solver package</h1>
<p>Solver: {cfg['solver']} | gradient: {cfg['gradient']} |
prefix: '{cfg['prefix']}' | device: {device} |
dtype: {cfg['dtype'] or 'default'}</p>
<h2>Problem family</h2>
<p>n = {fam.n} variables ({len(fam.user_vars)} user),
m = {fam.m} constraint rows
(zero: {fam.n_zero}, nonneg: {fam.n_nonneg}, SOC: {list(fam.soc_dims)}),
p = {fam.p} parameter entries.</p>
<h2>Parameters</h2>
<table border=1><tr><th>name</th><th>shape</th><th>theta entries</th></tr>
{params_rows}</table>
<h2>Variables</h2>
<table border=1><tr><th>name</th><th>shape</th><th>size</th></tr>
{vars_rows}</table>
<h2>Generated files</h2>
<pre>
{tree}
</pre>
<h2>API</h2>
<table border=1><tr><th>entry point</th><th>role</th></tr>
{api_table}</table>
<h2>Usage</h2>
<pre>
from {os.path.basename(os.path.normpath(code_dir))}.cpg_solver import cpg_solve
problem.register_solve('CPG', cpg_solve)
problem.solve(method='CPG', updated_params=[...], max_iter=4000)
</pre>
</body></html>
"""
    with open(os.path.join(code_dir, 'README.html'), 'w') as f:
        f.write(html)
