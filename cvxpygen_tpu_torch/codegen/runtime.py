"""Runtime object behind generated solver packages (ADMM, conic ADMM and
IPM engines).

Port of the JAX package's ``codegen/runtime.py`` ``CpgRuntime``: it plays
the role of the reference's compiled pybind module + python wrapper
(reference templates/cpg_solver.py.jinja2:38-213).  It holds the compiled
family, caches theta between calls honouring ``updated_params``, resolves
runtime settings through the registry, and warm-starts from the previous
solution where the engine takes one (the ADMM engines, the conic ADMM
included; as in the reference, the IPM is not warm-started).  With
``gradient=True`` a QP-form package differentiates its last solve
(``cpg_gradient``/``backward``: autodiff/qp_diff.py's implicit
differentiation on the host in float64, as the reference's host branch);
cone families and the interior-point engine raise until the conic
differentiation is ported.  The explicit runtime arrives with a
later slice of the port.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
import warnings

import numpy as np
import torch

from ..autodiff.qp_diff import qp_vjp
from ..canon.canonicalizer import Family, retrieve_duals, retrieve_primal
from ..problem import SolverStats
from ..runtime.solver import _status_str, make_compiled_solver
from ..runtime.torch_family import TorchFamily, canon_batch, qp_bounds_batch
from ..solvers.registry import engine_registry

_NO_GRADIENT = ('gradient=True on a cone family or a conic engine needs the '
                'conic differentiation (autodiff/conic_diff.py), which is '
                'not ported yet: ROADMAP.md queue 1 item 6')
_GRADIENT_ENGINES = ('ADMM', 'ADMM_BANDED')


def _pack_theta_cached(fam, prob, updated_params, cached):
    """Theta caching honoring ``updated_params`` (parity: the reference's
    generated update flags, templates/cpg_solver.py.jinja2:43-51 -- when a
    param list is given, only those entries of the cached theta are
    refreshed)."""
    if cached is None or updated_params is None:
        return fam.pack_theta(params=prob.parameters())
    theta = cached
    for pi in fam.param_info:
        if pi.name in updated_params:
            src = [p for p in prob.parameters() if p.id == pi.pid]
            flat = (src[0].flatten_value() if src else
                    fam.pack_theta(params=prob.parameters())
                    [pi.offset:pi.offset + pi.flat_size])
            theta[pi.offset:pi.offset + pi.flat_size] = flat
    return theta


class CpgRuntime:
    def __init__(self, family: Family, solver_name='ADMM', prefix='',
                 gradient=False, enable_settings=None, dtype=None,
                 solver_opts=None, device=None):
        self.family = family
        self.prefix = prefix
        self.gradient_enabled = gradient
        self.enable_settings = enable_settings or []
        self.solver = make_compiled_solver(family, solver_name, dtype=dtype,
                                           device=device)
        if gradient and self.solver.solver_name not in _GRADIENT_ENGINES:
            raise NotImplementedError(_NO_GRADIENT)
        # the banded engine takes the ADMM settings
        self._registry, self._aliases = engine_registry(
            self.solver.solver_name)
        # parity: reference configure_settings warns when enable_settings
        # names a setting the solver does not have (_interface.py:125-130)
        for s in self.enable_settings:
            if s not in self._registry and s not in self._aliases:
                warnings.warn(f'Cannot enable setting {s} for solver '
                              f'{solver_name}')
        if solver_opts:
            # generate-time solver_opts become the runtime setting defaults
            base = self.solver.settings
            upd = {k: v for k, v in solver_opts.items()
                   if k in {f.name for f in dataclasses.fields(base)}}
            if upd:
                self.solver.settings = dataclasses.replace(base, **upd)
        self.requested_solver = solver_name
        self._theta = None
        self._ctx = None
        self._grad_tf = None
        # warm-start state persisted across cpg_solve calls, for engines
        # whose solve_batch takes one (parity: reference OSQP
        # warm_starting default-ON, osqp.py:102-115)
        self._supports_warm = 'x0' in inspect.signature(
            self.solver.solve_batch).parameters
        self._warm = None

    # -- settings -------------------------------------------------------
    def _settings(self, kwargs):
        """Registry-driven runtime-setting resolution (reference
        _interface.py:125-130,197-199 semantics): translate reference/
        CVXPY-style names, gate disabled settings behind
        ``enable_settings``, and warn on unknown names."""
        base = self.solver.settings
        field_names = {f.name for f in dataclasses.fields(base)}
        upd = {}
        for k, v in kwargs.items():
            k2 = self._aliases.get(k, k)
            reg_entry = self._registry.get(k2)
            if reg_entry is not None and not reg_entry.enabled \
                    and k2 not in self.enable_settings \
                    and k not in self.enable_settings:
                warnings.warn(
                    f'setting {k!r} is disabled for this solver; pass '
                    f"enable_settings=['{k2}'] to generate_code to use it")
                continue
            if k2 in field_names:
                upd[k2] = v
            elif k2 == 'verbose':
                continue  # handled by the caller (gated above)
            else:
                warnings.warn(f'ignoring unknown setting {k!r}')
        return dataclasses.replace(base, **upd) if upd else base

    def _pack(self, prob, updated_params):
        self._theta = _pack_theta_cached(self.family, prob, updated_params,
                                         self._theta)
        return self._theta

    # -- main solve (method='CPG') --------------------------------------
    def cpg_solve(self, prob, updated_params=None, **kwargs):
        verbose = bool(kwargs.pop('verbose', False))
        if verbose and 'verbose' not in self.enable_settings:
            warnings.warn(
                "setting 'verbose' is disabled for this solver; pass "
                "enable_settings=['verbose'] to generate_code to use it")
            verbose = False
        st = self._settings(kwargs)
        theta = self._pack(prob, updated_params)
        t0 = time.perf_counter()
        warm = {}
        if self._supports_warm and self._warm is not None \
                and st.warm_starting:
            warm = dict(x0=self._warm[0], y0=self._warm[1])
        out = self.solver.solve_batch(theta[None, :], settings=st, **warm)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        solve_time = time.perf_counter() - t0
        if self._supports_warm:
            self._warm = (out['x'], out['y'])
        fam = self.family
        obj = float(out['obj'][0] + out['d'][0])
        if fam.is_maximization:
            obj = -obj
        # parity: +-1e30 <-> inf decoding (reference utils.py:213-228)
        if obj >= 1e29:
            obj = np.inf
        elif obj <= -1e29:
            obj = -np.inf
        status = _status_str(out)
        primal = retrieve_primal(fam, out['x'][0])
        duals = retrieve_duals(fam, out['y_canon'][0])
        stats = SolverStats(
            solver_name=self.requested_solver, solve_time=solve_time,
            num_iters=int(out['iters'][0]),
            extra=dict(pri_res=float(out.get('pri_res',
                                             out.get('res_primal'))[0]),
                       dua_res=float(out.get('dua_res',
                                             out.get('res_dual'))[0])))
        self._ctx = dict(out=out, theta=theta.copy())
        if verbose:
            print(f'CVXPYgen-torch {self.requested_solver}: '
                  f'status {status}, iter {stats.num_iters}, '
                  f'pri_res {stats.extra["pri_res"]:.2e}, '
                  f'dua_res {stats.extra["dua_res"]:.2e}\n'
                  f'optimal objective: {obj:.6f} '
                  f'(solve time {1000 * solve_time:.2f} ms)')
        return prob.unpack_results(status, obj, primal, duals, stats)

    # -- gradients (gradient=True) ---------------------------------------
    def cpg_gradient(self, prob):
        """Read var.gradient seeds, write param.gradient (reference
        cpg_solver.py.jinja2:133-173)."""
        if not self.gradient_enabled:
            raise RuntimeError('generate_code was called without '
                               'gradient=True')
        if self._ctx is None:
            raise RuntimeError('solve before calling cpg_gradient')
        fam = self.family
        gx = np.zeros(fam.n)
        for vi in fam.user_vars:
            var = [v for v in prob.variables() if v.id == vi.vid]
            if var and var[0].gradient is not None:
                gx[vi.offset:vi.offset + vi.size] = np.ravel(
                    np.asarray(var[0].gradient, dtype=float), order='F')
        grads = fam.unpack_theta_grad(self._grad_theta(gx))
        for p in prob.parameters():
            if p.name() in grads:
                p.gradient = grads[p.name()]
        return grads

    def _grad_theta(self, gx):
        """Implicit differentiation of the last QP solve on the host in
        float64 (the reference's QP branch, its grad template
        cpg_osqp_grad_compute.c.jinja2:432-531): autodiff/qp_diff.py's
        ``qp_vjp`` at B = 1 on a float64 CPU copy of the family."""
        if self._grad_tf is None:
            self._grad_tf = TorchFamily.from_family(
                self.family, dtype=torch.float64, device='cpu')
        tf = self._grad_tf
        theta = torch.as_tensor(self._ctx['theta'],
                                dtype=torch.float64)[None]
        data = canon_batch(tf, theta)
        l, u = qp_bounds_batch(tf, data['b'])
        out = self._ctx['out']

        def row(key):
            return torch.as_tensor(np.asarray(out[key][0],
                                              dtype=np.float64))[None]
        zeros = torch.zeros((1, self.family.m), dtype=torch.float64)
        return qp_vjp(tf, theta, row('x'), -row('y_canon'), row('z'),
                      data['P'], data['q'], data['A'], l, u,
                      torch.as_tensor(gx, dtype=torch.float64)[None], zeros,
                      zeros[:, 0])[0].numpy()

    # -- cvxpylayers-style forward/backward ------------------------------
    def forward(self, prob, updated_params=None, **kwargs):
        val = self.cpg_solve(prob, updated_params=updated_params, **kwargs)
        info = dict(obj=val, ctx=self._ctx)
        return [v.value for v in prob.variables()], info

    def backward(self, prob, **kwargs):
        return self.cpg_gradient(prob)
