"""Runtime objects behind generated solver packages.

Port of the JAX package's ``codegen/runtime.py``.  ``CpgRuntime`` (ADMM,
banded ADMM, conic ADMM and IPM engines) plays the role of the reference's
compiled pybind module + python wrapper (reference
templates/cpg_solver.py.jinja2:38-213): it holds the compiled family,
caches theta between calls honouring ``updated_params``, resolves runtime
settings through the registry, and warm-starts from the previous solution
where the engine takes one (the ADMM engines, the conic ADMM included; as
in the reference, the IPM is not warm-started).  With ``gradient=True`` a
package differentiates its last solve (``cpg_gradient``/``backward``),
routed by the family whatever engine solved it: QP-form families by
autodiff/qp_diff.py's implicit differentiation on the host in float64 (the
reference's host branch), cone families by autodiff/conic_diff.py at B = 1
on the runtime's device.  ``ExplicitRuntime`` serves ``solver='explicit'``
packages: the lookup-table evaluator of solvers/explicit.py.
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
from ..runtime.torch_family import (TorchFamily, canon_batch,
                                    qp_bounds_batch, resolve_device)
from ..solvers.registry import engine_registry


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
        self._conic_diff = None
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
        """dL/dtheta of the last solve for the seed gx (n,): cone families
        through the conic differentiation, QP-form families through the
        QP one (the reference's ``_grad_theta``)."""
        fam = self.family
        if fam.soc_dims or fam.n_exp or fam.psd_dims or fam.pow_alphas:
            return self._grad_theta_conic(gx)
        return self._grad_theta_qp(gx)

    def _grad_theta_conic(self, gx):
        """autodiff/conic_diff.py at B = 1 on the runtime's device: the
        conic solution map re-solved at the last theta with
        gradient-quality settings for the dtype (float64 ones are out of
        float32's reach), then one transpose KKT solve."""
        jf = self.solver.jf
        if self._conic_diff is None:
            from ..autodiff.conic_diff import make_conic_diff_solve
            f32 = jf.maps.dtype == torch.float32
            fam = self.family
            if fam.n_exp or fam.psd_dims or fam.pow_alphas:
                from ..solvers.conic_admm import ConicADMMSettings
                tol = 1e-5 if f32 else 1e-8
                stg = ConicADMMSettings(eps_abs=tol, eps_rel=tol,
                                        max_iter=20000)
            else:
                from ..solvers.ipm import IPMSettings
                stg = (IPMSettings.for_dtype(torch.float32, max_iter=100)
                       if f32 else IPMSettings(max_iter=100, tol_feas=1e-10,
                                               tol_gap=1e-10))
            self._conic_diff = make_conic_diff_solve(jf, stg)
        theta = torch.as_tensor(self._ctx['theta'], dtype=jf.maps.dtype,
                                device=jf.maps.device)[None]
        theta.requires_grad_()
        x = self._conic_diff(theta)['x']
        (dtheta,) = torch.autograd.grad(
            x, theta, torch.as_tensor(gx, dtype=x.dtype,
                                      device=x.device)[None])
        return dtheta[0].detach().cpu().numpy()

    def _grad_theta_qp(self, gx):
        """Implicit differentiation of the last QP solve on the host in
        float64 (the reference's QP branch, its grad template
        cpg_osqp_grad_compute.c.jinja2:432-531): autodiff/qp_diff.py's
        ``qp_vjp`` at B = 1 on a float64 CPU copy of the family.  A QP
        family solved by the IPM gives its slack s for the rows' values:
        the ADMM's z is A x = l + [0; s]."""
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
        if 's' in out:
            z = l + torch.cat([torch.zeros((1, tf.n_zero),
                                           dtype=torch.float64), row('s')],
                              dim=1)
        else:
            z = row('z')
        zeros = torch.zeros((1, self.family.m), dtype=torch.float64)
        return qp_vjp(tf, theta, row('x'), -row('y_canon'), z,
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


class ExplicitRuntime:
    """Runtime for solver='explicit' packages (the reference's PDAQP role;
    its pdaqp.py and the explicit solve path of utils.py:1012-1067).  The
    lookup table is enumerated at generate time (solvers/explicit.py) and
    evaluated at B = 1 on ``device`` (CUDA unless given; no card and no
    device raises), in float32, the table's precision, whatever the
    package's dtype."""

    def __init__(self, family: Family, explicit=1, prefix='', gradient=False,
                 solver_opts=None, theta_ref=None, device=None,
                 _saved_data=None):
        opts = dict(solver_opts or {})
        self.family = family
        self.prefix = prefix
        self.gradient_enabled = gradient
        self.explicit = 2 if opts.get('dual') else explicit
        self.device = resolve_device(device)
        if _saved_data is not None:
            self.data = _saved_data
        else:
            from ..solvers.explicit import (
                build_explicit_data, enumerate_regions, extract_mpqp,
                measure_coverage)
            mp = extract_mpqp(family, theta_ref=theta_ref,
                              theta_box=opts.get('theta_box'))
            # capacity caps (reference pdaqp.py:83-84, README.md:216-217):
            # max_floats bounds the table's storage; each region stores its
            # primal feedbacks, optional dual feedbacks and its halfplanes,
            # all affine in theta, so the budget becomes a region cap
            max_regions = int(opts.get('max_regions', 500))
            max_floats = float(opts.get('max_floats', 1e6))
            nth = mp.F.shape[1] + 1
            m_dual = (mp.G.shape[0] + mp.E.shape[0]) \
                if self.explicit == 2 else 0
            per_region = (family.n + m_dual + mp.G.shape[0]) * nth
            floats_cap = max(1, int(max_floats // max(per_region, 1)))
            if floats_cap < max_regions:
                warnings.warn(
                    f'max_floats={max_floats:g} limits the explicit table '
                    f'to {floats_cap} regions (~{per_region} floats each); '
                    f'max_regions={max_regions} is not reachable')
                max_regions = floats_cap
            regions = enumerate_regions(mp, max_regions=max_regions)
            stored_idx = None
            if opts.get('stored_vars') is not None:
                stored_idx = _stored_idx(family, opts['stored_vars'])
            self.data = build_explicit_data(
                family, regions, mp, stored_idx=stored_idx,
                dual=(self.explicit == 2), fp16=bool(opts.get('fp16', False)))
            # the unreached-domain report: the fraction of sampled domain
            # points that some region covers
            self.data.coverage = measure_coverage(mp, regions)
            if self.data.coverage < 0.999:
                warnings.warn(
                    f'explicit lookup table covers only '
                    f'{100 * self.data.coverage:.1f}% of the sampled '
                    'parameter domain; queries in uncovered areas return '
                    'the nearest region\'s feedback (raise max_regions or '
                    'shrink the domain)')
        self._ctx = None
        self._theta = None

    @classmethod
    def from_saved(cls, family, data, explicit=1, prefix='', gradient=False,
                   device=None):
        return cls(family, explicit=explicit, prefix=prefix,
                   gradient=gradient, device=device, _saved_data=data)

    def solve_batch(self, theta):
        """theta (B, p) -> (x_store, y or None, region) on the device."""
        from ..solvers.explicit import explicit_evaluate
        return explicit_evaluate(self.data, np.atleast_2d(theta),
                                 want_dual=(self.explicit == 2),
                                 device=self.device)

    def cpg_solve(self, prob, updated_params=None, **kwargs):
        # theta caching as CpgRuntime's; the explicit evaluator has no
        # runtime settings (nor has the reference's pdaqp), so every
        # setting is warned about and ignored
        kwargs.pop('verbose', None)
        for k in kwargs:
            warnings.warn(f'ignoring unknown setting {k!r} '
                          '(explicit solver has no runtime settings)')
        fam = self.family
        self._theta = _pack_theta_cached(fam, prob, updated_params,
                                         self._theta)
        theta = self._theta
        t0 = time.perf_counter()
        xs, y, region = self.solve_batch(theta[None, :])
        xs = xs[0].cpu().numpy()
        region = int(region[0])
        solve_time = time.perf_counter() - t0
        x_full = np.zeros(fam.n)
        x_full[self.data.store_idx] = xs.astype(float)
        primal = retrieve_primal(fam, x_full)
        if y is not None:
            duals = retrieve_duals(fam, y[0].cpu().numpy().astype(float))
        else:
            duals = [None] * len(fam.constr_records)
        # the objective on demand (reference cpg_obj, utils.py:1054-1067)
        P, q, d, _, _ = fam.canon_numpy(theta)
        obj = float(0.5 * x_full @ P @ x_full + q @ x_full + d)
        if fam.is_maximization:
            obj = -obj
        stats = SolverStats(solver_name='EXPLICIT', solve_time=solve_time,
                            num_iters=1, extra=dict(region=region))
        self._ctx = dict(theta=theta.copy(), region=region)
        return prob.unpack_results('optimal', obj, primal, duals, stats)

    def cpg_gradient(self, prob):
        """The region's feedback transposed on the host (reference pdaqp
        gradient, pdaqp.py:237-261; writer.py:418-516)."""
        if self._ctx is None:
            raise RuntimeError('solve before calling cpg_gradient')
        fam = self.family
        full_g = np.zeros(fam.n)
        for vi in fam.user_vars:
            var = [v for v in prob.variables() if v.id == vi.vid]
            if var and var[0].gradient is not None:
                full_g[vi.offset:vi.offset + vi.size] = np.ravel(
                    np.asarray(var[0].gradient, dtype=float), order='F')
        gx_store = full_g[self.data.store_idx]
        FB = np.asarray(self.data.FB[self._ctx['region']], dtype=float)
        p_r = FB.shape[1] - 1
        dtheta = np.zeros(fam.p)
        dtheta[self.data.th_sel] = FB[:, :p_r].T @ gx_store
        grads = fam.unpack_theta_grad(dtheta)
        for p in prob.parameters():
            if p.name() in grads:
                p.gradient = grads[p.name()]
        return grads

    def forward(self, prob, updated_params=None, **kwargs):
        val = self.cpg_solve(prob, updated_params=updated_params, **kwargs)
        return [v.value for v in prob.variables()], dict(
            obj=val, region=self._ctx['region'])

    def backward(self, prob, **kwargs):
        return self.cpg_gradient(prob)


def _stored_idx(family: Family, stored_vars):
    """Map stored_vars (Variable or Index-of-Variable expressions) to
    global x indices (reference pdaqp.py:143-199 stored_vars)."""
    from ..expressions import Index, Variable
    idx = []
    for sv in stored_vars:
        if isinstance(sv, Variable):
            vi = [v for v in family.var_info if v.vid == sv.id][0]
            idx.extend(range(vi.offset, vi.offset + vi.size))
        elif isinstance(sv, Index) and isinstance(sv.args[0], Variable):
            base = sv.args[0]
            vi = [v for v in family.var_info if v.vid == base.id][0]
            idx.extend((vi.offset + np.asarray(sv.flat_idx)).tolist())
        else:
            raise ValueError('stored_vars entries must be variables or '
                             'simple variable slices')
    return np.array(sorted(set(idx)), dtype=int)
