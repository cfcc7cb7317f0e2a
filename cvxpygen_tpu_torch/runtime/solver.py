"""Compiled solvers: batched solve functions per problem family, in torch.

Port of the JAX package's ``runtime/solver.py``: the online path
canonicalize -> solve -> retrieve over a parameter batch.  QP-form
families run the ADMM engine, through the shared-KKT branch (every batch
row shares the canonical P and A) or the per-instance branch, on dense
storage (``CompiledQPSolver``) or, for long-horizon families, on
block-banded storage (``CompiledBandedQPSolver``); conic families run the
interior-point engine (``CompiledConicSolver``) or the conic ADMM
(``CompiledConicADMMSolver``, the SCS route and the default for exp, PSD
and pow families).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..canon.canonicalizer import Family, retrieve_duals, retrieve_primal
from ..ops.cones import ConeLayout
from ..problem import SolverStats
from ..solvers.admm import ADMMSettings, admm_solve
from ..solvers.admm_shared import admm_solve_shared
from ..solvers.conic_admm import ConicADMMSettings, conic_admm_solve
from ..solvers.conic_admm_shared import conic_admm_solve_shared
from ..solvers.ipm import IPMSettings, ipm_solve
from .torch_family import (TorchFamily, canon_batch, canon_batch_shared,
                           canon_batch_sparse, qp_bounds_batch,
                           resolve_device)


def pa_theta_mask(family: Family):
    """Boolean mask (p,) of theta entries with nonzero coefficients in the
    canonical P or A maps.  Entries outside the mask touch only q/b/d: a
    batch that varies only there shares P/A and the KKT factorization."""
    mask = np.zeros(family.p, dtype=bool)
    for M in (family.P_map, family.A_map):
        if M is not None and M.shape[0]:
            col = np.asarray(np.abs(M[:, :family.p]).sum(axis=0)).ravel()
            mask |= col > 0
    return mask


def use_shared_path(pa_mask, theta, shared_PA):
    """Shared-KKT eligibility: True / False / 'auto'.  Under 'auto' the
    batch (a NumPy array, list or tensor: always inspectable) is checked
    column-wise on the P/A-relevant theta entries."""
    if shared_PA is True:
        return True
    if shared_PA != 'auto':
        return False
    if not pa_mask.any():
        return True
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().cpu().numpy()
    theta = np.atleast_2d(np.asarray(theta))
    if theta.shape[0] <= 1:
        return True
    cols = theta[:, pa_mask]
    return bool(np.all(cols == cols[:1]))


def _status_str(out):
    """Status-code -> string mapping (reference status surface,
    utils.py:977-985)."""
    code = int(out['status'][0])
    return {1: 'optimal', 0: 'max_iter', -3: 'infeasible',
            -4: 'unbounded'}.get(code, 'solver_error')


class CompiledQPSolver:
    """ADMM-backed compiled family solver (OSQP role).

    solve_batch(theta (B, p)) -> dict of batched tensors.  Canonical dual
    convention: y_canon = -y_osqp.  Runs on CUDA unless ``device`` says
    otherwise; default dtype float32 on CUDA, float64 on the CPU."""

    solver_name = 'ADMM'

    def __init__(self, family: Family, settings: ADMMSettings = None,
                 dtype=None, device=None):
        if family.soc_dims:
            raise ValueError('family has SOC cones: use a conic solver '
                             '(IPM/ECOS/CLARABEL)')
        self.family = family
        self.settings = settings or ADMMSettings()
        self.device = resolve_device(device)
        self.jf = TorchFamily.from_family(family, dtype=dtype,
                                          device=self.device)
        self._pa_mask = pa_theta_mask(family)

    def solve_batch(self, theta, settings: ADMMSettings = None,
                    x0=None, y0=None, shared_PA='auto'):
        """Batched solve.  ``shared_PA`` selects the shared-KKT path (one
        factorization for the whole batch, every matvec a full-batch GEMM):
        'auto' takes it when the rows share the P/A-relevant theta entries,
        True asserts that they do, False always takes the per-instance
        path (solvers/admm.py::admm_solve: canonical P and A per row)."""
        st = settings or self.settings
        jf = self.jf
        if self._use_shared(theta, shared_PA):
            data = canon_batch_shared(jf, theta)
            solve = admm_solve_shared
        else:
            data = canon_batch(jf, theta)
            solve = admm_solve
        l, u = qp_bounds_batch(jf, data['b'])
        res = solve(data['P'], data['q'], data['A'], l, u, jf.n_zero, st,
                    x0=x0, y0=y0)
        res['d'] = data['d']
        res['y_canon'] = -res['y']
        return res

    def _use_shared(self, theta, shared_PA):
        return use_shared_path(self._pa_mask, theta, shared_PA)


class NotBandedError(ValueError):
    """The family's KKT pattern is not (usefully) block-banded."""


class CompiledBandedQPSolver:
    """Block-banded ADMM-backed compiled family solver for long-horizon QP
    families (MPC with large H, charging with T ~ 1440): the KKT matrix is
    block-tridiagonal after an RCM permutation, so the solve runs on
    sparse/banded storage, O(nnz + nb s^2) per iteration instead of O(n^2),
    and no dense (B, n, n) tensor is ever formed (solvers/admm_banded.py).

    A batch that shares canonical P/A (``shared_PA`` as in
    CompiledQPSolver) takes the shared engine (solvers/
    admm_banded_shared.py): kernel K5 for nb <= 96, the loop around kernel
    K4 above.  The reference takes that engine only on a TPU, where its
    Pallas kernels run (its runtime/solver.py:242-244); the port takes it
    whenever ``use_shared_path`` says so: on CUDA through K4/K5, on the
    CPU through their plain versions.  Other batches take the per-instance
    engine.  The family's index tensors are built once, here.  Raises
    NotBandedError when the KKT pattern is not (usefully) block-banded."""

    solver_name = 'ADMM_BANDED'

    def __init__(self, family: Family, settings: ADMMSettings = None,
                 dtype=None, device=None):
        from ..ops.banded_grouped import build_grouped_a
        from ..solvers.admm_banded import (banded_index,
                                           build_banded_structure)
        if family.soc_dims or getattr(family, 'n_exp', 0) \
                or getattr(family, 'psd_dims', ()) \
                or getattr(family, 'pow_alphas', ()):
            raise ValueError('family has cones: use a conic solver '
                             '(IPM/ECOS/CLARABEL)')
        self.family = family
        self.settings = settings or ADMMSettings()
        self.device = resolve_device(device)
        self.struct = build_banded_structure(
            family.P_idx, family.A_idx, family.n, family.m)
        if self.struct is None:
            raise NotBandedError('family KKT pattern is not block-banded')
        # grouped-A layout of the shared engine: exists iff every
        # constraint row's support spans <= 2 adjacent blocks
        self.grouped = build_grouped_a(
            self.struct.a_row, self.struct.a_col, family.m,
            self.struct.s, self.struct.nb)
        self.index = banded_index(self.struct, self.device, self.grouped)
        self.jf = TorchFamily.from_family(family, dtype=dtype,
                                          device=self.device,
                                          force_scatter=True)
        self._pa_mask = pa_theta_mask(family)

    def solve_batch(self, theta, settings: ADMMSettings = None,
                    x0=None, y0=None, shared_PA='auto'):
        """Batched banded solve; ``shared_PA`` as in CompiledQPSolver."""
        from ..solvers.admm_banded import admm_solve_banded
        from ..solvers.admm_banded_shared import admm_solve_banded_shared
        st = settings or self.settings
        jf = self.jf
        data = canon_batch_sparse(jf, theta)
        l, u = qp_bounds_batch(jf, data['b'])
        if self.grouped is not None and self._use_shared(theta, shared_PA):
            res = admm_solve_banded_shared(
                self.struct, self.grouped, data['pvals'][0], data['q'],
                data['avals'][0], l, u, jf.n_zero, st, x0=x0, y0=y0,
                index=self.index)
        else:
            res = admm_solve_banded(self.struct, data['pvals'], data['q'],
                                    data['avals'], l, u, jf.n_zero, st,
                                    x0=x0, y0=y0, index=self.index)
        res['d'] = data['d']
        res['y_canon'] = -res['y']
        return res

    def _use_shared(self, theta, shared_PA):
        return use_shared_path(self._pa_mask, theta, shared_PA)


class CompiledConicSolver:
    """IPM-backed compiled family solver (Clarabel/ECOS/QOCO role).

    The canonical rows are aff = A x + b with cone membership; the IPM form
    E x + f = 0, G x + h = s in K is exactly (A, b) split by group, with no
    sign flip.  Canonical dual convention: y_canon = [nu; z].  Runs on CUDA
    unless ``device`` says otherwise; default dtype float32 on CUDA, float64
    on the CPU.  With no settings given, float32 takes
    ``IPMSettings.for_dtype``, and exp/pow families loosen to 1e-3 (their
    barrier Hessians scale like 1/mu^2 and carry no float32 precision near
    mu ~ 1e-5)."""

    solver_name = 'IPM'

    def __init__(self, family: Family, settings=None, dtype=None,
                 device=None):
        self.family = family
        self.device = resolve_device(device)
        self.jf = TorchFamily.from_family(family, dtype=dtype,
                                          device=self.device)
        if settings is None:
            dt = self.jf.maps.dtype
            overrides = {}
            if dt == torch.float32 and (family.n_exp or family.pow_alphas):
                overrides = dict(tol_feas=1e-3, tol_gap=1e-3)
            settings = IPMSettings.for_dtype(dt, **overrides)
        self.settings = settings
        # linear-objective family: enables the HSDE infeasibility post-pass
        # for exotic layouts (solvers/ipm.py::ipm_solve)
        P_map = family.P_map
        self.P_is_zero = bool(P_map is None or P_map.nnz == 0)

    def solve_batch(self, theta, settings=None):
        """Batched solve of theta (B, p): dict of batched tensors with x,
        nu, z, s, obj, iters, status, solved, d and y_canon."""
        jf = self.jf
        data = canon_batch(jf, theta)
        A, b = data['A'], data['b']
        mz = jf.n_zero
        res = ipm_solve(data['P'], data['q'], A[:, :mz], b[:, :mz],
                        A[:, mz:], b[:, mz:], jf.n_nonneg, jf.soc_dims,
                        settings or self.settings, n_exp=jf.n_exp,
                        psd_dims=jf.psd_dims, pow_alphas=jf.pow_alphas,
                        P_is_zero=self.P_is_zero)
        res['d'] = data['d']
        res['y_canon'] = torch.cat([res['nu'], res['z']], dim=1)
        return res

    def solve_into_problem(self, problem, **setting_overrides):
        """Solve one instance from the problem's parameter values and write
        the result into the problem (the cpg_solve role)."""
        fam = self.family
        theta = fam.pack_theta(params=problem.parameters())
        st = self.settings
        if setting_overrides:
            st = dataclasses.replace(st, **setting_overrides)
        t0 = time.perf_counter()
        out = self.solve_batch(theta[None, :], settings=st)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        solve_time = time.perf_counter() - t0
        obj = float(out['obj'][0] + out['d'][0])
        if fam.is_maximization:
            obj = -obj
        stats = SolverStats(solver_name=self.solver_name,
                            solve_time=solve_time,
                            num_iters=int(out['iters'][0]))
        return problem.unpack_results(
            _status_str(out), obj, retrieve_primal(fam, out['x'][0]),
            retrieve_duals(fam, out['y_canon'][0]), stats)


class CompiledConicADMMSolver:
    """Conic-ADMM-backed compiled family solver (SCS role; the default
    engine for exp/PSD/pow families).  A batch that shares the canonical P
    and A (``shared_PA`` as in CompiledQPSolver) takes the shared engine
    (solvers/conic_admm_shared.py: one M^-1 for the batch), others the
    per-instance one (solvers/conic_admm.py).  Canonical dual convention:
    y_canon = -y.  Runs on CUDA unless ``device`` says otherwise."""

    solver_name = 'CONIC_ADMM'

    def __init__(self, family: Family, settings=None, dtype=None,
                 device=None):
        self.family = family
        self.settings = settings or ConicADMMSettings()
        self.device = resolve_device(device)
        self.jf = TorchFamily.from_family(family, dtype=dtype,
                                          device=self.device)
        self.layout = ConeLayout(
            n_nonneg=family.n_nonneg, socs=tuple(family.soc_dims),
            n_exp=family.n_exp, psds=tuple(family.psd_dims or ()),
            pows=tuple(family.pow_alphas or ()))
        self._pa_mask = pa_theta_mask(family)

    def solve_batch(self, theta, settings=None, x0=None, y0=None,
                    shared_PA='auto'):
        """Batched conic solve of theta (B, p), warm-started from x0/y0
        (canonical x and OSQP-sign y) when given."""
        st = settings or self.settings
        jf = self.jf
        if use_shared_path(self._pa_mask, theta, shared_PA):
            data = canon_batch_shared(jf, theta)
            solve = conic_admm_solve_shared
        else:
            data = canon_batch(jf, theta)
            solve = conic_admm_solve
        res = solve(data['P'], data['q'], data['A'], data['b'], jf.n_zero,
                    self.layout, st, x0=x0, y0=y0)
        res['d'] = data['d']
        res['y_canon'] = -res['y']
        return res


IPM_SOLVERS = ('IPM', 'ECOS', 'CLARABEL', 'QOCO', 'QOCOGEN')
CONIC_ADMM_SOLVERS = ('SCS', 'CONIC_ADMM')


def make_compiled_solver(family: Family, solver='ADMM', settings=None,
                         dtype=None, device=None):
    """Resolve a solver name to a compiled solver: ADMM / OSQP, BANDED /
    ADMM_BANDED for the block-banded engine, SCS / CONIC_ADMM for the conic
    ADMM, and IPM / ECOS / CLARABEL / QOCO / QOCOGEN for the interior-point
    engine (both conic engines cover the full Clarabel cone list).  ADMM on a family with n >= 512 takes the banded
    solver when the KKT pattern is banded, and the dense one otherwise."""
    name = (solver or 'ADMM').upper()
    has_cones = bool(family.soc_dims or getattr(family, 'n_exp', 0)
                     or getattr(family, 'psd_dims', ())
                     or getattr(family, 'pow_alphas', ()))
    if name in ('BANDED', 'ADMM_BANDED', 'ADMM', 'OSQP') and has_cones:
        raise ValueError(f'{solver}: QP-form solver but family has cones '
                         '(SOC/exp/PSD/pow)')
    if name in ('BANDED', 'ADMM_BANDED'):
        return CompiledBandedQPSolver(family, settings=settings, dtype=dtype,
                                      device=device)
    if name in ('ADMM', 'OSQP'):
        # long-horizon families: dense (B, n, n) KKT storage is
        # prohibitive, so the banded solver takes them when it can; any
        # other error of its construction propagates
        if family.n >= 512:
            try:
                return CompiledBandedQPSolver(family, settings=settings,
                                              dtype=dtype, device=device)
            except NotBandedError:
                pass
        return CompiledQPSolver(family, settings=settings, dtype=dtype,
                                device=device)
    if name in CONIC_ADMM_SOLVERS:
        return CompiledConicADMMSolver(family, settings=settings, dtype=dtype,
                                       device=device)
    if name in IPM_SOLVERS:
        return CompiledConicSolver(family, settings=settings, dtype=dtype,
                                   device=device)
    raise ValueError(f'unknown solver {solver!r}')
