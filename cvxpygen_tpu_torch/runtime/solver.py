"""Compiled solvers: batched solve functions per problem family, in torch.

Port of the QP branch of the JAX package's ``runtime/solver.py``: the
online path canonicalize -> solve -> retrieve over a parameter batch,
through the shared-KKT branch (every batch row shares the canonical P and A)
or the per-instance branch.  The other engines raise ``NotImplementedError``
naming the ROADMAP.md queue-1 item that ports them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..canon.canonicalizer import Family
from ..solvers.admm import ADMMSettings, admm_solve
from ..solvers.admm_shared import admm_solve_shared
from .torch_family import (TorchFamily, canon_batch, canon_batch_shared,
                           qp_bounds_batch, resolve_device)


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
            raise ValueError('family has SOC cones: a conic engine solves it '
                             '(ROADMAP.md queue 1 items 8-9)')
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


def make_compiled_solver(family: Family, solver='ADMM', settings=None,
                         dtype=None, device=None):
    """Resolve a solver name to a compiled solver (ADMM / OSQP alias in
    this slice of the port)."""
    name = (solver or 'ADMM').upper()
    has_cones = bool(family.soc_dims or getattr(family, 'n_exp', 0)
                     or getattr(family, 'psd_dims', ())
                     or getattr(family, 'pow_alphas', ()))
    if name in ('ADMM', 'OSQP'):
        if has_cones:
            raise ValueError(f'{solver}: QP-form solver but family has cones '
                             '(SOC/exp/PSD/pow)')
        if family.n >= 512:
            raise NotImplementedError(
                'long-horizon families (n >= 512) route to the banded '
                'solver, which is not ported yet: ROADMAP.md queue 1 item 7')
        return CompiledQPSolver(family, settings=settings, dtype=dtype,
                                device=device)
    if name in ('BANDED', 'ADMM_BANDED'):
        raise NotImplementedError('the banded ADMM solver is not ported '
                                  'yet: ROADMAP.md queue 1 item 7')
    if name in ('SCS', 'CONIC_ADMM'):
        raise NotImplementedError('conic ADMM is not ported yet: ROADMAP.md '
                                  'queue 1 item 8')
    if name in ('IPM', 'ECOS', 'CLARABEL', 'QOCO', 'QOCOGEN'):
        raise NotImplementedError('the conic IPM is not ported yet: '
                                  'ROADMAP.md queue 1 item 9')
    raise ValueError(f'unknown solver {solver!r}')
