"""Compiled solvers: batched solve functions per problem family, in torch.

Port of the QP branch of the JAX package's ``runtime/solver.py``: the
online path canonicalize -> solve -> retrieve over a parameter batch,
through the shared-KKT branch (every batch row shares the canonical P and A)
or the per-instance branch, on dense storage (``CompiledQPSolver``) or, for
long-horizon families, on block-banded storage
(``CompiledBandedQPSolver``).  The other engines raise
``NotImplementedError`` naming the ROADMAP.md queue-1 item that ports them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..canon.canonicalizer import Family
from ..solvers.admm import ADMMSettings, admm_solve
from ..solvers.admm_shared import admm_solve_shared
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
            raise ValueError('family has cones: a conic engine solves it '
                             '(ROADMAP.md queue 1 items 8-9)')
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


def make_compiled_solver(family: Family, solver='ADMM', settings=None,
                         dtype=None, device=None):
    """Resolve a solver name to a compiled solver (ADMM / OSQP, and
    BANDED / ADMM_BANDED for the block-banded engine, in this slice of the
    port).  ADMM on a family with n >= 512 takes the banded solver when
    the KKT pattern is banded, and the dense one otherwise."""
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
    if name in ('SCS', 'CONIC_ADMM'):
        raise NotImplementedError('conic ADMM is not ported yet: ROADMAP.md '
                                  'queue 1 item 8')
    if name in ('IPM', 'ECOS', 'CLARABEL', 'QOCO', 'QOCOGEN'):
        raise NotImplementedError('the conic IPM is not ported yet: '
                                  'ROADMAP.md queue 1 item 9')
    raise ValueError(f'unknown solver {solver!r}')
