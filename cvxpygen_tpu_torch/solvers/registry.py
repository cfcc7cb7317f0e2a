"""Settings registry of the ADMM engine (parity: reference settings
plumbing).

The reference declares, per solver, a registry of ``Setting(type, default,
enabled, name_cvxpy)`` (reference cvxpygen/mappings.py:140-145; osqp.py:
102-115), warns on unknown settings (_interface.py:125-130) and translates
CVXPY-style names (_interface.py:197-199).  The port carries the ADMM engine
(with its banded variant), the conic ADMM (SCS) and the interior-point
engine; the explicit engine arrives with its solver.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional

from .admm import ADMMSettings
from .conic_admm import ConicADMMSettings
from .ipm import IPMSettings


@dataclass
class Setting:
    """One tunable solver setting (reference mappings.py:140-145)."""
    type: str
    default: Any
    enabled: bool = True
    name_cvxpy: Optional[str] = None


def _registry_from_dataclass(cls, cvxpy_names=None):
    cvxpy_names = cvxpy_names or {}
    out = {}
    for f in fields(cls):
        out[f.name] = Setting(type=getattr(f.type, '__name__', str(f.type)),
                              default=f.default,
                              name_cvxpy=cvxpy_names.get(f.name))
    return out


ADMM_SETTINGS: Dict[str, Setting] = _registry_from_dataclass(
    ADMMSettings, cvxpy_names={'warm_starting': 'warm_start'})
IPM_SETTINGS: Dict[str, Setting] = _registry_from_dataclass(IPMSettings)
CONIC_ADMM_SETTINGS: Dict[str, Setting] = _registry_from_dataclass(
    ConicADMMSettings, cvxpy_names={'warm_starting': 'warm_start',
                                    'max_iter': 'max_iters'})
# gated behind generate_code(..., enable_settings=['verbose'])
for _reg in (ADMM_SETTINGS, IPM_SETTINGS, CONIC_ADMM_SETTINGS):
    _reg['verbose'] = Setting('bool', False, enabled=False)

# reference/CVXPY-style names -> engine setting names
ADMM_ALIASES: Dict[str, str] = {
    'warm_start': 'warm_starting',
}
# the SCS surface
CONIC_ADMM_ALIASES: Dict[str, str] = {
    'warm_start': 'warm_starting',
    'max_iters': 'max_iter',
    'eps': 'eps_abs',
}
# the reference solver surfaces: ECOS feastol/abstol/reltol/maxit, Clarabel
# tol_*/equilibrate_*/iterative_refinement_* (clarabel.py:63-119), QOCO
IPM_ALIASES: Dict[str, str] = {
    'maxit': 'max_iter', 'feastol': 'tol_feas',
    'abstol': 'tol_gap', 'reltol': 'tol_gap',
    'tol_gap_abs': 'tol_gap', 'tol_gap_rel': 'tol_gap',
    'tol_infeas_abs': 'tol_infeas', 'tol_infeas_rel': 'tol_infeas',
    'tol_feas_abs': 'tol_feas', 'tol_feas_rel': 'tol_feas',
    'equilibrate_max_iter': 'scaling',
    'iterative_refinement_max_iter': 'refine_steps',
    'max_step_fraction': 'frac_to_boundary',
    'abstol_inacc': 'tol_gap', 'reltol_inacc': 'tol_gap',
}

_ENGINES = {
    'ADMM': (ADMM_SETTINGS, ADMM_ALIASES),
    'IPM': (IPM_SETTINGS, IPM_ALIASES),
    'CONIC_ADMM': (CONIC_ADMM_SETTINGS, CONIC_ADMM_ALIASES),
    'SCS': (CONIC_ADMM_SETTINGS, CONIC_ADMM_ALIASES),
}


def engine_registry(engine):
    """(settings registry, aliases) of a compiled solver's engine name; the
    banded engine ``ADMM_BANDED`` runs the ADMM settings."""
    engine = 'ADMM' if engine == 'ADMM_BANDED' else engine
    if engine not in _ENGINES:
        raise ValueError(f'no settings registry for engine {engine!r}')
    return _ENGINES[engine]
