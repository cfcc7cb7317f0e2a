"""Settings registry of the ADMM engine (parity: reference settings
plumbing).

The reference declares, per solver, a registry of ``Setting(type, default,
enabled, name_cvxpy)`` (reference cvxpygen/mappings.py:140-145; osqp.py:
102-115), warns on unknown settings (_interface.py:125-130) and translates
CVXPY-style names (_interface.py:197-199).  This slice of the port carries
the ADMM engine; the conic and explicit engines arrive with their solvers.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional

from .admm import ADMMSettings


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
# gated behind generate_code(..., enable_settings=['verbose'])
ADMM_SETTINGS['verbose'] = Setting('bool', False, enabled=False)

# reference/CVXPY-style names -> engine setting names
ADMM_ALIASES: Dict[str, str] = {
    'warm_start': 'warm_starting',
}


def engine_registry(engine):
    """(settings registry, aliases) of a compiled solver's engine name; the
    banded engine ``ADMM_BANDED`` runs the ADMM settings."""
    engine = 'ADMM' if engine == 'ADMM_BANDED' else engine
    if engine != 'ADMM':
        raise ValueError(f'no settings registry for engine {engine!r}')
    return ADMM_SETTINGS, ADMM_ALIASES
