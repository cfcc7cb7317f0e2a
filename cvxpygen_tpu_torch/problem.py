"""Problem container (parity: cp.Problem + solve/register_solve plumbing).

Matches the surface the reference relies on:
- ``Problem(objective, constraints)`` with ``param_dict`` / ``var_dict``
  (reference tests use these, tests/test_E2E_QP.py:131-170)
- ``problem.solve(solver=...)`` and ``problem.solve(method='CPG', ...)``
  via ``register_solve`` (reference cvxpygen/compiler.py:33-40)
- ``problem.solver_stats`` with ``solver_name``/``solve_time``/``num_iters``
- ``problem.solution.opt_val``, ``problem.value``, ``problem.status``
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .constraints import Constraint
from .expressions import Expression, Parameter, Variable, to_expr

OPTIMAL = 'optimal'
INFEASIBLE = 'infeasible'
UNBOUNDED = 'unbounded'
OPTIMAL_INACCURATE = 'optimal_inaccurate'
SOLVER_ERROR = 'solver_error'


class Objective:
    def __init__(self, expr):
        self.expr = to_expr(expr)
        if not self.expr.is_scalar():
            raise ValueError('Objective must be scalar')

    @property
    def value(self):
        return self.expr.value


class Minimize(Objective):
    is_maximization = False

    def is_dcp(self):
        return self.expr.is_convex()


class Maximize(Objective):
    is_maximization = True

    def is_dcp(self):
        return self.expr.is_concave()


@dataclass
class SolverStats:
    solver_name: str = ''
    solve_time: Optional[float] = None
    setup_time: Optional[float] = None
    num_iters: Optional[int] = None
    extra: dict = field(default_factory=dict)


@dataclass
class Solution:
    status: str = ''
    opt_val: Optional[float] = None
    primal_vars: dict = field(default_factory=dict)
    dual_vars: dict = field(default_factory=dict)
    attr: dict = field(default_factory=dict)


class Problem:
    def __init__(self, objective, constraints=None):
        if not isinstance(objective, Objective):
            raise ValueError('objective must be Minimize or Maximize')
        self.objective = objective
        self.constraints = list(constraints) if constraints else []
        for c in self.constraints:
            if not isinstance(c, Constraint):
                raise ValueError(f'not a constraint: {c!r}')
        self._vars = self._collect_vars()
        self._params = self._collect_params()
        self.var_dict = {v.name(): v for v in self._vars}
        self.param_dict = {p.name(): p for p in self._params}
        self._solve_methods = {}
        self._status = None
        self._value = None
        self._solution = None
        self._solver_stats = None
        self._compiled_cache = {}

    # -- introspection -----------------------------------------------------
    def _collect_vars(self):
        out, seen = [], set()
        for v in self.objective.expr.variables():
            if v.id not in seen:
                seen.add(v.id)
                out.append(v)
        for c in self.constraints:
            for v in c.variables():
                if v.id not in seen:
                    seen.add(v.id)
                    out.append(v)
        return out

    def _collect_params(self):
        out, seen = [], set()
        for p in self.objective.expr.parameters():
            if p.id not in seen:
                seen.add(p.id)
                out.append(p)
        for c in self.constraints:
            for p in c.parameters():
                if p.id not in seen:
                    seen.add(p.id)
                    out.append(p)
        return out

    def variables(self):
        return list(self._vars)

    def parameters(self):
        return list(self._params)

    def is_dcp(self, dpp=False):
        if not self.objective.is_dcp():
            return False
        return True  # constraint ctors enforce DCP at construction

    # -- results -----------------------------------------------------------
    @property
    def value(self):
        return self._value

    @property
    def status(self):
        return self._status

    @property
    def solution(self):
        return self._solution

    @property
    def solver_stats(self):
        return self._solver_stats

    # -- solving -----------------------------------------------------------
    def register_solve(self, name, func):
        """Parity: cvxpy's Problem.register_solve used by the generated
        wrapper (reference templates/cpg_solver.py.jinja2 + compiler.py:40)."""
        self._solve_methods[name] = func

    def solve(self, solver=None, method=None, **kwargs):
        if method is not None:
            if method not in self._solve_methods:
                raise ValueError(f'no solve method registered under {method!r}')
            return self._solve_methods[method](self, **kwargs)
        from .interface import solve_via_compiled
        return solve_via_compiled(self, solver=solver, **kwargs)

    def unpack_results(self, status, obj_value, primal_dict, dual_list,
                       stats: SolverStats):
        """Write a solver result back into the modeling layer, mirroring the
        generated wrapper (templates/cpg_solver.py.jinja2:75-115)."""
        self._status = status
        self._value = obj_value
        for v in self._vars:
            val = primal_dict.get(v.id)
            v.save_value(None if val is None else np.asarray(val).reshape(v.shape, order='F')
                         if v.shape else float(np.asarray(val).reshape(())))
        for c, dv in zip(self.constraints, dual_list):
            c.save_dual_value(dv)
        self._solver_stats = stats
        self._solution = Solution(
            status=status, opt_val=obj_value,
            primal_vars={v.id: v.value for v in self._vars},
            dual_vars={c.id: c.dual_value for c in self.constraints})
        return obj_value
