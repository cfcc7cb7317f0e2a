"""Problem.solve plumbing: canonicalize-once, solve, unpack.

This is the "stock solver" path (parity role of CVXPY's own solve in the
reference's tests, tests/utils_test.py:20-35): canonicalize the problem
family, pack theta from current parameter values, run the float64 oracle
IPM on CPU, and write values/duals back into the modeling objects.

The compiled torch path (batched solvers) lives in cvxpygen_tpu_torch.cpg /
runtime and registers itself via ``problem.register_solve('CPG', ...)``
mirroring reference cvxpygen/compiler.py:33-40.
"""
from __future__ import annotations

import time

import numpy as np

from .canon.canonicalizer import canonicalize, retrieve_duals, retrieve_primal
from .problem import SolverStats
from .solvers.oracle import solve_family_numpy

_FAMILY_CACHE_KEY = '_ctpu_family'


def get_family(problem):
    fam = getattr(problem, _FAMILY_CACHE_KEY, None)
    if fam is None:
        fam = canonicalize(problem)
        setattr(problem, _FAMILY_CACHE_KEY, fam)
    return fam


def solve_via_compiled(problem, solver=None, verbose=False, **kwargs):
    fam = get_family(problem)
    theta = fam.pack_theta(params=problem.parameters())
    t0 = time.perf_counter()
    res, y = solve_family_numpy(fam, theta,
                                **{k: v for k, v in kwargs.items()
                                   if k in ('max_iter', 'tol')})
    solve_time = time.perf_counter() - t0

    tt = np.concatenate([theta, [1.0]])
    d = float(np.asarray(fam.d_map @ tt).ravel()[0]) if fam.d_map.shape[0] else 0.0
    if fam.d_quad is not None:
        d += float(tt @ (fam.d_quad @ tt))
    obj = res.obj + d
    if fam.is_maximization:
        obj = -obj

    primal = retrieve_primal(fam, res.x)
    duals = retrieve_duals(fam, y)
    stats = SolverStats(solver_name=solver or 'IPM-ORACLE',
                        solve_time=solve_time, num_iters=res.iters)
    return problem.unpack_results(res.status, obj, primal, duals, stats)
