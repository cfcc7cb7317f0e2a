"""Entry ``solve_batch``: the batched QP call
``CompiledQPSolver.solve_batch(theta, shared_PA='auto')``, which takes the
shared route (kernel K1) where the rows share P and A and the per-instance
route (the factor in cuBLAS, kernel K3) where they do not.

An entry, named by a traffic mix, provides ``make(family, config, dtype,
device)`` (the solver, built once at set-up), ``solve(solver, theta)`` (the
timed call on a (B, p) batch; a dict with at least ``x``, ``obj``, ``d``,
``status`` (1 = solved) and ``iters`` per instance) and ``route(solver,
theta)`` (the name of the route the batch takes)."""
from cvxpygen_tpu_torch.runtime.solver import (CompiledQPSolver,
                                               pa_theta_mask, use_shared_path)
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings


def make(family, config, dtype, device):
    return CompiledQPSolver(family, ADMMSettings(**config['settings']),
                            dtype=dtype, device=device)


def solve(solver, theta):
    return solver.solve_batch(theta, shared_PA='auto')


def route(solver, theta):
    shared = use_shared_path(pa_theta_mask(solver.family), theta, 'auto')
    return 'shared' if shared else 'per_instance'
