"""A run with its timed path broken underneath comes out not correct.

Each fault is planted in the solver that ``CompiledQPSolver.solve_batch``
calls, and the rest of a run (pool, window, sample, reference, comparison)
runs as on the card, on the CPU at a tiny size.  The run's own look for a
card is skipped.  The exchange between chips is not a fault these cells can
have: each runs on one card."""
import time

import pytest
import torch

from cvxpygen_tpu_torch.runtime import solver as port_solver
from harness import cell, spec

CELLS = [w['name'] for w in spec.benchmark()['workloads']]


def _run(name):
    # at B=8 every row of every call is kept for the check
    out, _ = cell.run(name, 2 ** 31 + 5, 0.5, False, time.perf_counter(),
                      device='cpu', batch=8, pool=2)
    return out


def _state_unchanged(solve):
    """The solve returns its starting point, claiming every instance."""
    def broken(P, q, A, l, u, n_eq, st, **kw):
        res = solve(P, q, A, l, u, n_eq, st, **kw)
        B = q.shape[0]
        for k in ('x', 'y', 'z'):
            res[k] = torch.zeros_like(res[k])
        res['obj'] = torch.zeros_like(res['obj'])
        res['status'] = torch.ones(B, dtype=torch.int32)
        return res
    return broken


def _half_left_out(solve):
    """Half of the batch is solved; the other half gets its answers."""
    def broken(P, q, A, l, u, n_eq, st, **kw):
        h = q.shape[0] // 2
        half = (lambda t: t[:h]) if P.dim() == 3 else (lambda t: t)
        res = solve(half(P), q[:h], half(A) if A.dim() == 3 else A, l[:h],
                    u[:h], n_eq, st, **kw)
        return {k: torch.cat([v, v]) if torch.is_tensor(v) and v.dim()
                and v.shape[0] == h else v for k, v in res.items()}
    return broken


def _answer_altered(solve):
    """Every eighth instance is handed its neighbour's answer."""
    def broken(P, q, A, l, u, n_eq, st, **kw):
        res = solve(P, q, A, l, u, n_eq, st, **kw)
        B = q.shape[0]
        src = torch.arange(B)
        src[::8] = (src[::8] + 1) % B
        return {k: v[src] if torch.is_tensor(v) and v.dim()
                and v.shape[0] == B else v for k, v in res.items()}
    return broken


def _variables_swapped(solve):
    """Every eighth instance is handed its neighbour's variables, its own
    objective and status kept: a wrong variable map or a stale iterate
    under a sound objective, which only ``var_gap`` can see."""
    def broken(P, q, A, l, u, n_eq, st, **kw):
        res = solve(P, q, A, l, u, n_eq, st, **kw)
        B = q.shape[0]
        src = torch.arange(B)
        src[::8] = (src[::8] + 1) % B
        res['x'] = res['x'][src]
        return res
    return broken


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name):
    assert _run(name)['correct']


@pytest.mark.parametrize('fault', [_state_unchanged, _half_left_out,
                                   _answer_altered, _variables_swapped])
@pytest.mark.parametrize('name', CELLS)
def test_fault_is_caught(name, fault, monkeypatch):
    for attr in ('admm_solve_shared', 'admm_solve'):
        monkeypatch.setattr(port_solver, attr,
                            fault(getattr(port_solver, attr)))
    out = _run(name)
    assert not out['correct']
    if fault is _variables_swapped:
        # the objectives are the sound run's: only the variables fail
        checks = out['checks']
        assert checks['var_gap']['value'] > checks['var_gap']['limit']
        assert checks['obj_gap_max']['value'] <= checks['obj_gap_max'][
            'limit']
