"""The port's per-stage profiler and trace (cvxpygen_tpu_torch/runtime/
profiling.py) on the CPU, float64, beside the JAX package's
(tests/test_parallel.py::test_profiling_breakdown): the same keys, each
positive, and the same mean iterations on the same MPC instances."""
import json

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import problems as problems_ref
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.runtime.jax_family import JaxFamily
from cvxpygen_tpu.runtime.profiling import profile_qp_solve as profile_ref
from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.runtime.profiling import profile_qp_solve, trace
from cvxpygen_tpu_torch.runtime.torch_family import TorchFamily


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(scope='module')
def mpc():
    make, assign = problems_ref.ALL['MPC']
    prob = make()
    fam = canon_ref(prob)
    thetas = []
    for seed in range(2):
        assign(prob, seed=seed)
        thetas.append(fam.pack_theta(params=prob.parameters()))
    tf = TorchFamily.from_family(family_from_arrays(family_to_arrays(fam)),
                                 device='cpu')
    return fam, tf, np.stack(thetas)


def test_profile_keys_match_reference(mpc):
    """Every key of the JAX package's profile, each positive, and the whole
    solve's mean iterations equal to the reference's."""
    fam, tf, T = mpc
    with threadpool_limits(1):
        ref = profile_ref(JaxFamily.from_family(fam), T, reps=1)
    prof = profile_qp_solve(tf, T, reps=1)
    assert set(prof) == set(ref)
    for key, value in prof.items():
        assert value > 0, (key, prof)
    assert 'iterate_25_ms' in prof
    assert prof['mean_iters'] == ref['mean_iters']


@pytest.mark.parametrize('use_pallas, k3_block', [('auto', None),
                                                   ('always', 1)])
def test_iterate_stage_runs_the_solve_route(mpc, monkeypatch, use_pallas,
                                            k3_block):
    """The profile's check-interval stage runs the solve's own
    ``iterate_interval`` on the solve's own route: on the CPU 'auto' is
    the refined loop (KKT mode 'inv'), 'always' kernel K3 (its plain
    version here)."""
    from cvxpygen_tpu_torch.solvers import admm
    _, tf, T = mpc
    route = admm.iterate_interval
    seen = []

    def recorded(st, kkt_mode, block, *args, **kw):
        seen.append((kkt_mode, block))
        return route(st, kkt_mode, block, *args, **kw)

    monkeypatch.setattr(admm, 'iterate_interval', recorded)
    st = admm.ADMMSettings(use_pallas=use_pallas, max_iter=50)
    profile_qp_solve(tf, T, settings=st, reps=1)
    assert len(seen) > 2
    assert set(seen) == {('inv', k3_block)}


def test_trace_writes_chrome_trace(mpc, tmp_path):
    """trace() around a profile writes a Chrome trace of torch's ops."""
    _, tf, T = mpc
    with trace(str(tmp_path)):
        profile_qp_solve(tf, T[:1], reps=1)
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    assert any('matmul' in e.get('name', '') for e in events)
