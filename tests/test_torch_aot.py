"""The port's AOT artifact (cvxpygen_tpu_torch/runtime/aot.py) on the CPU,
float64: the exported nonneg_LS solve, loaded in a fresh process that holds
no Family, against the port's live solve and the JAX package's export
(tests/test_aot.py); the data-dependent branches (adaptive rho, the
Newton-Schulz rescue) and K3's operator inside the exported loop."""
import collections
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import problems as problems_ref
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.runtime.aot import export_qp_solver as export_ref
from cvxpygen_tpu.runtime.aot import family_fingerprint as fingerprint_ref
from cvxpygen_tpu.runtime.aot import load_exported as load_ref
from cvxpygen_tpu.runtime.jax_family import JaxFamily
from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.runtime.aot import (export_qp_solver,
                                            family_fingerprint)
from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
from cvxpygen_tpu_torch.runtime.torch_family import (canon_batch,
                                                     qp_bounds_batch)
from cvxpygen_tpu_torch.solvers.admm import EAGER, ADMMSettings, admm_solve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# loads the program and solves theta in a fresh process that builds no
# Family (it counts the Family objects there)
_LOADER = '''
import gc, pickle, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from cvxpygen_tpu_torch.runtime.aot import load_exported
from cvxpygen_tpu_torch.canon.canonicalizer import Family
with open(sys.argv[3], 'rb') as f:
    theta = pickle.load(f)
out = [t.numpy() for t in load_exported(sys.argv[2])(theta)]
families = sum(type(o) is Family for o in gc.get_objects())
with open(sys.argv[4], 'wb') as f:
    pickle.dump((out, families), f)
'''


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _nonneg_ls():
    make, assign = problems_ref.ALL['nonneg_LS']
    prob = make()
    assign(prob, seed=1)
    fam = canon_ref(prob)
    theta = fam.pack_theta(params=prob.parameters())
    return fam, np.stack([theta, theta * 0.9])


def _load_in_fresh_process(path, T, tmp_path):
    theta_file, out_file = tmp_path / 'theta.pkl', tmp_path / 'out.pkl'
    with open(theta_file, 'wb') as f:
        pickle.dump(T, f)
    env = dict(os.environ, OMP_NUM_THREADS='1')
    subprocess.run([sys.executable, '-c', _LOADER, ROOT, path,
                    str(theta_file), str(out_file)], check=True, env=env,
                   timeout=300)
    with open(out_file, 'rb') as f:
        return pickle.load(f)


def test_export_reload_roundtrip(tmp_path):
    """nonneg_LS at B=2: the .pt2 named by the family's fingerprint, loaded
    by load_exported in a fresh process, equals the port's live solve_batch
    within 1e-12 and the JAX package's exported solve within 1e-6 / 1e-9;
    the fingerprint is the JAX package's (same maps, same layout)."""
    fam_r, T = _nonneg_ls()
    solver = CompiledQPSolver(family_from_arrays(family_to_arrays(fam_r)),
                              device='cpu')
    jf = JaxFamily.from_family(fam_r)
    assert family_fingerprint(solver.jf) == fingerprint_ref(jf)
    path, _ = export_qp_solver(solver.jf, batch_size=2,
                               cache_dir=str(tmp_path))
    assert os.path.basename(path) == f'{fingerprint_ref(jf)}_B2.pt2'
    (x, y, obj, iters, solved), families = _load_in_fresh_process(
        path, T, tmp_path)
    assert families == 0
    assert np.all(solved)
    live = solver.solve_batch(T)
    np.testing.assert_allclose(x, live['x'].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(y, live['y_canon'].numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(obj, (live['obj'] + live['d']).numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(iters, live['iters'].numpy())
    ref_path, _ = export_ref(jf, batch_size=2, cache_dir=str(tmp_path))
    ref = [np.asarray(v) for v in load_ref(ref_path)(T)]
    for got, want in zip((x, y, obj), ref[:3]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(solved, ref[4])


class _CountingFlow(type(EAGER)):
    """The eager flow, counting each branch's outcomes by the name of its
    true function ('refactor', 'rescue')."""

    def __init__(self):
        self.taken = collections.Counter()

    def branch(self, pred, true_fn, false_fn, operands):
        self.taken[true_fn.__name__, bool(pred)] += 1
        return super().branch(pred, true_fn, false_fn, operands)


def test_export_carries_branches_and_k3_operator():
    """MPC at B=2 with adaptive rho, the Newton-Schulz factor and K3
    ('always': its plain version on the CPU, through its operator): the
    exported program (while_loop, torch.cond for the refactorization and
    the rescue) equals the eager per-instance solve bit for bit.  The
    settings make both branches matter: from rho 1e-3 the eager solve
    refactors at some checks and not at others, and two warm sweeps leave a
    certificate that the rescue must repair."""
    make, assign = problems_ref.ALL['MPC']
    prob = make()
    assign(prob, seed=0)
    fam_r = canon_ref(prob)
    theta = fam_r.pack_theta(params=prob.parameters())
    T = np.stack([theta, theta * 0.97])
    st = ADMMSettings(rho=1e-3, adaptive_rho=True, kkt_solver='ns',
                      use_pallas='always', check_interval=15,
                      ns_adapt_iters=2)
    solver = CompiledQPSolver(family_from_arrays(family_to_arrays(fam_r)),
                              settings=st, device='cpu')
    data = canon_batch(solver.jf, torch.as_tensor(T))
    l, u = qp_bounds_batch(solver.jf, data['b'])
    flow = _CountingFlow()
    eager = admm_solve(data['P'], data['q'], data['A'], l, u,
                       solver.jf.n_zero, st, flow=flow)
    assert flow.taken['refactor', True] > 0
    assert flow.taken['refactor', False] > 0
    assert flow.taken['rescue', True] > 0
    _, exported = export_qp_solver(solver.jf, 2, st)
    ops = {str(n.target) for _, gm in exported.graph_module.named_modules()
           if hasattr(gm, 'graph') for n in gm.graph.nodes
           if n.op == 'call_function'}
    assert any('while_loop' in o for o in ops)
    assert any('cond' in o for o in ops)
    assert any('cvxpygen_tpu_torch.admm_iterate' in o for o in ops)
    x, y, obj, iters, solved = exported.module()(torch.as_tensor(T))
    live = solver.solve_batch(T, shared_PA=False)
    assert torch.equal(eager['iters'], live['iters'])
    assert torch.equal(x, live['x']) and torch.equal(iters, live['iters'])
    assert torch.equal(obj, live['obj'] + live['d'])
    assert bool(solved.all())


def test_export_k2_raises():
    """The whole-solve kernel K2 cannot be recorded: export raises rather
    than export its plain version."""
    fam_r, _ = _nonneg_ls()
    solver = CompiledQPSolver(family_from_arrays(family_to_arrays(fam_r)),
                              device='cpu')
    with pytest.raises(ValueError, match='K2 cannot be exported'):
        export_qp_solver(solver.jf, 4, ADMMSettings(use_pallas='full'))
