"""Spawned torch.distributed worlds for the port's parallel tests.

``start_world(fn, size, tmp_path, payload)`` starts ``size`` processes (the
'spawn' method), each of which joins a gloo world through a FileStore under
``tmp_path`` (TCP ports collide between test workers) with one BLAS thread,
runs ``fn(rank, payload)`` and pickles its result; ``join_world`` returns
the results by rank, so that the parent computes its references while the
world runs.  The bodies below import torch and the port only: the children
never load JAX.
"""
import multiprocessing
import os
import pickle
import traceback

import numpy as np

WORLD_TIMEOUT_S = 300


def _child(fn, rank, size, tmp, payload):
    from threadpoolctl import threadpool_limits
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = os.path.join(tmp, f'rank{rank}.pkl')
    try:
        with threadpool_limits(1):
            store = dist.FileStore(os.path.join(tmp, 'store'), size)
            dist.init_process_group('gloo', store=store, rank=rank,
                                    world_size=size)
            try:
                result = fn(rank, payload)
            finally:
                dist.destroy_process_group()
    except BaseException:
        result = {'error': traceback.format_exc()}
    with open(out, 'wb') as f:
        pickle.dump(result, f)


def start_world(fn, size, tmp_path, payload):
    tmp = str(tmp_path)
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_child, args=(fn, r, size, tmp, payload))
             for r in range(size)]
    for p in procs:
        p.start()
    return procs, tmp


def join_world(handle):
    """Results of ``fn(rank, payload)`` by rank; raises with a rank's
    traceback if one failed, and kills ranks that outlive the timeout."""
    procs, tmp = handle
    for p in procs:
        p.join(WORLD_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f'{len(alive)} ranks did not finish in time'
    results = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f'rank{r}.pkl'), 'rb') as f:
            res = pickle.load(f)
        if isinstance(res, dict) and 'error' in res:
            raise RuntimeError(f'rank {r} failed:\n{res["error"]}')
        results.append(res)
    return results


def _numpy(out):
    return {k: v.numpy() if hasattr(v, 'numpy') else v
            for k, v in out.items()}


def k2_settings():
    """Kernel K2's plain version with adaptive rho: its refactorization acts
    on whole blocks."""
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    return ADMMSettings(use_pallas='full_interpret', kkt_solver='ns',
                        adaptive_rho=True)


def small_qp(B, n=4, m=6, seed=0):
    """A batch of B random box-constrained QPs (float64), each with its own
    P and A."""
    import torch
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    P = G @ G.transpose(0, 2, 1) + np.eye(n)
    data = (P, rng.standard_normal((B, n)), rng.standard_normal((B, m, n)),
            -np.ones((B, m)), np.ones((B, m)))
    return tuple(torch.as_tensor(a) for a in data)


def parallel_world(rank, payload):
    """The body of tests/test_torch_parallel.py's 4-rank world: a
    ('batch', 'model') = (2, 2) mesh; ``sharded_solve`` over its 2-rank
    batch axis, ``make_sharded_qp_solve`` over both, and each solver with a
    1-rank group against the plain call."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from cvxpygen_tpu_torch.parallel.mesh import (make_mesh,
                                                  make_sharded_qp_solve,
                                                  sharded_solve)
    from cvxpygen_tpu_torch.runtime.solver import (CompiledConicSolver,
                                                   CompiledQPSolver)
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings, admm_solve
    from cvxpygen_tpu_torch.solvers.admm_shared import admm_solve_shared
    from cvxpygen_tpu_torch.runtime.torch_family import (
        canon_batch, canon_batch_shared, qp_bounds_batch)

    mesh = make_mesh(axes=('batch', 'model'), shape=(2, 2), device='cpu')
    mpc, T = payload['mpc'], payload['T']
    out = {}
    solver = CompiledQPSolver(mpc, device='cpu')
    out['shared'] = _numpy(sharded_solve(solver, T, mesh))
    out['per_instance'] = _numpy(sharded_solve(solver, T, mesh,
                                               shared_PA=False))
    socp = CompiledConicSolver(payload['socp'], device='cpu')
    out['socp'] = _numpy(sharded_solve(socp, payload['T_socp'], mesh))
    out['socp_single'] = _numpy(socp.solve_batch(payload['T_socp']))

    # the model axis: the default settings ('inv' on the CPU, as the JAX
    # package's test runs), and the Newton-Schulz sweeps with adaptive rho
    out['model_inv'] = _numpy(make_sharded_qp_solve(
        solver.jf, mesh, ADMMSettings())(T[:4]))
    ns = ADMMSettings(kkt_solver='ns', adaptive_rho=True, check_interval=15,
                      ns_adapt_iters=12, use_pallas='never')
    out['model_ns'] = _numpy(make_sharded_qp_solve(solver.jf, mesh, ns)(
        T[:4]))
    out['model_ns_single'] = _numpy(solver.solve_batch(
        T[:4], settings=ns, shared_PA=False))

    # kernel K1's rho group comes from the whole batch: B=8 has the group 8,
    # which a rank of 4 instances cannot hold
    k1 = ADMMSettings(kkt_solver='ns', use_pallas='full_interpret',
                      adaptive_rho=True)
    try:
        sharded_solve(solver, T, mesh, settings=k1)
        out['k1_raise'] = None
    except ValueError as e:
        out['k1_raise'] = str(e)
    # kernel K2's block also comes from the whole batch: MPC at B=8 has the
    # block 4 (float64), which each rank holds; a small QP at B=32 has the
    # block 32, which a rank of 16 cannot hold
    k2 = k2_settings()
    out['full'] = _numpy(sharded_solve(solver, T, mesh, settings=k2,
                                       shared_PA=False))
    batch = mesh.get_group('batch')
    P, q, A, l, u = small_qp(32)
    lo = dist.get_rank(batch) * 16
    try:
        admm_solve(P[lo:lo + 16], q[lo:lo + 16], A[lo:lo + 16],
                   l[lo:lo + 16], u[lo:lo + 16], 0, k2, group=batch)
        out['k2_raise'] = None
    except ValueError as e:
        out['k2_raise'] = str(e)

    # with a group of 2 pinned, each rank holds two whole groups
    lo = dist.get_rank(batch) * 4
    data = canon_batch_shared(solver.jf, T)
    l, u = qp_bounds_batch(solver.jf, data['b'])
    args = (data['P'], data['q'], data['A'], l, u, solver.jf.n_zero, k1)
    out['k1_single'] = _numpy(admm_solve_shared(*args, chunk=2))
    rows = slice(lo, lo + 4)
    out['k1_sharded'] = _numpy(admm_solve_shared(
        data['P'], data['q'][rows], data['A'], l[rows], u[rows],
        solver.jf.n_zero, k1, chunk=2, group=batch))

    # group=None changes nothing: a 1-rank group gives the plain call's
    # results bit for bit
    ones = [dist.new_group([r]) for r in range(dist.get_world_size())]
    one = ones[rank]
    adaptive = dataclasses.replace(ns, use_pallas='auto')
    same = {}
    for name, st in (('shared_loop', adaptive),
                     ('shared_inv', ADMMSettings(adaptive_rho=True))):
        a = admm_solve_shared(*args[:6], st)
        b = admm_solve_shared(*args[:6], st, group=one)
        same[name] = all(torch.equal(a[k], b[k]) for k in a)
    dense = canon_batch(solver.jf, T)
    l, u = qp_bounds_batch(solver.jf, dense['b'])
    for name, st in (('per_instance_ns', adaptive),
                     ('per_instance_inv', ADMMSettings(adaptive_rho=True))):
        pargs = (dense['P'], dense['q'], dense['A'], l, u, solver.jf.n_zero,
                 st)
        a, b = admm_solve(*pargs), admm_solve(*pargs, group=one)
        same[name] = all(torch.equal(a[k], b[k]) for k in a)
    a = socp.solve_batch(payload['T_socp'])
    b = socp.solve_batch(payload['T_socp'], group=one)
    same['ipm'] = all(torch.equal(a[k], b[k]) for k in a)
    out['one_rank_same'] = same
    return out


def consensus_world(rank, payload):
    """The body of tests/test_torch_consensus.py's 2-rank world."""
    from cvxpygen_tpu_torch.parallel.consensus import consensus_solve
    from cvxpygen_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, device='cpu')
    out = consensus_solve(payload['fam'], payload['thetas'],
                          [('v', np.arange(payload['k']))], rho_c=2.0,
                          outer_iters=100, eps_consensus=1e-5, mesh=mesh,
                          device='cpu')
    return _numpy(out)
