#!/usr/bin/env python3
"""Device smoke test of the PyTorch/CUDA port (cvxpygen_tpu_torch) on one
NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build kernel K1 (csrc/admm_shared.cu, nvcc for sm_90a) and identify the
   card;
2. K1 against its plain torch version on the card, on the scaled MPC data
   (n=222, m=252) that the main path hands it, at B=256 and at the main
   path's B=2048, float32, adaptive rho on, the same chunk for both: same
   status, iterations within one check interval, x within
   1e-3 * max(1, |x|) where the iterations agree (at most 1% may stop one
   check apart, with objectives within 1e-2); kernel and plain times;
3. the main path at full width: MPC H=10 through generate_code ->
   solve(method='CPG'), then CompiledQPSolver.solve_batch on 2048 distinct
   x_init with the settings of bench.py:142-152; K1 must have been launched,
   every instance solved, and the objective within 1e-2 of the float64
   oracle on 128 instances;
4. a JSON line with each kernel's launches, error, times and bound;
5. the card's name and power limit (nvidia-smi), then the result line.

It needs a CUDA device and the repository beside it: without either it
exits non-zero and prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py:142-152, the shared MPC row
BENCH_SETTINGS = dict(
    eps_abs=1e-3, eps_rel=1e-3, max_iter=2000, check_interval=15,
    ns_iters=16, ns_f32_iters=6, ns_adapt_iters=12, adaptive_rho_until=0,
    scaling=3, use_pallas='auto', kkt_refine=1, adaptive_rho=True)
B_MAIN = 2048
B_CMP = 256
N_ORACLE = 128
PARITY_BAR = 1e-2
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate
FP32_PEAK = 67e12
HBM_RATE = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def mpc_problem(ct, H=10, n=6, m=3):
    """The MPC family of tests/problems.py:65-101 (reference
    tests/test_E2E_QP.py:43-73) in the port's modeling layer."""
    U = ct.Variable((m, H), name='U')
    X = ct.Variable((n, H + 1), name='X')
    Psqrt = ct.Parameter((n, n), name='Psqrt', diag=True)
    Qsqrt = ct.Parameter((n, n), name='Qsqrt', diag=True)
    Rsqrt = ct.Parameter((m, m), name='Rsqrt', diag=True)
    nonzeros_A = [(i, i) for i in range(n)] + [(i, 3 + i) for i in range(n // 2)]
    A = ct.Parameter((n, n), name='A', sparsity=tuple(zip(*nonzeros_A)))
    nonzeros_B = [(3 + i, i) for i in range(n // 2)]
    B = ct.Parameter((n, m), name='B', sparsity=tuple(zip(*nonzeros_B)))
    x_init = ct.Parameter(n, name='x_init')
    objective = ct.Minimize(
        ct.sum_squares(Psqrt @ X[:, H - 1]) + ct.sum_squares(Qsqrt @ X[:, :H])
        + ct.sum_squares(Rsqrt @ U) + 1)
    constraints = [X[:, 1:] == A @ X[:, :H] + B @ U,
                   ct.abs(U) <= 1,
                   X[:, 0] == x_init]
    return ct.Problem(objective, constraints)


def assign_mpc(prob, seed=0):
    np.random.seed(seed)
    n = 6
    A_cont = np.concatenate((np.array([[0, 0, 0, 1, 0, 0],
                                       [0, 0, 0, 0, 1, 0],
                                       [0, 0, 0, 0, 0, 1.]]),
                             np.zeros((3, 6))), axis=0)
    B_cont = np.concatenate((np.zeros((3, 3)), np.diag(np.ones(3))), axis=0)
    td = 0.1
    prob.param_dict['A'].value = np.eye(n) + td * A_cont
    prob.param_dict['B'].value = td * B_cont
    prob.param_dict['Psqrt'].value = np.eye(6)
    prob.param_dict['Qsqrt'].value = np.eye(6)
    prob.param_dict['Rsqrt'].value = np.sqrt(0.1) * np.eye(3)
    prob.param_dict['x_init'].value = -2 * np.ones(6) + 4 * np.random.rand(6)
    return prob


def x_init_batch(fam, prob, B, seed=0):
    """B distinct instances: same dynamics and weights, x_init drawn as in
    bench.py:132-136."""
    base = fam.pack_theta(params=prob.parameters())
    xi = [pi for pi in fam.param_info if pi.name == 'x_init'][0]
    theta = np.tile(base, (B, 1))
    theta[:, xi.offset:xi.offset + xi.flat_size] = np.random.default_rng(
        seed).uniform(-2.0, 2.0, (B, xi.flat_size))
    return theta


def card_line():
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f'nvidia-smi failed: {res.stderr}')
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def k1_bound(n, m, B, iters, refactors, st):
    """Least time of K1's work on these inputs: the larger of the FP32
    operations over the FP32 peak and the bytes over the HBM rate."""
    it = float(np.sum(iters))
    per_iter = 2.0 * (2 * m * n + (1 + 2 * st.kkt_refine) * n * n)
    per_check = 2.0 * (4 * m * n + 2 * n * n)
    per_refactor = 2.0 * (n * n * m + n ** 3 + st.ns_adapt_iters * 2 * n ** 3)
    ops = (it * per_iter + it / st.check_interval * per_check
           + refactors * per_refactor)
    words = (3 * n * n + 2 * m * n + 2 * m + n          # shared inputs
             + B * (2 * n + 4 * m)                      # q, x0, l, u, z0, y0
             + B * (n + 2 * m + 4))                     # x, z, y, 4 scalars
    t_ops, t_bytes = ops / FP32_PEAK, 4.0 * words / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops)


def phase_build():
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    secs = k1.build_kernel(verbose=True)
    print(f'# phase 1: built csrc/admm_shared.cu in {secs:.2f} s')
    card = card_line()
    print(f'# card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}; allow_tf32 matmul='
          f'{torch.backends.cuda.matmul.allow_tf32} cudnn='
          f'{torch.backends.cudnn.allow_tf32}')
    return card


def k1_inputs(fam, theta, st, dev):
    from cvxpygen_tpu_torch.runtime.torch_family import (
        TorchFamily, canon_batch_shared, qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers.admm_shared import shared_kernel_args
    tf = TorchFamily.from_family(fam, device=dev)
    data = canon_batch_shared(tf, theta)
    l, u = qp_bounds_batch(tf, data['b'])
    return shared_kernel_args(data['P'], data['q'], data['A'], l, u,
                              tf.n_zero, st)


def compare_k1(fam, prob, B, st, card, timed):
    """K1 and its plain version on the same scaled MPC data; returns the
    error and, when ``timed``, the times and the bound."""
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    from cvxpygen_tpu_torch.solvers.admm_shared import kernel_kwargs
    args = k1_inputs(fam, x_init_batch(fam, prob, B), st, 'cuda')
    kw = dict(kernel_kwargs(st), chunk=k1.pick_shared_chunk(B, fam.m, fam.n))
    out = k1.admm_shared_solve(*args, **kw)
    torch.cuda.synchronize()
    stats = {}
    with full_f32_matmul():
        ref = k1.admm_shared_solve_plain(*args, **kw, stats=stats)
    torch.cuda.synchronize()
    x, it, status = out[0], out[3], out[4]
    x_ref, it_ref, status_ref = ref[0], ref[3], ref[4]
    check(bool(torch.isfinite(x).all()), f'B={B}: non-finite kernel x')
    check(torch.equal(status, status_ref),
          f'B={B}: kernel status differs from the plain version on '
          f'{int((status != status_ref).sum())} instances')
    d_it = int((it - it_ref).abs().max())
    check(d_it <= st.check_interval,
          f'B={B}: iterations differ by {d_it} > {st.check_interval}')
    # x is held at 1e-3 where both stopped at the same iteration.  Where
    # summation order moved a convergence check by one interval, the two
    # are converged iterates check_interval iterations apart: those must be
    # rare and agree in objective at the oracle parity bar instead.
    same = it == it_ref
    err = (x - x_ref).abs()[same]
    viol = float((err / torch.clamp(x_ref[same].abs(), min=1.0)).max())
    max_abs = float(err.max())
    check(viol <= 1e-3, f'B={B}: max |dx| / max(1, |x|) = {viol:.3e} > 1e-3')
    n_diff = int((~same).sum())
    check(n_diff <= B // 100, f'B={B}: {n_diff} instances stop at another '
          'iteration')
    obj_rel = 0.0
    if n_diff:
        Ps, qs, c_inv = args[0], args[1], args[8]

        def obj(xs):
            return c_inv * (0.5 * ((xs @ Ps) * xs).sum(1)
                            + (qs[~same] * xs).sum(1))
        o, o_ref = obj(x[~same]), obj(x_ref[~same])
        obj_rel = float(((o - o_ref).abs()
                         / torch.clamp(o_ref.abs(), min=1.0)).max())
        check(obj_rel <= PARITY_BAR, f'B={B}: objective differs by {obj_rel}')
    line = (f'# phase 2: B={B} chunk={kw["chunk"]}: status equal, max |d iters|'
            f' {d_it}, mean iters {float(it.float().mean()):.2f} (plain '
            f'{float(it_ref.float().mean()):.2f}); same iterations: max |dx| '
            f'{max_abs:.3e} (max |dx|/max(1,|x|) {viol:.3e}); {n_diff} '
            f'instances one check apart, objective rel {obj_rel:.2e}; plain '
            f'refactorizations {stats["refactors"]}')
    print(line)
    if not timed:
        return dict(max_abs_err=max_abs)
    k1.admm_shared_solve(*args, **kw)            # warm
    ms, _ = cuda_ms(lambda: k1.admm_shared_solve(*args, **kw), 3)
    with full_f32_matmul():
        plain_ms, _ = cuda_ms(
            lambda: k1.admm_shared_solve_plain(*args, **kw), 1)
    bound_ms, bound_by, ops = k1_bound(fam.n, fam.m, B, it_ref.cpu().numpy(),
                                       stats['refactors'], st)
    print(f'# phase 2: K1 at B={B}: kernel {ms:.3f} ms, plain {plain_ms:.3f} '
          f'ms, bound {bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP '
          f'FP32) [{card}]')
    # where K1's time goes: the same batch without adaptive rho (no
    # refactorization), and one check interval without and with a forced
    # refactorization of every chunk (rho_tol just above 1)
    probes = [('adaptive rho off', dict(kw, adaptive=False)),
              ('one check, no refactor',
               dict(kw, max_iter=st.check_interval, adaptive=False)),
              ('one check + one refactor per chunk',
               dict(kw, max_iter=st.check_interval, rho_tol=1.0 + 1e-6))]
    for name, pkw in probes:
        res = k1.admm_shared_solve(*args, **pkw)
        p_ms, _ = cuda_ms(lambda: k1.admm_shared_solve(*args, **pkw), 3)
        print(f'# phase 2: K1 probe, {name}: {p_ms:.3f} ms, mean iters '
              f'{float(res[3].float().mean()):.2f} [{card}]')
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(card):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    check((fam.n, fam.m) == (222, 252), f'MPC shape {fam.n}, {fam.m}')
    st = ADMMSettings(**BENCH_SETTINGS)
    compare_k1(fam, prob, B_CMP, st, card, timed=False)
    return compare_k1(fam, prob, B_MAIN, st, card, timed=True)


def phase_main_path(card, k1_ms):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    from cvxpygen_tpu_torch.solvers.oracle import solve_family_numpy

    k1.admm_shared_solve.launches = 0
    # generated package, one instance through problem.solve(method='CPG')
    prob = assign_mpc(mpc_problem(ct))
    val_oracle = prob.solve()
    code_dir = os.path.join(ROOT, 'build', 'chip_smoke', 'mpc_code')
    cpg.generate_code(prob, code_dir=code_dir, solver='ADMM')
    t0 = time.perf_counter()
    val = prob.solve(method='CPG')
    t_cpg = time.perf_counter() - t0
    rel = abs(val - val_oracle) / max(1.0, abs(val_oracle))
    check(prob.status == 'optimal', f'CPG status {prob.status}')
    check(rel <= PARITY_BAR, f'CPG objective {val} vs oracle {val_oracle}')
    print(f'# phase 3: solve(method=CPG) optimal, objective {val:.6f} vs '
          f'oracle {val_oracle:.6f} (rel {rel:.2e}), '
          f'{prob.solver_stats.num_iters} iters, {1e3 * t_cpg:.2f} ms first '
          f'call [{card}]')

    # B distinct x_init instances through the compiled solver
    fam = canonicalize(prob)
    theta = x_init_batch(fam, prob, B_MAIN)
    solver = CompiledQPSolver(fam, settings=ADMMSettings(**BENCH_SETTINGS))
    check(solver.jf.maps.dtype == torch.float32, 'float32 on the card')
    out = solver.solve_batch(theta)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solver.solve_batch(theta)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches = k1.admm_shared_solve.launches
    check(launches > 0, 'the main path did not launch kernel K1')
    status = out['status'].cpu().numpy()
    frac = float(np.mean(status == 1))
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    check(bool(np.all(np.isfinite(out['x'].cpu().numpy()))), 'non-finite x')
    t0 = time.perf_counter()
    max_rel, n_bad = 0.0, 0
    for i in range(N_ORACLE):
        res, _ = solve_family_numpy(fam, theta[i])
        ref = res.obj + fam.canon_numpy(theta[i])[2]
        if not math.isfinite(obj[i]):
            n_bad += 1
            continue
        max_rel = max(max_rel, abs(obj[i] - ref) / max(1.0, abs(ref)))
    t_oracle = time.perf_counter() - t0
    iters = out['iters'].float()
    print(f'# phase 3: solve_batch B={B_MAIN}: frac_solved {frac}, mean iters '
          f'{float(iters.mean()):.2f} (max {int(iters.max())}), '
          f'{B_MAIN / dt:.1f} solves/s, {1e3 * dt:.3f} ms per batch (K1 '
          f'{k1_ms:.3f} ms of it, phase 2), K1 launches {launches} [{card}]')
    print(f'# phase 3: oracle parity on {N_ORACLE} instances: max rel '
          f'{max_rel:.3e} ({n_bad} non-finite; oracle {t_oracle:.1f} s)')
    check(frac == 1.0, f'frac_solved {frac} < 1')
    check(n_bad == 0 and max_rel <= PARITY_BAR,
          f'oracle parity {max_rel:.3e} ({n_bad} non-finite) > {PARITY_BAR}')
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py: no CUDA device')
    sys.path.insert(0, ROOT)
    card = phase_build()
    k1_numbers = phase_kernels(card)
    launches = phase_main_path(card, k1_numbers['ms'])
    kernel = dict(
        name='admm_shared_solve', route='cuda',
        source='cvxpygen_tpu_torch/csrc/admm_shared.cu',
        replaces='cvxpygen_tpu/ops/admm_shared_kernel.py:51',
        launches=launches, library_ms=None, **k1_numbers)
    print(json.dumps({'kernels': [kernel]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
