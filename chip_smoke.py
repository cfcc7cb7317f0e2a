#!/usr/bin/env python3
"""Device smoke test of the PyTorch/CUDA port (cvxpygen_tpu_torch) on one
NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build kernels K1 (csrc/admm_shared.cu), K2 (csrc/admm_full.cu) and K3
   (csrc/admm_iterate.cu), one nvcc for sm_90a each, all started together,
   and identify the card;
2. K1 against its plain torch version on the card, on the scaled MPC data
   (n=222, m=252) that the shared main path hands it, at B=256 and at the
   main path's B=2048, float32, adaptive rho on, the same chunk for both:
   same status, iterations within one check interval, x within
   1e-3 * max(1, |x|) where the iterations agree (at most 1% may stop one
   check apart, with objectives within 1e-2); kernel and plain times;
3. the shared main path at full width: MPC H=10 through generate_code ->
   solve(method='CPG'), then CompiledQPSolver.solve_batch on 2048 distinct
   x_init with the settings of bench.py:142-152; K1 must have been launched,
   every instance solved, and the objective within 1e-2 of the float64
   oracle on 128 instances;
4. K3 against its plain version on MPC per-instance scaled data at B=256
   (15 iterations from a zero start and from a mid-solve state; x, z, y
   within 1e-4 * max(1, |v|_inf), the largest entry of the instance's
   vector), then K3's time at B=2048, whose call is held to the same bar;
5. K2 against its plain version on the same data with the settings of
   bench.py:312-314 (the bar of phase 2): at B=256 at the main path's block
   (the TPU kernel's block rule: 8), at one instance per block and at block
   32 (two instances per thread block), at B=2048 (the timed call, with
   probes of where K2's time goes), and on
   the portfolio batch of phase 6 with two refinement sweeps (block 16:
   equal status, iterations and x held to twice the spread that one ulp of
   q gives the plain version, since this ill-conditioned family's float32
   iterates move with roundoff);
6. the per-instance main path at full width: the same 2048 MPC instances
   through solve_batch(theta, shared_PA=False) with use_pallas='full' (K2)
   and 'auto' (K3 once per check interval) with 12 warm Newton-Schulz
   sweeps, each solving every instance within the oracle parity bar; the K3
   route at the general row's 6 sweeps, which leave some instances unsolved
   without refinement, on the first 512 instances, its status held to the
   torch loop at kkt_refine=0 within twice the difference that K3's plain
   version shows; and the portfolio family with per-instance factor
   loadings (bench.py:460-531) at B=512 through K2 at the bench's settings
   (at most 1% unsolved, since roundoff decides a few borderline instances
   there) and with a second refinement sweep (every instance solved), both
   within the oracle parity bar; each launches its kernel;
7. a JSON line with each kernel's launches, error, times and bound;
8. the card's name and power limit (nvidia-smi), then the result line.

``python3 chip_smoke.py --block-sweep`` instead builds the kernels and runs
K2 on the portfolio and MPC general batches at several blocks, printing
instances solved, mean iterations and time per block.

It needs a CUDA device and the repository beside it: without either it
exits non-zero and prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py:142-152, the shared MPC row
BENCH_SETTINGS = dict(
    eps_abs=1e-3, eps_rel=1e-3, max_iter=2000, check_interval=15,
    ns_iters=16, ns_f32_iters=6, ns_adapt_iters=12, adaptive_rho_until=0,
    scaling=3, use_pallas='auto', kkt_refine=1, adaptive_rho=True)
# bench.py:312-314, the general (per-instance) MPC row; the other fields
# keep their defaults (ns_iters 16, ns_f32_iters 5, kkt_refine 1)
GENERAL_SETTINGS = dict(
    eps_abs=1e-3, eps_rel=1e-3, max_iter=2000, check_interval=15,
    adaptive_rho=True, scaling=3, use_pallas='full', ns_adapt_iters=6)
# bench.py:493-495, the portfolio row with per-instance factor loadings
PORTFOLIO_SETTINGS = dict(
    eps_abs=3e-4, eps_rel=3e-4, max_iter=4000, check_interval=15,
    adaptive_rho=True, use_pallas='full')
# the same with a second refinement sweep: with one, whether a few borderline
# instances of this family reach eps 3e-4 within max_iter is decided by
# float32 roundoff (PERF.md, Findings), with two every instance does
PORTFOLIO_SETTINGS_REFINE2 = dict(PORTFOLIO_SETTINGS, kkt_refine=2)
# the share of portfolio instances that may stay unsolved at the bench's
# one refinement sweep (the 1% of phase 2's bar)
PORTFOLIO_UNSOLVED_SHARE = 0.01
B_MAIN = 2048
B_CMP = 256
B_PORTFOLIO = 512
B_K3_SLICE = 512
N_ORACLE = 128
N_ORACLE_PORTFOLIO = 16
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
    """Build K1, K2 and K3 at once: one nvcc per source, in parallel."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    t0 = time.perf_counter()
    srcs = (('admm_shared.cu', k1), ('admm_full.cu', k2),
            ('admm_iterate.cu', k3))
    with ThreadPoolExecutor(len(srcs)) as ex:
        futs = [(src, ex.submit(mod.build_kernel, True)) for src, mod in srcs]
        for src, fut in futs:
            print(f'# phase 1: built csrc/{src} in {fut.result():.2f} s')
    print(f'# phase 1: all builds {time.perf_counter() - t0:.2f} s')
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
    refs = oracle_objs(fam, theta, N_ORACLE)
    t_oracle = time.perf_counter() - t0
    max_rel, n_bad = parity(obj, refs)
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
    return launches, refs


def oracle_objs(fam, theta, k):
    """The float64 oracle's objectives (canonical objective plus the
    constant d) of the first k rows of theta."""
    from cvxpygen_tpu_torch.solvers.oracle import solve_family_numpy
    refs = []
    for i in range(k):
        res, _ = solve_family_numpy(fam, theta[i])
        refs.append(res.obj + fam.canon_numpy(theta[i])[2])
    return refs


def parity(obj, refs):
    """Largest relative objective error max |o - r| / max(1, |r|) over the
    oracle's rows, and the number of non-finite objectives among them."""
    max_rel, n_bad = 0.0, 0
    for o, r in zip(obj, refs):
        if not math.isfinite(o):
            n_bad += 1
            continue
        max_rel = max(max_rel, abs(o - r) / max(1.0, abs(r)))
    return max_rel, n_bad


def per_instance_inputs(fam, prob, B, st, theta=None):
    """The scaled per-instance data that admm_solve hands to K2 for theta,
    by default B distinct MPC instances (canonical P and A per row)."""
    from cvxpygen_tpu_torch.runtime.torch_family import (
        TorchFamily, canon_batch, qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers.admm import full_kernel_args
    tf = TorchFamily.from_family(fam, device='cuda')
    if theta is None:
        theta = x_init_batch(fam, prob, B)
    data = canon_batch(tf, theta)
    l, u = qp_bounds_batch(tf, data['b'])
    return full_kernel_args(data['P'], data['q'], data['A'], l, u,
                            tf.n_zero, st)


def k3_inputs(args, st):
    """K3's inputs on the scaled data: M^-1 from the cold Newton-Schulz
    start that the K3 route computes (16 sweeps in torch.matmul)."""
    from cvxpygen_tpu_torch.solvers.admm import (full_f32_matmul,
                                                 newton_schulz_inverse)
    Ps, qs, As, ls, us, rho, _, _, _, x0, z0, y0 = args
    n = Ps.shape[-1]
    with full_f32_matmul():
        M = (Ps + st.sigma * torch.eye(n, device=Ps.device)) + torch.matmul(
            As.transpose(1, 2), As * rho[:, :, None])
        Minv = newton_schulz_inverse(M, st.ns_iters)
    return [Minv, As, qs, ls, us, rho, x0, z0, y0]


def k3_bound(n, m, B, n_iters):
    """Least time of K3's work: the larger of the FP32 operations over the
    FP32 peak and the bytes (each input read once, each output written
    once) over the HBM rate."""
    ops = 2.0 * B * n_iters * (2 * m * n + n * n)
    nbytes = 4.0 * B * (n * n + m * n + 3 * n + 7 * m)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops, nbytes)


def k3_errors(out, ref, label):
    """Hold K3's (x, z, y) against the plain version's: per instance within
    1e-4 * max(1, |v|_inf).  Returns the largest absolute difference."""
    max_abs = 0.0
    for name, o, r in zip('xzy', out, ref):
        check(bool(torch.isfinite(o).all()), f'K3 {label}: non-finite {name}')
        err = (o - r).abs()
        scale = torch.clamp(r.abs().amax(dim=1, keepdim=True), min=1.0)
        viol = float((err / scale).max())
        max_abs = max(max_abs, float(err.max()))
        print(f'# phase 4: K3 {label}, {name}: max |d| {float(err.max()):.3e},'
              f' max |d| / max(1, |{name}|_inf) {viol:.3e}')
        check(viol <= 1e-4, f'K3 {label} {name}: {viol:.3e} > 1e-4')
    return max_abs


def compare_k3(fam, prob, st, card):
    """K3 against its plain version at B=256 from a zero start and from a
    mid-solve state, then K3's time at B=2048, where the timed call is held
    against the plain version too."""
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    n_it = st.check_interval
    args = k3_inputs(per_instance_inputs(fam, prob, B_CMP, st), st)
    with full_f32_matmul():
        mid = k3.admm_iterate_plain(*args, st.sigma, st.alpha, 3 * n_it)
    max_abs = 0.0
    for start, state in (('zero start', args[6:]), ('mid-solve', mid)):
        a = args[:6] + list(state)
        out = k3.admm_iterate(*a, st.sigma, st.alpha, n_it)
        torch.cuda.synchronize()
        with full_f32_matmul():
            ref = k3.admm_iterate_plain(*a, st.sigma, st.alpha, n_it)
        max_abs = max(max_abs, k3_errors(out, ref, f'B={B_CMP} {start}'))
    args = k3_inputs(per_instance_inputs(fam, prob, B_MAIN, st), st)
    k3.admm_iterate(*args, st.sigma, st.alpha, n_it)          # warm
    ms, out = cuda_ms(lambda: k3.admm_iterate(*args, st.sigma, st.alpha,
                                                n_it), 5)
    with full_f32_matmul():
        plain_ms, ref = cuda_ms(lambda: k3.admm_iterate_plain(
            *args, st.sigma, st.alpha, n_it), 1)
    max_abs = max(max_abs, k3_errors(out, ref, f'B={B_MAIN} zero start'))
    bound_ms, bound_by, ops, nbytes = k3_bound(fam.n, fam.m, B_MAIN, n_it)
    print(f'# phase 4: K3 at B={B_MAIN}, {n_it} iterations: kernel {ms:.3f} '
          f'ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by};'
          f' {ops / 1e9:.2f} GFLOP FP32, {nbytes / 1e9:.3f} GB) [{card}]')
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def k2_bound(n, m, B, iters, stats, st, block):
    """Least time of K2's work on these inputs: the larger of the FP32
    operations over the FP32 peak and the bytes over the HBM rate.  The
    refactorizations and rescues are those of the plain version's run on
    the same inputs."""
    it = float(np.sum(iters))
    n3 = float(n) ** 3
    cold = B * (n * n * m + st.ns_iters * 2 * n3
                + (n3 if st.ns_iters > st.ns_f32_iters else 0))
    per_iter = 2 * m * n + (1 + 2 * st.kkt_refine) * n * n
    per_check = 2 * (2 * m * n + n * n)
    refactor = stats['refactor_blocks'] * block * (
        n * n * m + n3 + st.ns_adapt_iters * 2 * n3 + n3)
    rescue = stats['rescue_blocks'] * block * max(st.ns_iters, 30) * 2 * n3
    ops = 2.0 * (cold + it * per_iter + it / st.check_interval * per_check
                 + refactor + rescue)
    nbytes = 4.0 * B * (n * n + m * n + 3 * n + 5 * m + 1   # inputs
                        + n + 2 * m + 5)                    # outputs
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops)


def k2_errors(out, ref, B, block, st, label, one_check=True):
    """Hold K2's result against the plain version's, the bar of phase 2:
    equal status, x within 1e-3 * max(1, |x|) where the iterations agree,
    at most 1% of instances at other iterations, with objectives within
    1e-2, and with ``one_check`` those one check interval apart at most.
    Returns the largest absolute difference of x where the iterations
    agree."""
    x, obj, it, status = out[0], out[3], out[4], out[5]
    x_ref, obj_ref, it_ref, status_ref = ref[0], ref[3], ref[4], ref[5]
    check(bool(torch.isfinite(x).all()), f'K2 {label}: non-finite x')
    check(torch.equal(status, status_ref),
          f'K2 {label}: status differs on '
          f'{int((status != status_ref).sum())} instances')
    d_it = int((it - it_ref).abs().max())
    print(f'# phase 5: K2 {label}, B={B}: {int((it != it_ref).sum())} '
          f'instances at other iterations, at most {d_it} apart')
    if one_check:
        check(d_it <= st.check_interval, f'K2 {label}: iterations differ '
              f'by {d_it} > {st.check_interval}')
    same = it == it_ref
    err = (x - x_ref).abs()[same]
    viol = float((err / torch.clamp(x_ref[same].abs(), min=1.0)).max())
    check(viol <= 1e-3, f'K2 {label}: max |dx| / max(1, |x|) = {viol:.3e}')
    n_diff = int((~same).sum())
    check(n_diff <= B // 100, f'K2 {label}: {n_diff} instances stop at '
          'other iterations')
    obj_rel = 0.0
    if n_diff:
        o, o_ref = obj[~same], obj_ref[~same]
        obj_rel = float(((o - o_ref).abs()
                         / torch.clamp(o_ref.abs(), min=1.0)).max())
        check(obj_rel <= PARITY_BAR, f'K2 {label}: objective differs by '
              f'{obj_rel}')
    print(f'# phase 5: K2 {label}, B={B} block={block}: status equal, max '
          f'|d iters| {d_it}, mean iters {float(it.float().mean()):.2f} '
          f'(plain {float(it_ref.float().mean()):.2f}); same iterations: max '
          f'|dx| {float(err.max()):.3e} (max |dx|/max(1,|x|) {viol:.3e}); '
          f'{n_diff} instances at other iterations, objective rel '
          f'{obj_rel:.2e}')
    return float(err.max())


def compare_k2(fam, prob, st, card, portfolio):
    """K2 against its plain version on MPC at B=256 (the main path's block,
    one instance per block, and block 32: a cluster of 16 thread blocks of
    two instances each), then K2's time at B=2048 with probes of
    where it goes, the timed call held against the plain version too, and
    K2 against its plain version on the portfolio batch of phase 6."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.solvers.admm import (full_f32_matmul,
                                                 full_kernel_kwargs)
    kw = full_kernel_kwargs(st)
    main_block = k2.pick_full_block(B_MAIN, fam.m, fam.n)
    max_abs = 0.0
    for block in (main_block, 1, 32):
        args = per_instance_inputs(fam, prob, B_CMP, st)
        out = k2.admm_solve_full(*args, **kw, block=block)
        torch.cuda.synchronize()
        with full_f32_matmul():
            ref = k2.admm_solve_full_plain(*args, **kw, block=block)
        max_abs = max(max_abs, k2_errors(out, ref, B_CMP, block, st, 'MPC'))
    args = per_instance_inputs(fam, prob, B_MAIN, st)
    k2.admm_solve_full(*args, **kw, block=main_block)           # warm
    ms, out = cuda_ms(lambda: k2.admm_solve_full(*args, **kw,
                                                 block=main_block), 2)
    stats = {}
    with full_f32_matmul():
        plain_ms, ref = cuda_ms(lambda: k2.admm_solve_full_plain(
            *args, **kw, block=main_block, stats=stats), 1)
    max_abs = max(max_abs, k2_errors(out, ref, B_MAIN, main_block, st,
                                     'MPC', one_check=False))
    bound_ms, bound_by, ops = k2_bound(fam.n, fam.m, B_MAIN,
                                       ref[4].cpu().numpy(), stats, st,
                                       main_block)
    print(f'# phase 5: K2 at B={B_MAIN}: kernel {ms:.3f} ms, plain '
          f'{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; '
          f'{ops / 1e9:.2f} GFLOP FP32); mean iters '
          f'{float(out[4].float().mean()):.2f}; plain refactorizations '
          f'{stats["refactor_blocks"]}, rescues {stats["rescue_blocks"]} '
          f'[{card}]')
    # where K2's time goes: the cold factorization and one check interval,
    # then the whole solve without adaptive rho
    probes = [('cold factor + one check, adaptive off',
               dict(kw, max_iter=st.check_interval, adaptive=False)),
              ('adaptive rho off', dict(kw, adaptive=False))]
    for name, pkw in probes:
        res = k2.admm_solve_full(*args, **pkw, block=main_block)
        p_ms, _ = cuda_ms(lambda: k2.admm_solve_full(
            *args, **pkw, block=main_block), 2)
        print(f'# phase 5: K2 probe, {name}: {p_ms:.3f} ms, mean iters '
              f'{float(res[4].float().mean()):.2f} [{card}]')
    # the portfolio batch of phase 6 (n=130, m=172, B=512), with two
    # refinement sweeps, where every instance converges (phase 6)
    portfolio_k2_vs_plain(portfolio, card)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def iterate_spread(a, b):
    """Instances at other iterations, and the largest |dx| / max(1, |x|)
    where the iterations agree, between two K2 results."""
    same = a[4] == b[4]
    viol = float(((a[0] - b[0]).abs()[same]
                  / torch.clamp(b[0][same].abs(), min=1.0)).max())
    return int((~same).sum()), viol


def portfolio_k2_vs_plain(portfolio, card):
    """K2 against its plain version on the portfolio batch.  This family is
    ill-conditioned: one ulp of q moves its float32 iterates, so the bar is
    relative to that yardstick (the plain version with q one ulp up against
    the plain version): equal status; at most twice the yardstick's count
    of instances at other iterations; where the iterations agree, x within
    max(1e-3, twice the yardstick's) * max(1, |x|).  Twice, because kernel
    and plain version are two roundoff paths, as are the plain version and
    its one-ulp twin."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.solvers.admm import (
        ADMMSettings, full_f32_matmul, full_kernel_kwargs)
    pfam, ptheta, _ = portfolio
    pst = ADMMSettings(**PORTFOLIO_SETTINGS_REFINE2)
    pkw = full_kernel_kwargs(pst)
    pargs = per_instance_inputs(pfam, None, B_PORTFOLIO, pst, theta=ptheta)
    pblock = k2.pick_full_block(B_PORTFOLIO, pfam.m, pfam.n)
    out = k2.admm_solve_full(*pargs, **pkw, block=pblock)
    torch.cuda.synchronize()
    ulp_args = list(pargs)
    ulp_args[1] = pargs[1] * (1.0 + 2.0 ** -23)
    with full_f32_matmul():
        ref = k2.admm_solve_full_plain(*pargs, **pkw, block=pblock)
        ref_ulp = k2.admm_solve_full_plain(*ulp_args, **pkw, block=pblock)
    y_other, y_viol = iterate_spread(ref_ulp, ref)
    n_other, viol = iterate_spread(out, ref)
    print(f'# phase 5: K2 portfolio, B={B_PORTFOLIO} block={pblock}, '
          f'kkt_refine 2: {int((out[5] == 1).sum())} solved (plain '
          f'{int((ref[5] == 1).sum())}), status differs on '
          f'{int((out[5] != ref[5]).sum())}; {n_other} instances at other '
          f'iterations (yardstick {y_other}); same iterations: max '
          f'|dx|/max(1,|x|) {viol:.3e} (yardstick {y_viol:.3e}) [{card}]')
    check(bool(torch.isfinite(out[0]).all()), 'K2 portfolio: non-finite x')
    check(torch.equal(out[5], ref[5]), 'K2 portfolio: status differs')
    check(n_other <= 2 * y_other, f'K2 portfolio: {n_other} instances at '
          f'other iterations > twice the yardstick {y_other}')
    check(viol <= max(1e-3, 2 * y_viol), f'K2 portfolio: max |dx| / '
          f'max(1, |x|) {viol:.3e} > max(1e-3, twice {y_viol:.3e})')


def solve_and_gate(name, solver, theta, refs, counter, card, reps=3,
                   min_frac=1.0):
    """solve_batch(theta, shared_PA=False) once to warm up and ``reps``
    timed; the kernel's launch count is set to 0 just before and read just
    after.  Gates: the kernel was launched, at least ``min_frac`` of the
    instances solved, and the oracle parity bar.  Returns the launches."""
    counter.launches = 0
    out = solver.solve_batch(theta, shared_PA=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solver.solve_batch(theta, shared_PA=False)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches = counter.launches
    B = theta.shape[0]
    frac = float(np.mean(out['status'].cpu().numpy() == 1))
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    max_rel, n_bad = parity(obj, refs)
    iters = out['iters'].float()
    print(f'# phase 6: {name}, B={B}: frac_solved {frac}, mean iters '
          f'{float(iters.mean()):.2f} (max {int(iters.max())}), '
          f'{B / dt:.1f} solves/s, {1e3 * dt:.3f} ms per batch, launches '
          f'{launches}; oracle parity on {len(refs)}: max rel {max_rel:.3e} '
          f'({n_bad} non-finite) [{card}]')
    check(launches > 0, f'{name}: the kernel was not launched')
    check(frac >= min_frac, f'{name}: frac_solved {frac} < {min_frac}')
    check(n_bad == 0 and max_rel <= PARITY_BAR,
          f'{name}: oracle parity {max_rel:.3e} ({n_bad} non-finite)')
    return launches


def k3_route_status(fam, prob, card):
    """The K3 route at the general row's 6 warm sweeps on the first
    B_K3_SLICE instances: no refinement after a rough warm inverse leaves
    some instances unsolved, and which ones is decided by roundoff in the
    iterations.  Held against the torch loop at kkt_refine=0 (the same
    algorithm without the kernel): the route's status may differ from the
    loop's on at most twice as many instances as the route driven with
    K3's plain version does (the yardstick: the same iterations in torch,
    only summed in another order).  Returns K3's launches."""
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.runtime.torch_family import (
        TorchFamily, canon_batch, qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers.admm import (ADMMSettings, admm_solve,
                                                 full_f32_matmul)
    tf = TorchFamily.from_family(fam, device='cuda')
    data = canon_batch(tf, x_init_batch(fam, prob, B_MAIN)[:B_K3_SLICE])
    l, u = qp_bounds_batch(tf, data['b'])

    def solve(**over):
        st = ADMMSettings(**dict(GENERAL_SETTINGS, **over))
        return admm_solve(data['P'], data['q'], data['A'], l, u, tf.n_zero,
                          st)['status']

    def iterate_plain(*args, block=None):
        with full_f32_matmul():
            return k3.admm_iterate_plain(*args)

    kernel_iterate = k3.admm_iterate
    k3.admm_iterate.launches = 0
    route = solve(use_pallas='auto')
    launches = k3.admm_iterate.launches
    k3.admm_iterate = iterate_plain
    try:
        route_plain = solve(use_pallas='auto')
    finally:
        k3.admm_iterate = kernel_iterate
    loop = solve(use_pallas='never', kkt_solver='ns', kkt_refine=0)
    n_route = int((route != loop).sum())
    n_plain = int((route_plain != loop).sum())
    print(f'# phase 6: K3 route, ns_adapt_iters 6, first {B_K3_SLICE} '
          f'instances: solved {int((route == 1).sum())}, with K3\'s plain '
          f'version {int((route_plain == 1).sum())}, torch loop at '
          f'kkt_refine=0 {int((loop == 1).sum())}; status differs from the '
          f'loop on {n_route} (yardstick, plain version: {n_plain}), K3 '
          f'launches {launches} [{card}]')
    check(launches > 0, 'K3 route: the kernel was not launched')
    check(n_route <= 2 * n_plain, f'K3 route: status differs from the loop '
          f'on {n_route} > twice the yardstick {n_plain}')
    return launches


def portfolio_problem(ct, n=20, m=5):
    """The portfolio family of tests/problems.py:104-126 (reference
    tests/test_E2E_QP.py:76-110) in the port's modeling layer."""
    w = ct.Variable(n, name='w')
    delta_w = ct.Variable(n, name='delta_w')
    f = ct.Variable(m, name='f')
    a = ct.Parameter(n, name='a')
    F = ct.Parameter((n, m), name='F')
    Sig_f_sqrt = ct.Parameter((m, m), name='Sig_f_sqrt')
    d_sqrt = ct.Parameter(n, name='d_sqrt')
    k_tc = ct.Parameter(n, nonneg=True, name='k_tc')
    k_sh = ct.Parameter(n, nonneg=True, name='k_sh')
    w_prev = ct.Parameter(n, name='w_prev')
    L = ct.Parameter(nonneg=True, name='L')
    objective = ct.Maximize(a @ w
                            - ct.sum_squares(Sig_f_sqrt @ f)
                            - ct.sum_squares(ct.multiply(d_sqrt, w))
                            - k_tc @ ct.abs(delta_w)
                            + k_sh @ ct.minimum(0, w))
    constraints = [f == F.T @ w,
                   np.ones(n) @ w == 1,
                   ct.norm(w, 1) <= L,
                   delta_w == w - w_prev]
    return ct.Problem(objective, constraints)


def assign_portfolio(prob, seed=0, n=20, m=5):
    np.random.seed(seed)
    prob.param_dict['a'].value = np.random.randn(n)
    prob.param_dict['F'].value = np.round(np.random.randn(n, m))
    prob.param_dict['Sig_f_sqrt'].value = np.diag(np.random.rand(m))
    prob.param_dict['d_sqrt'].value = np.random.rand(n)
    prob.param_dict['k_tc'].value = 0.01 * np.ones(n)
    prob.param_dict['k_sh'].value = 0.05 * np.ones(n)
    prob.param_dict['w_prev'].value = np.zeros(n)
    prob.param_dict['L'].value = 1.6
    return prob


def portfolio_batch():
    """The portfolio family (20 assets, 5 factors), B_PORTFOLIO rows with
    per-instance rounded-normal F and normal a (bench.py:473-486), and the
    float64 oracle's objectives of the first N_ORACLE_PORTFOLIO rows."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    pprob = assign_portfolio(portfolio_problem(ct))
    pfam = canonicalize(pprob)
    check((pfam.n, pfam.m) == (130, 172),
          f'portfolio shape {pfam.n}, {pfam.m}')
    rng = np.random.default_rng(7)
    base = pfam.pack_theta(params=pprob.parameters())
    Fi = [pi for pi in pfam.param_info if pi.name == 'F'][0]
    ai = [pi for pi in pfam.param_info if pi.name == 'a'][0]
    ptheta = np.tile(base, (B_PORTFOLIO, 1))
    ptheta[:, Fi.offset:Fi.offset + Fi.flat_size] = np.round(
        rng.standard_normal((B_PORTFOLIO, Fi.flat_size)))
    ptheta[:, ai.offset:ai.offset + ai.flat_size] = rng.standard_normal(
        (B_PORTFOLIO, ai.flat_size))
    t0 = time.perf_counter()
    prefs = oracle_objs(pfam, ptheta, N_ORACLE_PORTFOLIO)
    print(f'# portfolio: n={pfam.n}, m={pfam.m}, B={B_PORTFOLIO}; oracle on '
          f'{N_ORACLE_PORTFOLIO} instances {time.perf_counter() - t0:.1f} s')
    return pfam, ptheta, prefs


def phase_per_instance(fam, prob, refs, card, portfolio):
    """The per-instance main path: MPC through K2 and through the K3 route,
    portfolio with per-instance factor loadings through K2."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings

    theta = x_init_batch(fam, prob, B_MAIN)
    st = ADMMSettings(**GENERAL_SETTINGS)
    k2_launches = solve_and_gate(
        'MPC per-instance through K2', CompiledQPSolver(fam, settings=st),
        theta, refs, k2.admm_solve_full, card)

    # the K3 route: no refinement sweep in the fused iterations, so at the
    # general row's 6 warm sweeps it is held to the torch loop without
    # refinement; with the shared row's 12 (bench.py:142-152) it solves
    # every instance
    k3_launches = k3_route_status(fam, prob, card)
    st12 = ADMMSettings(**dict(GENERAL_SETTINGS, use_pallas='auto',
                               ns_adapt_iters=12))
    k3_launches += solve_and_gate(
        'MPC per-instance through K3, ns_adapt_iters 12',
        CompiledQPSolver(fam, settings=st12), theta, refs, k3.admm_iterate,
        card, reps=1)

    pfam, ptheta, prefs = portfolio
    psolver = CompiledQPSolver(pfam,
                               settings=ADMMSettings(**PORTFOLIO_SETTINGS))
    check(not psolver._use_shared(ptheta, 'auto'),
          'portfolio batch would take the shared path')
    k2_launches += solve_and_gate(
        'portfolio varying P through K2, kkt_refine 1', psolver, ptheta,
        prefs, k2.admm_solve_full, card, reps=1,
        min_frac=1.0 - PORTFOLIO_UNSOLVED_SHARE)
    psolver.settings = ADMMSettings(**PORTFOLIO_SETTINGS_REFINE2)
    k2_launches += solve_and_gate(
        'portfolio varying P through K2, kkt_refine 2', psolver, ptheta,
        prefs, k2.admm_solve_full, card, reps=1)
    return k2_launches, k3_launches


def block_sweep(card):
    """``--block-sweep``: kernel K2 at other blocks than the main path's,
    on the portfolio batch at the bench's settings and on MPC general at
    B=2048: instances solved, mean iterations and kernel time per block.
    The block is part of K2's answer; this shows what it costs and what it
    changes on the card."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.solvers.admm import (ADMMSettings,
                                                 full_kernel_kwargs)
    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    pfam, ptheta, _ = portfolio_batch()
    cases = [('portfolio', ADMMSettings(**PORTFOLIO_SETTINGS), pfam, None,
              ptheta, (1, 4, 8, 16, 32)),
             ('MPC general', ADMMSettings(**GENERAL_SETTINGS), fam, prob,
              None, (1, 8, 16))]
    for name, st, f, pr, theta, blocks in cases:
        kw = full_kernel_kwargs(st)
        args = per_instance_inputs(f, pr, B_MAIN if theta is None
                                   else B_PORTFOLIO, st, theta=theta)
        B = args[0].shape[0]
        for block in blocks:
            k2.admm_solve_full(*args, **kw, block=block)        # warm
            ms, out = cuda_ms(lambda: k2.admm_solve_full(*args, **kw,
                                                         block=block), 2)
            print(f'# block sweep: {name}, B={B}, block {block}: solved '
                  f'{int((out[5] == 1).sum())}, mean iters '
                  f'{float(out[4].float().mean()):.2f}, kernel {ms:.3f} ms '
                  f'[{card}]')
        # at the main path's block, q moved by one or two ulp: how far
        # roundoff alone moves the count of instances solved
        block = k2.pick_full_block(B, f.m, f.n)
        for ulps in (1, -1, 2):
            a = list(args)
            a[1] = args[1] * (1.0 + ulps * 2.0 ** -23)
            out = k2.admm_solve_full(*a, **kw, block=block)
            print(f'# block sweep: {name}, block {block}, q moved {ulps:+d} '
                  f'ulp: solved {int((out[5] == 1).sum())}, mean iters '
                  f'{float(out[4].float().mean()):.2f}')


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py: no CUDA device')
    sys.path.insert(0, ROOT)
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    t_start = time.perf_counter()
    card = phase_build()
    if sys.argv[1:] == ['--block-sweep']:
        block_sweep(card)
        return
    k1_numbers = phase_kernels(card)
    k1_launches, refs = phase_main_path(card, k1_numbers['ms'])
    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    st = ADMMSettings(**GENERAL_SETTINGS)
    portfolio = portfolio_batch()
    k3_numbers = compare_k3(fam, prob, st, card)
    k2_numbers = compare_k2(fam, prob, st, card, portfolio)
    k2_launches, k3_launches = phase_per_instance(fam, prob, refs, card,
                                                  portfolio)
    kernels = [
        dict(name='admm_shared_solve', route='cuda',
             source='cvxpygen_tpu_torch/csrc/admm_shared.cu',
             replaces='cvxpygen_tpu/ops/admm_shared_kernel.py:51',
             launches=k1_launches, library_ms=None, **k1_numbers),
        dict(name='admm_solve_full', route='cuda',
             source='cvxpygen_tpu_torch/csrc/admm_full.cu',
             replaces='cvxpygen_tpu/ops/admm_full_kernel.py:42',
             launches=k2_launches, library_ms=None, **k2_numbers),
        dict(name='admm_iterate', route='cuda',
             source='cvxpygen_tpu_torch/csrc/admm_iterate.cu',
             replaces='cvxpygen_tpu/ops/admm_kernel.py:25',
             launches=k3_launches, library_ms=None, **k3_numbers)]
    print(f'# chip_smoke.py: all phases {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
