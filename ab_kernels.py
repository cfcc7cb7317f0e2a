"""Time one kernel of one checkout of the repository, to compare two
checkouts on one card: for example a commit and its parent, unpacked with
`git archive` into directories that .gitignore lists and run in turns in
one call (parent, change, change, parent).

    python3 ab_kernels.py KERNEL CHECKOUT LABEL

KERNEL is one of:

- k6: K6 (csrc/ldl_factor.cu) at the entropy family's shape (B=1024,
  N=161, Np=176, float32) on a seeded random quasidefinite K ([[G G' + I,
  C'], [C, -I]]): three runs of 20 launches after three warm-up launches;
  L, d and Linv are kept under build/ab_k6/ and each run prints its
  largest difference to every other checkout's kept there;
- k3: K3 (csrc/admm_iterate.cu), 15 iterations on the MPC per-instance
  data at B=2048 (the checkout's chip_smoke.k3_inputs): three runs of 10
  launches after one; the largest entry of x shows both compute the same;
- k2: K2 (csrc/admm_full.cu), the whole MPC general solve at B=2048,
  block 8 (bench.py:312-314 settings), and chip_smoke.py phase 5's probes
  "cold factorization + one check, adaptive rho off" and "adaptive rho
  off": three runs of one launch each after one; mean iterations and
  instances solved show both compute the same;
- k1: K1 (csrc/admm_shared.cu), the whole MPC shared solve at B=2048
  (bench.py:142-152 settings) at a pinned chunk 8, and at the checkout's
  own rho group (pick_shared_chunk) where that is another chunk: three
  runs of one call each after one; mean iterations and instances solved
  show what each computes.

- k4: K4 (csrc/cr_solve.cu) at the charging T=1440 shape (B=256; the
  checkout's chip_smoke.py set-up and its first factor, on right-hand
  sides from a seeded generator): three runs of 50 launches after one.
  Each run keeps its x under build/ab_k4/ and prints the largest |x|
  difference to every other checkout's x kept there, so parent and change
  show whether they compute the same bits.

- k7: K7 (csrc/ldl_inverse.cu) at the entropy family's shape (B=1024,
  N=161) on K6's factor of k6's seeded K: three runs of 20 launches after
  three; the lower triangle of Kinv is kept under build/ab_k7/ and each
  run prints its largest difference to every other checkout's kept there;
  then the entropy batch (the checkout's chip_smoke.py set-up, n=32,
  B=1024) solved through K6 + K7 with c drawn from default_rng(5), (6)
  and (7): for each seed, the instances solved, the mean and largest
  iterations and the parity against logsumexp(c).  Where one checkout's
  K7 computes the upper triangle and the other mirrors the lower one,
  this shows what the mirror does to the solve.
- k9, k10: K9 (ldl_factor_inverse_kernel) or K10 (ldl_kinv_kernel) on
  k6's seeded K and on K of that construction at (B=64, N=321), (4, 801)
  and (4, 1601): three runs of 20, 20, 10 and 5 launches after three, and
  K6 + K7 on the same K beside each; Kinv is kept under build/ab_k9/ or
  build/ab_k10/ and compared the same way; then the
  entropy batch (as for k7, seeds 5, 6 and 7) under CPG_LDL_FUSED=1 (k9)
  or CPG_LDL_BM_FUSED=1 (k10): solved, mean and largest iterations,
  parity; k9 also the ADP batch (the checkout's chip_smoke.py set-up,
  B=1024) through the two-level 'ldl' route under CPG_LDL_FUSED=1:
  solved, mean and largest iterations.
- k5: K5 (csrc/banded_chunk.cu) at MPC H=30, B=2048 (the checkout's
  chip_smoke.py set-up, 15 iterations from the start state): three runs
  of 5 launches after one; x, z, y, the residuals and the flags are kept
  under build/ab_k5/ and compared the same way; then one solve_batch of
  the MPC H=30 batch through the checkout's engine, its mean iterations.
- k11: K11 (csrc/banded_iterate.cu) on charging T=1440, B=256 (the
  checkout's chip_smoke.py phase 13 set-up: its batch, settings and
  shared engine arguments), kkt_refine 0 and 1: from the start state, two
  calls of one check interval (50 iterations) each, whose x, z and y are
  kept under build/ab_k11/ and compared the same way; then three runs of
  3 launches on a running state after one.
- k11state: this design of K11 only (its device scratch), on k11's set-up
  at two instances per block and B = 2, 128 and 256 (kkt_refine 0): three
  runs of 3 launches, each beside a copy of csrc/banded_iterate.cu built
  under build/ab_k11state/ without the iterations' reads and writes of z,
  y, l and u (K11_STATE_TRAFFIC; its results are not the function's), and
  the difference per iteration, which is what that traffic costs.
- k8: K8 (csrc/ldl_solve.cu) on K6's factor of k6's seeded K at the
  entropy shape (B=1024, N=161: the resident layout) and at its n=64 twin
  (B=64, N=321: the streamed layout), one seeded right-hand side each:
  three runs of 20 launches after three; x is kept under build/ab_k8/ and
  compared the same way; then the entropy batch (as for k7, seeds 5, 6 and
  7) through K6 + K8 (ldl_inverse=False): solved, mean and largest
  iterations, parity.

Builds that checkout's kernel, times it by CUDA events and prints one line
per mode.  Needs a CUDA device.  Delete build/ab_k4 ... build/ab_k11
before a new A/B."""
import os
import sys

import numpy as np
import torch


def cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def keep_and_compare(name, label, outs):
    """Keeps this run's outputs under build/<name>/ and returns the largest
    absolute difference to every other checkout's kept there."""
    keep = os.path.join(os.getcwd(), 'build', name)
    os.makedirs(keep, exist_ok=True)
    others = []
    for fname in sorted(os.listdir(keep)):
        other = torch.load(os.path.join(keep, fname))
        diff = max(float((a.cpu().double() - b.double()).abs().max())
                   for a, b in zip(outs, other))
        others.append(f'{fname[:-3]} {diff:.3e}')
    torch.save([t.cpu() for t in outs], os.path.join(keep, f'{label}.pt'))
    return ', '.join(others) or 'none yet'


def entropy_kkt(B=1024, N=161, nb=64):
    """A seeded quasidefinite batch of the entropy family's KKT shape
    (B=1024, N=161, nb=64 primal rows by default): [[G G' + I, C'],
    [C, -I]], and its pivot signs."""
    rng = np.random.default_rng(0)
    P = rng.standard_normal((B, nb, nb))
    K = np.zeros((B, N, N))
    K[:, :nb, :nb] = P @ np.swapaxes(P, 1, 2) + np.eye(nb)
    Bb = rng.standard_normal((B, N - nb, nb))
    K[:, nb:, :nb] = Bb
    K[:, :nb, nb:] = np.swapaxes(Bb, 1, 2)
    K[:, nb:, nb:] = -np.eye(N - nb)
    signs = np.concatenate([np.ones(nb), -np.ones(N - nb)])
    return torch.tensor(K, dtype=torch.float32, device='cuda'), signs


def time_k6(label):
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    lk.build_factor_kernel()
    Kc, signs = entropy_kkt()
    for _ in range(3):
        fac = lk.ldl_factor_kernel(Kc, signs, 1e-4)
    torch.cuda.synchronize()
    means = [cuda_ms(lambda: lk.ldl_factor_kernel(Kc, signs, 1e-4), 20)[0]
             for _ in range(3)]
    others = keep_and_compare('ab_k6', label,
                              [fac['L'], fac['d'], fac['Linv']])
    print(f'# K6 {label}: ' + ' '.join(f'{m:.4f}' for m in means)
          + ' ms per launch; d[0, :3] '
          + ' '.join(f'{v:.6e}' for v in fac['d'][0, :3].tolist())
          + '; max |L, d, Linv - those of| ' + others, flush=True)


def time_k7(label, cs):
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    lk.build_factor_kernel()
    lk.build_inverse_kernel()
    Kc, signs = entropy_kkt()
    fac = lk.ldl_factor_kernel(Kc, signs, 1e-4)
    for _ in range(3):
        Kinv = lk.ldl_inverse_kernel(fac)
    torch.cuda.synchronize()
    means = [cuda_ms(lambda: lk.ldl_inverse_kernel(fac), 20)[0]
             for _ in range(3)]
    N = Kinv.shape[1]
    lower = torch.tril(torch.ones(N, N, dtype=torch.bool, device='cuda'))
    others = keep_and_compare('ab_k7', label, [Kinv[:, lower]])
    print(f'# K7 {label}: ' + ' '.join(f'{m:.4f}' for m in means)
          + f' ms per launch (B={Kinv.shape[0]}, N={N}); max |Kinv| '
          f'{float(Kinv.abs().max()):.6e}; max |lower - lower of| ' + others,
          flush=True)
    entropy_solves('K7', label, cs)


def entropy_solves(tag, label, cs, **over):
    """The entropy batch (the checkout's chip_smoke.py set-up, n=32,
    B=1024) solved with c drawn from default_rng(5), (6) and (7) through the
    route the environment and the settings ``over`` pick: for each seed,
    the instances solved, the mean and largest iterations and the parity
    against logsumexp(c)."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.runtime.solver import CompiledConicSolver
    from cvxpygen_tpu_torch.solvers.ipm import IPMSettings
    prob, c = cs.entropy_problem(ct, cs.ENTROPY_N)
    cvs = {seed: np.random.default_rng(seed).normal(
        size=(cs.B_ENTROPY, cs.ENTROPY_N)) for seed in (5, 6, 7)}
    c.value = cvs[5][0]
    fam = canonicalize(prob)
    st = IPMSettings.for_dtype(torch.float32, **cs.ENTROPY_SETTINGS, **over)
    solver = CompiledConicSolver(fam, settings=st, dtype=torch.float32,
                                 device='cuda')
    for seed, cv in cvs.items():
        c.value = cv[0]
        out = solver.solve_batch(cs.entropy_batch(fam, prob, cv))
        obj = -(out['obj'] + out['d']).double().cpu().numpy()
        max_rel, n_bad = cs.parity(obj, np.log(np.sum(np.exp(cv), axis=1)))
        iters = out['iters'].float()
        print(f'# {tag} {label}: entropy seed {seed}: solved '
              f'{int((out["status"] == 1).sum())} of {cs.B_ENTROPY}, mean '
              f'iters {float(iters.mean()):.4f} (max {int(iters.max())}), '
              f'parity max rel {max_rel:.3e} ({n_bad} non-finite)',
              flush=True)


# the fused kernel's A/B shapes (B, N, launches per run): the entropy
# family's, its n=64 twin's and two where the factor lives in a device
# scratch
FUSED_SHAPES = ((1024, 161, 20), (64, 321, 20), (4, 801, 10), (4, 1601, 5))


def time_fused(mode, label, cs):
    import dataclasses
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.runtime.solver import CompiledConicSolver
    from cvxpygen_tpu_torch.solvers.ipm import IPMSettings
    tag, kname, var = {
        'k9': ('K9', 'ldl_factor_inverse_kernel', 'CPG_LDL_FUSED'),
        'k10': ('K10', 'ldl_kinv_kernel', 'CPG_LDL_BM_FUSED')}[mode]
    kern = getattr(lk, kname)
    kept = []
    for B, N, reps in FUSED_SHAPES:
        Kc, signs = entropy_kkt(B, N, (2 * N) // 5)
        for _ in range(3):
            Kinv = kern(Kc, signs, 1e-4)
        torch.cuda.synchronize()
        means = [cuda_ms(lambda: kern(Kc, signs, 1e-4), reps)[0]
                 for _ in range(3)]
        fac = lk.ldl_factor_kernel(Kc, signs, 1e-4)
        k67 = [cuda_ms(lambda: lk.ldl_factor_kernel(Kc, signs, 1e-4),
                       reps)[0]
               + cuda_ms(lambda: lk.ldl_inverse_kernel(fac), reps)[0]
               for _ in range(3)]
        kept.append(Kinv)
        print(f'# {tag} {label}: ' + ' '.join(f'{m:.4f}' for m in means)
              + f' ms per launch (B={B}, N={N}); K6 + K7 '
              + ' '.join(f'{m:.4f}' for m in k67) + f' ms; max |Kinv| '
              f'{float(Kinv.abs().max()):.6e}', flush=True)
    others = keep_and_compare(f'ab_{mode}', label, kept)
    print(f'# {tag} {label}: max |Kinv - Kinv of| ' + others, flush=True)
    os.environ[var] = '1'
    entropy_solves(tag, label + f' under {var}=1', cs)
    if mode != 'k9':
        return
    prob = cs.assign_adp(cs.adp_problem(ct))
    fam = canonicalize(prob)
    st = IPMSettings.for_dtype(torch.float32, **cs.ADP_SETTINGS)
    solver = CompiledConicSolver(fam, settings=st, dtype=torch.float32,
                                 device='cuda')
    out = solver.solve_batch(
        cs.adp_batch(fam, prob, cs.B_ADP),
        settings=dataclasses.replace(st, kkt_solver='ldl',
                                     ldl_two_level=True))
    iters = out['iters'].float()
    print(f'# K9 {label}: ADP two-level under {var}=1: solved '
          f'{int((out["status"] == 1).sum())} of {cs.B_ADP}, mean iters '
          f'{float(iters.mean()):.4f} (max {int(iters.max())})', flush=True)


def time_k8(label, cs):
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    lk.build_factor_kernel()
    lk.build_solve_kernel()
    kept = []
    for B, N, nb in ((1024, 161, 64), (64, 321, 128)):
        Kc, signs = entropy_kkt(B, N, nb)
        fac = lk.ldl_factor_kernel(Kc, signs, 1e-4)
        g = torch.Generator(device='cuda').manual_seed(0)
        b = torch.randn((B, N), generator=g, device='cuda')
        for _ in range(3):
            x = lk.ldl_solve_kernel(fac, b)
        torch.cuda.synchronize()
        means = [cuda_ms(lambda: lk.ldl_solve_kernel(fac, b), 20)[0]
                 for _ in range(3)]
        kept.append(x)
        layout = (lk.solve_plan(N)['layout'] if hasattr(lk, 'solve_plan')
                  else 'one layout')
        print(f'# K8 {label}: ' + ' '.join(f'{m:.4f}' for m in means)
              + f' ms per launch (B={B}, N={N}, {layout}); max |x| '
              f'{float(x.abs().max()):.6e}', flush=True)
    others = keep_and_compare('ab_k8', label, kept)
    print(f'# K8 {label}: max |x - x of| ' + others, flush=True)
    entropy_solves('K8', label + ' through K6 + K8', cs, ldl_inverse=False)


def k11_inputs(cs):
    """The checkout's chip_smoke.py phase 13 set-up of K11 on charging
    T=1440, B=256: its kernel module, the shared arguments (fac, meta, B0,
    B1, D_M, L_M, rho), q and the rho-scaled l and u, the rho-scaled start
    state (x, z, y), and the iteration keywords."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k11
    from cvxpygen_tpu_torch.runtime.solver import CompiledBandedQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    k11.build_iterate_kernel()
    prob = cs.charging_problem(ct)
    fam = canonicalize(prob)
    st = ADMMSettings(**cs.CHARGING_SETTINGS)
    solver = CompiledBandedQPSolver(fam, settings=st, device='cuda')
    theta = cs.charging_batch(fam, prob, cs.B_CHARGING)
    (fac, meta, B0, B1, _, _, D_M, L_M, _, _, _, rho, _, q, l, u, x, z,
     y) = cs.banded_args(solver, theta, st)
    rho3 = rho[:, :, None]
    kw = dict(sigma=st.sigma, alpha=st.alpha,
              check_interval=st.check_interval)
    return (k11, (fac, meta, B0, B1, D_M, L_M, rho), q, l * rho3, u * rho3,
            (x, (z * rho3).contiguous(), y), kw)


def time_k11(label, cs):
    k11, shared, q, ls, us, start, kw = k11_inputs(cs)
    nb, s, B = start[0].shape
    kept = []
    for refine in (0, 1):
        def call(xs, zs, ys):
            return k11.banded_iterate(*shared, q, ls, us, xs, zs, ys,
                                      kkt_refine=refine, **kw)

        xs, zs, ys = (t.clone() for t in start)
        for _ in range(2):
            call(xs, zs, ys)
        kept += [xs, zs, ys]
        xt, zt, yt = (t.clone() for t in start)
        call(xt, zt, yt)
        means = [cuda_ms(lambda: call(xt, zt, yt), 3)[0] for _ in range(3)]
        group = (k11.iterate_launch_plan(nb, s, B, refine)[0]
                 if hasattr(k11, 'iterate_launch_plan') else 1)
        print(f'# K11 {label}, kkt_refine={refine}: '
              + ' '.join(f'{m:.4f}' for m in means)
              + f' ms per launch (nb={nb}, s={s}, B={B}, '
              f'{kw["check_interval"]} iterations, group {group}); max |x| '
              f'{float(xs.abs().max()):.6e}', flush=True)
    others = keep_and_compare('ab_k11', label, kept)
    print(f'# K11 {label}: max |x, z, y - those of| ' + others, flush=True)


# csrc/banded_iterate.cu's reads and writes of z, y, l and u in its device
# scratch, each iteration's, and what k11state puts in their place: values
# made in registers, and a store that never happens but keeps every
# instance's update alive
K11_STATE_TRAFFIC = (
    ("""        float zv[G], yv[G];
        ld_vec<G>(zr + (size_t)r * nb * G, zv);
        ld_vec<G>(yr + (size_t)r * nb * G, yv);""",
     """        float zv[G], yv[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          zv[u] = 1e-3f * r;
          yv[u] = 1e-3f * u;
        }"""),
    ("""      ld_vec<G>(st.z + (size_t)o * G, zv[k]);
      ld_vec<G>(st.y + (size_t)o * G, yv[k]);
      ld_vec<G>(st.l + (size_t)o * G, lo[k]);
      ld_vec<G>(st.u + (size_t)o * G, up[k]);""",
     """#pragma unroll
      for (int u = 0; u < G; ++u) {
        zv[k][u] = 1e-3f * g;
        yv[k][u] = 0.f;
        lo[k][u] = -1.f;
        up[k][u] = 1.f;
      }"""),
    ("""      st_vec<G>(st.z + (size_t)o * G, zv[k]);
      st_vec<G>(st.y + (size_t)o * G, yv[k]);""",
     """      float t = 0.f;
#pragma unroll
      for (int u = 0; u < G; ++u) t += zv[k][u] + yv[k][u];
      if (t == 12345.f) st.z[(size_t)o * G] = t;"""))


def time_k11_state(label, cs):
    """K11 beside a copy of it built without the iterations' z, y, l, u
    traffic (K11_STATE_TRAFFIC), at two instances per block and B = 2, 128
    and 256; the difference per iteration is what that traffic costs."""
    import ctypes
    import subprocess
    from cvxpygen_tpu_torch.ops import build
    k11, shared, q, ls, us, start, kw = k11_inputs(cs)
    with open(os.path.join(build.CSRC, 'banded_iterate.cu')) as f:
        src = f.read()
    for old, new in K11_STATE_TRAFFIC:
        if src.count(old) != 1:
            sys.exit('k11state: the kernel source no longer has the state '
                     'traffic it replaces')
        src = src.replace(old, new)
    out = os.path.join(os.getcwd(), 'build', 'ab_k11state')
    os.makedirs(out, exist_ok=True)
    cu, so = (os.path.join(out, f'{label}.{e}') for e in ('cu', 'so'))
    with open(cu, 'w') as f:
        f.write(src)
    subprocess.run([build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
                    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                    '-I', build.CSRC, '-o', so, cu], check=True)
    variant = ctypes.CDLL(so)
    k11._bind_iterate(variant)
    libs = {'kernel': build._LIBS['banded_iterate'], 'no state': variant}
    nb, s, _ = start[0].shape
    r_max = ls.shape[1]
    n_it = kw['check_interval']
    for Bc in (2, 128, 256):
        sub = [t[..., :Bc].contiguous() for t in (q, ls, us)]
        st0 = [t[..., :Bc].contiguous() for t in start]
        ms = {}
        for _ in range(3):
            for name, lib in libs.items():
                build._LIBS['banded_iterate'] = lib
                xs, zs, ys = (t.clone() for t in st0)

                def call():
                    return k11.banded_iterate(*shared, *sub, xs, zs, ys,
                                              kkt_refine=0, group=2, **kw)

                call()
                ms.setdefault(name, []).append(cuda_ms(call, 3)[0])
        build._LIBS['banded_iterate'] = libs['kernel']
        per_it = [(a - b) / n_it for a, b in zip(ms['kernel'],
                                                  ms['no state'])]
        model = 4.0 * Bc * 8 * nb * r_max
        rates = ('n/a' if min(per_it) <= 0 else
                 f'{model / max(per_it) / 1e6:.0f}-'
                 f'{model / min(per_it) / 1e6:.0f}')
        print(f'# K11 state {label}, B={Bc}, 2 per block, {n_it} '
              'iterations: kernel ' + ' '.join(f'{m:.4f}' for m in
                                               ms['kernel'])
              + ' ms, without the state traffic '
              + ' '.join(f'{m:.4f}' for m in ms['no state'])
              + ' ms; difference per iteration '
              + ' '.join(f'{1e3 * d:.2f}' for d in per_it)
              + f' us; the design model\'s state bytes per iteration '
              f'{model / 1e6:.2f} MB (not a reading), so {rates} GB/s if '
              'the difference were all moving them', flush=True)


def time_k5(label, cs):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k5
    from cvxpygen_tpu_torch.runtime.solver import make_compiled_solver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    k5.build_chunk_kernel()
    prob = cs.assign_mpc(cs.mpc_problem(ct, H=30))
    fam = canonicalize(prob)
    st = ADMMSettings(**cs.MPC30_SETTINGS)
    solver = make_compiled_solver(fam, 'ADMM', settings=st, device='cuda')
    theta = cs.x_init_batch(fam, prob, 2048)
    args = cs.banded_args(solver, theta, st)
    B = theta.shape[0]
    done = torch.zeros((1, 1, B), dtype=torch.int32, device='cuda')
    kw = dict(sigma=st.sigma, alpha=st.alpha, eps_abs=st.eps_abs,
              eps_rel=st.eps_rel, check_interval=st.check_interval,
              kkt_refine=0)

    def run():
        a = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        return k5.banded_shared_chunk(*a, done, **kw)

    out = run()
    a = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
    means = [cuda_ms(lambda: k5.banded_shared_chunk(*a, done, **kw), 5)[0]
             for _ in range(3)]
    others = keep_and_compare('ab_k5', label, list(out))
    res = solver.solve_batch(theta)
    print(f'# K5 {label}: ' + ' '.join(f'{m:.4f}' for m in means)
          + f' ms per launch (B={B}, {st.check_interval} iterations); max '
          f'|x| {float(out[0].abs().max()):.6e}; max |out - out of| '
          + others + f'; the MPC H=30 solve: mean iters '
          f'{float(res["iters"].float().mean()):.4f}, solved '
          f'{int((res["status"] == 1).sum())} of {B}', flush=True)


def time_k4(label, cs):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k4
    from cvxpygen_tpu_torch.runtime.solver import CompiledBandedQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    k4.build_cr_kernel()
    prob = cs.charging_problem(ct)
    fam = canonicalize(prob)
    st = ADMMSettings(**cs.CHARGING_SETTINGS)
    solver = CompiledBandedQPSolver(fam, settings=st, device='cuda')
    theta = cs.charging_batch(fam, prob, cs.B_CHARGING)
    args = cs.banded_args(solver, theta, st)
    fac, meta = args[0], args[1]
    nb, s, B = solver.struct.nb, solver.struct.s, theta.shape[0]
    g = torch.Generator(device='cuda').manual_seed(0)
    b = torch.randn((nb, s, B), generator=g, device='cuda')
    x = k4.cr_solve(fac, meta, b)
    means = [cuda_ms(lambda: k4.cr_solve(fac, meta, b), 50)[0]
             for _ in range(3)]
    others = keep_and_compare('ab_k4', label, [x])
    print(f'# K4 {label}: ' + ' '.join(f'{m:.4f}' for m in means)
          + f' ms per launch (nb={nb}, s={s}, B={B}); max |x| '
          f'{float(x.abs().max()):.6e}; max |x - x of| ' + others,
          flush=True)


def mpc_general(cs):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    prob = cs.assign_mpc(cs.mpc_problem(ct))
    st = ADMMSettings(**cs.GENERAL_SETTINGS)
    return canonicalize(prob), prob, st


def time_k3(label, cs):
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    k3.build_kernel()
    fam, prob, st = mpc_general(cs)
    args = cs.k3_inputs(cs.per_instance_inputs(fam, prob, 2048, st), st)
    n_it = st.check_interval

    def run():
        return k3.admm_iterate(*args, st.sigma, st.alpha, n_it)

    run()
    means, out = [], None
    for _ in range(3):
        ms, out = cuda_ms(run, 10)
        means.append(ms)
    print(f'# K3 {label}: ' + ' '.join(f'{m:.4f}' for m in means)
          + f' ms per launch (B=2048, {n_it} iterations); max |x| '
          f'{float(out[0].abs().max()):.6e}', flush=True)


def time_k2(label, cs):
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.solvers.admm import full_kernel_kwargs
    k2.build_kernel()
    fam, prob, st = mpc_general(cs)
    args = cs.per_instance_inputs(fam, prob, 2048, st)
    kw = full_kernel_kwargs(st)
    for name, pkw in (('whole solve', kw),
                      ('cold factorization + one check, adaptive off',
                       dict(kw, max_iter=st.check_interval, adaptive=False)),
                      ('adaptive rho off', dict(kw, adaptive=False))):

        def run():
            return k2.admm_solve_full(*args, **pkw, block=8)

        run()
        means, out = [], None
        for _ in range(3):
            ms, out = cuda_ms(run, 1)
            means.append(ms)
        print(f'# K2 {label}, {name}: ' + ' '.join(f'{m:.3f}' for m in means)
              + f' ms (B=2048, block 8); mean iters '
              f'{float(out[4].float().mean()):.2f}, solved '
              f'{int((out[5] == 1).sum())}', flush=True)


def time_k1(label, cs):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    from cvxpygen_tpu_torch.solvers.admm_shared import kernel_kwargs
    k1.build_kernel()
    prob = cs.assign_mpc(cs.mpc_problem(ct))
    fam, st, B = canonicalize(prob), ADMMSettings(**cs.BENCH_SETTINGS), 2048
    args = cs.k1_inputs(fam, cs.x_init_batch(fam, prob, B), st, 'cuda')
    group = k1.pick_shared_chunk(B, fam.m, fam.n)
    for chunk in sorted({8, group}):
        kw = dict(kernel_kwargs(st), chunk=chunk)

        def run():
            return k1.admm_shared_solve(*args, **kw)

        run()
        means, out = [], None
        for _ in range(3):
            ms, out = cuda_ms(run, 1)
            means.append(ms)
        print(f'# K1 {label}, chunk {chunk}: ' + ' '.join(
            f'{m:.3f}' for m in means) + f' ms (B={B}); mean iters '
            f'{float(out[3].float().mean()):.2f}, solved '
            f'{int((out[4] == 1).sum())}', flush=True)


def main():
    kernel, root, label = sys.argv[1], sys.argv[2], sys.argv[3]
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from cvxpygen_tpu_torch.ops import build
    for mod in (cs, build):
        if not mod.__file__.startswith(root):
            sys.exit(f'imported {mod.__file__}, not the checkout {root}')
    if kernel == 'k6':
        time_k6(label)
    elif kernel == 'k7':
        time_k7(label, cs)
    elif kernel in ('k9', 'k10'):
        time_fused(kernel, label, cs)
    elif kernel == 'k5':
        time_k5(label, cs)
    elif kernel == 'k8':
        time_k8(label, cs)
    elif kernel == 'k11':
        time_k11(label, cs)
    elif kernel == 'k11state':
        time_k11_state(label, cs)
    elif kernel == 'k4':
        time_k4(label, cs)
    elif kernel == 'k3':
        time_k3(label, cs)
    elif kernel == 'k2':
        time_k2(label, cs)
    elif kernel == 'k1':
        time_k1(label, cs)
    else:
        sys.exit(f'unknown kernel {kernel!r}: k1, k2, k3, k4, k5, k6, k7, '
                 'k8, k9, k10, k11 or k11state')


if __name__ == '__main__':
    main()
