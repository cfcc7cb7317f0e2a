"""Time one kernel of one checkout of the repository, to compare two
checkouts on one card: for example a commit and its parent, unpacked with
`git archive` into directories that .gitignore lists and run in turns in
one call (parent, change, change, parent).

    python3 ab_kernels.py KERNEL CHECKOUT LABEL

KERNEL is one of:

- k6: K6 (csrc/ldl_factor.cu) at the entropy family's shape (B=1024,
  N=161, Np=176, float32) on a seeded random quasidefinite K ([[G G' + I,
  C'], [C, -I]]): three runs of 20 launches after three warm-up launches;
  the first pivots show both checkouts factor the same K;
- k3: K3 (csrc/admm_iterate.cu), 15 iterations on the MPC per-instance
  data at B=2048 (the checkout's chip_smoke.k3_inputs): three runs of 10
  launches after one; the largest entry of x shows both compute the same;
- k2: K2 (csrc/admm_full.cu), the whole MPC general solve at B=2048,
  block 8 (bench.py:312-314 settings), and chip_smoke.py phase 5's probes
  "cold factorization + one check, adaptive rho off" and "adaptive rho
  off": three runs of one launch each after one; mean iterations and
  instances solved show both compute the same.

Builds that checkout's kernel, times it by CUDA events and prints one line
per mode.  Needs a CUDA device."""
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


def time_k6(label):
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    lk.build_factor_kernel()
    rng = np.random.default_rng(0)
    B, N, nb = 1024, 161, 64
    P = rng.standard_normal((B, nb, nb))
    K = np.zeros((B, N, N))
    K[:, :nb, :nb] = P @ np.swapaxes(P, 1, 2) + np.eye(nb)
    Bb = rng.standard_normal((B, N - nb, nb))
    K[:, nb:, :nb] = Bb
    K[:, :nb, nb:] = np.swapaxes(Bb, 1, 2)
    K[:, nb:, nb:] = -np.eye(N - nb)
    signs = np.concatenate([np.ones(nb), -np.ones(N - nb)])
    Kc = torch.tensor(K, dtype=torch.float32, device='cuda')
    for _ in range(3):
        fac = lk.ldl_factor_kernel(Kc, signs, 1e-4)
    torch.cuda.synchronize()
    means = [cuda_ms(lambda: lk.ldl_factor_kernel(Kc, signs, 1e-4), 20)[0]
             for _ in range(3)]
    print(f'# K6 {label}: ' + ' '.join(f'{m:.4f}' for m in means)
          + ' ms per launch; d[0, :3] '
          + ' '.join(f'{v:.6e}' for v in fac['d'][0, :3].tolist()),
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
    elif kernel == 'k3':
        time_k3(label, cs)
    elif kernel == 'k2':
        time_k2(label, cs)
    else:
        sys.exit(f'unknown kernel {kernel!r}: k2, k3 or k6')


if __name__ == '__main__':
    main()
