"""Time kernel K6 (csrc/ldl_factor.cu) of one checkout of the repository,
to compare two checkouts on one card: for example a commit and its parent,
unpacked with `git archive` into directories that .gitignore lists and
run in turns in one call (parent, change, change, parent).

    python3 ab_k6.py CHECKOUT LABEL

Builds that checkout's K6, then times it at the entropy family's shape
(B=1024, N=161, Np=176, float32) on a seeded random quasidefinite K
([[G G' + I, C'], [C, -I]]) by
CUDA events: three runs of 20 launches after three warm-up launches.
Prints one line with the three means and the first pivots (to show both
checkouts factor the same K).  Needs a CUDA device."""
import os
import sys

import numpy as np
import torch


def main():
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.abspath(root))
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    if not lk.__file__.startswith(os.path.abspath(root)):
        sys.exit(f'imported {lk.__file__}, not the checkout {root}')
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
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(3):
        start.record()
        for _ in range(20):
            lk.ldl_factor_kernel(Kc, signs, 1e-4)
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / 20)
    print(f'# K6 {label}: ' + ' '.join(f'{m:.4f}' for m in means)
          + ' ms per launch; d[0, :3] '
          + ' '.join(f'{v:.6e}' for v in fac['d'][0, :3].tolist()),
          flush=True)


if __name__ == '__main__':
    main()
