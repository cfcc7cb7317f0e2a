"""Per-stage profiling of compiled family solves.

Port of the JAX package's ``runtime/profiling.py``:

- ``profile_qp_solve``: the per-instance ADMM solve's stages one by one
  (canonicalization GEMM, Ruiz equilibration, KKT assembly, the
  Newton-Schulz factorization, one check interval of iterations) beside the
  whole solve.  Each stage runs the solve's own functions: the check
  interval is ``iterate_interval`` of solvers/admm.py on the solve's route
  (kernel K3 where ``use_iterate_kernel`` says so, else the refined loop);
  the factorization is the ``torch.matmul`` chain of solvers/admm.py.  On
  CUDA every stage is timed
  by CUDA events on the current stream around ``reps`` calls after one
  warm-up call (which takes the first nvcc build); on the CPU by the host
  clock.
- ``trace``: a context manager around ``torch.profiler`` that writes a
  Chrome trace of the block.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (CPU and, where there is one, the
    card), written to ``<logdir>/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def _timed(fn, *args, reps=3):
    """(ms per call, last output) of ``fn(*args)`` after one warm-up call."""
    out = fn(*args)
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    if dev.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        return (time.perf_counter() - t0) / reps * 1000.0, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def profile_qp_solve(tf, theta, settings=None, reps=3) -> Dict[str, float]:
    """Per-stage timings (ms) of the batched per-instance ADMM QP solve at
    this batch size, on the family's device.  Stages mirror the solve
    pipeline; 'total_solve' runs the whole solve for comparison."""
    from ..solvers import admm as AD
    from ..ops.admm_kernel import pick_iterate_block
    from .torch_family import canon_batch, qp_bounds_batch

    st = settings or AD.ADMMSettings()
    theta = torch.atleast_2d(torch.as_tensor(theta, device=tf.maps.device)
                             ).to(tf.maps.dtype)
    B = theta.shape[0]
    out: Dict[str, float] = {}

    def canon(th):
        data = canon_batch(tf, th)
        return data, qp_bounds_batch(tf, data['b'])

    with AD.full_f32_matmul():
        t, (data, (l, u)) = _timed(canon, theta, reps=reps)
        out['canonicalize_ms'] = t

        def scale(P, q, A, l, u):
            return AD._scale(P, q, A, l, u, tf.n_zero, st, None, None)

        t, s = _timed(scale, data['P'], data['q'], data['A'], l, u,
                      reps=reps)
        out['equilibrate_ms'] = t
        Ps, As, rho = s['Ps'], s['As'], s['rho_base']

        t, M = _timed(lambda Ps, As, rho: AD.form_M(Ps, As, st.sigma, rho),
                      Ps, As, rho, reps=reps)
        out['kkt_assemble_ms'] = t

        t, Minv = _timed(lambda M: AD.newton_schulz_inverse(M, st.ns_iters),
                         M, reps=reps)
        out['factorize_ms'] = t

        # the solve's route for this batch: K3 or the refined loop
        kkt_mode = AD.admm_kkt_mode(st, As.device)
        m, n = As.shape[1:]
        k3_block = (pick_iterate_block(B, m, n) if AD.use_iterate_kernel(
            st, kkt_mode, B, m, n, As.dtype, As.device) else None)

        def block(Minv, Ps, As, qs, ls, us, rho, x, z, y):
            return AD.iterate_interval(st, kkt_mode, k3_block, Minv, Ps, As,
                                       qs, ls, us, rho, x, z, y)

        t, _ = _timed(block, Minv, Ps, As, s['qs'], s['ls'], s['us'], rho,
                      s['x_start'], s['z_start'], s['y_start'], reps=reps)
        out[f'iterate_{st.check_interval}_ms'] = t

        def full(th):
            d = canon_batch(tf, th)
            l_, u_ = qp_bounds_batch(tf, d['b'])
            return AD.admm_solve(d['P'], d['q'], d['A'], l_, u_, tf.n_zero,
                                 st)

        t, res = _timed(full, theta, reps=reps)
    out['total_solve_ms'] = t
    out['mean_iters'] = float(np.mean(res['iters'].cpu().numpy()))
    out['solves_per_s'] = B / (t / 1000.0)
    return out
