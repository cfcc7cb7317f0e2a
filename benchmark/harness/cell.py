"""One run of one cell: set-up, the measured window, the check, the result.

The window drives the mix's entry (``entries/<entry>.py``) back to back (a
closed loop: the next call starts when the last one's answers are on the
device and synchronized) over a pool of distinct batches made at set-up from
the seed.  Each call is timed
by CUDA events around it; the stream is idle at each call's start, so the
span covers the call's host work as well as its kernels.  After the window,
a sample of the answers drawn from the seed is solved again by the plain
reference and compared.
"""
import gc
import subprocess
import sys
import time

import numpy as np
import torch

from . import generate, judge, spec, trace

PER_CALL = 8      # rows of each call kept for the check, drawn from the seed
SAMPLE = 1024     # rows checked against the reference, drawn from those
TRACE_CALLS = 30  # most calls traced in a --trace 1 run
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'cvxpygen_tpu')


class Record:
    """What a metric's reader reads: the window's host and device timings,
    the program's counts, and with ``--trace 1`` the trace (``trace``)."""

    def __init__(self, **kw):
        self.trace = None
        self.__dict__.update(kw)


def power_limit_w():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def forbidden_modules():
    """Top-level names, compared whole, of loaded modules that the run may
    not hold: JAX and the JAX package."""
    return sorted({name.split('.')[0] for name in sys.modules}
                  & set(FORBIDDEN))


def run(cell_name, seed, seconds, traced, t_start, device='cuda',
        batch=None, pool=None):
    """Run the cell once; returns the result's dict and the lines to print
    last on standard error.  ``batch`` and ``pool`` shrink the mix (tests
    only)."""
    from .port import Port
    split = {'imports': time.perf_counter() - t_start}
    cell = spec.Cell(cell_name)
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    port = Port(cell, dev)
    _sync(dev)
    split['compile_family'] = time.perf_counter() - t_start
    values = generate.make_pool(cell, seed, dev, batch, pool)
    theta = port.pack(values)
    npool, B = theta.shape[:2]
    route = port.route(theta[0])
    _sync(dev)
    split['pool'] = time.perf_counter() - t_start
    port.solve(theta[0])
    _sync(dev)
    split['warm_call'] = time.perf_counter() - t_start
    if traced:
        # the profiler's first session starts its tracer, which takes
        # seconds: start it here, outside the window
        with _profiler():
            torch.ones(1, device=dev).add_(1)
            _sync(dev)
    power = power_limit_w() if cuda else None
    # the set-up's objects (torch's modules, the family) go to the
    # permanent generation, so that the window's collections, which the
    # answers kept for the check make more frequent, do not walk them
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(int(seed))
    picks = torch.as_tensor(np.stack([rng.choice(B, min(PER_CALL, B),
                                                 replace=False)
                                      for _ in range(1024)]), device=dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    kept, stamps = [], []
    solved = torch.zeros((), dtype=torch.int64, device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    # with --trace 1 the calls that start after the first third of the
    # window are traced, up to TRACE_CALLS of them or a third of the window
    prof, tracing, traced_calls, t_on = None, False, 0, 0.0
    calls = 0
    w0 = time.perf_counter()
    while True:
        now = time.perf_counter() - w0
        if traced and prof is None and now >= seconds / 3:
            prof, tracing, t_on = _profiler(), True, now
            prof.start()
        elif tracing and (traced_calls >= TRACE_CALLS or (
                now - t_on >= seconds / 3 and traced_calls >= 2)):
            prof.stop()
            tracing = False
        if not tracing and now >= seconds:
            break
        k = calls % npool
        t0 = _stamp(dev)
        if tracing:
            with torch.profiler.record_function(trace.CALL_SPAN):
                res = port.solve(theta[k])
                _sync(dev)
        else:
            res = port.solve(theta[k])
        t1 = _stamp(dev)
        _sync(dev)
        stamps.append((t0, t1))
        idx = picks[calls % len(picks)]
        kept.append((k, idx, port.answers(res, idx)))
        solved += (res['status'] == 1).sum()
        if tracing:
            iters += res['iters'].sum()
            traced_calls += 1
        calls += 1
    window_s = time.perf_counter() - w0
    gc.unfreeze()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    call_s = [_elapsed(a, b) for a, b in stamps]
    solved = int(solved)
    attempted = calls * B
    del res, port, theta
    if cuda:
        torch.cuda.empty_cache()

    rec = Record(setup_s=setup_s, window_s=window_s, call_s=call_s,
                 batch=B, solved=solved, peak_bytes=window_peak, cell=cell,
                 device_kind=torch.cuda.get_device_name(dev) if cuda
                 else 'cpu',
                 counters={'iters_sum': int(iters),
                           'instances': traced_calls * B},
                 one_instance=generate.rows(values, 0, torch.zeros(
                     1, dtype=torch.long, device=dev)))
    if prof is not None:
        rec.trace = trace.TraceView(trace.export_and_read(prof))

    answers, params = _sample(kept, values, seed)
    ref = judge.reference_answers(cell.family, cell.config['sizes'], params)
    correct, checks, notes = judge.compare(answers, ref, cell.limits())

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_module(m['name']).read(rec)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': rec.device_kind,
                   'count': 1,
                   'memory_peak_bytes': max(setup_peak, window_peak),
                   'power_limit_w': power}
    out = {'correct': correct, 'attempted': attempted,
           'failed': attempted - solved, 'metrics': metrics,
           'device': device_info}
    if rec.trace is not None:
        device_info['busy_s'] = rec.trace.busy_s()
        device_info['window_s'] = rec.trace.window_s
        out['breakdown'] = rec.trace.breakdown()
    out.update(workload=cell_name, seed=int(seed), calls=calls, route=route,
               judged=int((answers['status'] == 1).sum()),
               call_ms_median=1e3 * float(np.median(call_s)),
               in_calls_share=sum(call_s) / window_s,
               setup_split=split, notes=notes)
    out['checks'] = checks
    lines = [f'{k}: {c["value"]!r} (limit {c["limit"]!r})'
             for k, c in checks.items()] + notes
    return out, lines


def _sample(kept, values, seed):
    """The rows checked: SAMPLE of the kept rows, drawn from the seed, with
    the solver's answers and the parameter values they were solved at."""
    pairs = [(c, j) for c, (_, idx, _) in enumerate(kept)
             for j in range(len(idx))]
    rng = np.random.default_rng(int(seed) + 1)
    take = sorted(rng.choice(len(pairs), min(SAMPLE, len(pairs)),
                             replace=False).tolist())
    answers, params = {}, {}
    by_call = {}
    for t in take:
        c, j = pairs[t]
        by_call.setdefault(c, []).append(j)
    for c, js in by_call.items():
        k, idx, ans = kept[c]
        js_t = torch.as_tensor(js, device=idx.device)
        for name, v in ans.items():
            answers.setdefault(name, []).append(v[js_t])
        for name, v in generate.rows(values, k, idx[js_t]).items():
            params.setdefault(name, []).append(v)
    return ({k: torch.cat(v) for k, v in answers.items()},
            {k: torch.cat(v) for k, v in params.items()})


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _stamp(dev):
    if dev.type != 'cuda':
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed(a, b):
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) * 1e-3
