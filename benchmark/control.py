"""Readings that set a cell's limits: the solver's compared numbers over many
seeds, and the control's, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 --fault-seeds 1 2 3 [--batch B] \
        [--out file.jsonl]

For each seed it makes the cell's pool, solves its first batch once through
the timed call, and judges a sample of the answers against the float64
reference, as a run does after its window.

The control is the solver with its own lower-precision path switched on:
the caller's float32 matmuls in TF32 (``torch.set_float32_matmul_precision
('high')``), which the canonicalization's products follow (the solve
itself keeps TF32 off).  The configuration states float32 with TF32 off.
``--fault-seeds`` reads the solver with a neighbour's variables handed
out, which sets the upper reading of ``var_gap``.  One JSON line per
reading.  Needs a CUDA card unless ``--device cpu`` (tests only).
"""
import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))
sys.path.insert(0, BENCH_DIR)


def program_reading(cell, port, seed, dev, batch=None, side='program'):
    from harness import generate, judge
    values = generate.make_pool(cell, seed, dev, batch, 1)
    theta = port.pack(values)[0]
    res = port.solve(theta)
    idx = _sample_rows(theta.shape[0], seed, dev)
    ans = port.answers(res, idx)
    ref = judge.reference_answers(cell.family, cell.config['sizes'],
                                  generate.rows(values, 0, idx))
    ok, checks, notes = judge.compare(ans, ref, cell.limits())
    return dict(side=side, seed=seed, correct=ok, notes=notes,
                failed=int((res['status'] != 1).sum()),
                iters_mean=float(res['iters'].double().mean()),
                route=port.route(theta),
                **{k: c['value'] for k, c in checks.items()})


def control_reading(cell, port, seed, dev, batch=None):
    """The solver, with the caller's float32 matmuls in TF32."""
    import torch
    from cvxpygen_tpu_torch.runtime.torch_family import canon_batch
    from harness import generate
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        r = program_reading(cell, port, seed, dev, batch, side='control')
        theta = port.pack(generate.make_pool(cell, seed, dev, batch, 1))[0]
        low = canon_batch(port.solver.jf, theta)
    finally:
        torch.set_float32_matmul_precision(prev)
    high = canon_batch(port.solver.jf, theta)
    r['tf32_canon_change'] = max(float((low[k] - high[k]).abs().max())
                                 for k in ('P', 'q', 'A', 'b'))
    return r


def fault_reading(cell, port, seed, dev, batch=None):
    """The solver with a fault planted where its answers are produced:
    every eighth instance is handed its neighbour's variables (``x``),
    its own objective and status kept, as a wrong variable map would."""
    import torch
    solve = port.solve

    def broken(theta):
        res = dict(solve(theta))
        src = torch.arange(theta.shape[0], device=theta.device)
        src[::8] = (src[::8] + 1) % theta.shape[0]
        res['x'] = res['x'][src]
        return res

    port.solve = broken
    try:
        return program_reading(cell, port, seed, dev, batch,
                               side='fault_neighbour_x')
    finally:
        del port.solve


def _sample_rows(B, seed, dev):
    import numpy as np
    import torch
    from harness.cell import SAMPLE
    rng = np.random.default_rng(int(seed) + 1)
    return torch.as_tensor(np.sort(rng.choice(B, min(SAMPLE, B),
                                              replace=False)), device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--fault-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--batch', type=int, default=None)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    from harness import spec
    from harness.port import Port
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    cell = spec.Cell(args.workload)
    port = Port(cell, dev)
    runs = ([(program_reading, s) for s in args.seeds]
            + [(control_reading, s) for s in args.control_seeds]
            + [(fault_reading, s) for s in args.fault_seeds])
    for fn, seed in runs:
        t = time.perf_counter()
        r = fn(cell, port, seed, dev, args.batch)
        r['seconds'] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(dict(workload=args.workload, **r)) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
