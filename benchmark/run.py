"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks`` last: each compared number with its limit); the
last lines of standard error repeat the compared numbers.  Without a CUDA
card, without enough of them, or with JAX or the JAX package loaded at the
end, it prints no result and exits with 1.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))
sys.path.insert(0, BENCH_DIR)


def finite(obj):
    """``obj`` with every infinite or NaN number as null, so that the line
    is strict JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the build cache of the package's kernels is build/ inside the
    # checkout (ops/build.py), so only a checkout's first run compiles
    import torch
    from harness import cell, spec
    chips = next((w['chips'] for w in spec.benchmark()['workloads']
                  if w['name'] == args.workload), None)
    if chips is None:
        print(f'no workload {args.workload!r} in BENCHMARK.json',
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA card(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 1
    out, lines = cell.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START)
    found = cell.forbidden_modules()
    if found:
        print(f'the run loaded {found}: JAX or the JAX package',
              file=sys.stderr)
        return 1
    print(json.dumps(finite(out), allow_nan=False))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
