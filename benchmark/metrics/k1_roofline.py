"""k1_roofline: the least time of the shared route's work over kernel K1's
device time per traced call (csrc/admm_shared.cu, found by its kernels'
names), in percent of the card's float32 and HBM peaks (peaks.json).

The work is counted from the benchmark's own formulation of the QP
(reference/<family>.py), never from a kernel's layout, so it is a lower
bound for any implementation.  Per ADMM iteration and instance: the
products with P, A and A' by their nonzeros (a multiply per nonzero and an
add per nonzero beyond the first of its row) and one KKT solve at no fewer
operations than [[P + sigma I, A'], [A, -diag(1/rho)]] has nonzeros, times
the iterations the solver reports.  Bytes: the shared P and A values read
once, each instance's q, l, u read once and x, z, y written once."""
import json
import os
import re

import torch

from harness import spec

PATTERN = re.compile(r'^(void )?\(anonymous namespace\)::'
                     r'(iterate|decide|refactor_gemm|rescale|init)_kernel'
                     r'(<[^>]*>)?\(')
ELEMENT_BYTES = {'float32': 4, 'float64': 8}


def counts(qp):
    """(operations per iteration, shared words, words per instance) of one
    instance's QP (P, E, G with a leading batch dimension of 1)."""
    P = qp['P'][0]
    A = torch.cat([qp['E'][0], qp['G'][0]])
    N, M = P.shape[0], A.shape[0]

    def product(mat):
        nz = mat != 0
        return 2 * int(nz.sum()) - int(nz.any(1).sum())

    eye = torch.eye(N, dtype=torch.bool, device=P.device)
    kkt = int(((P != 0) | eye).sum()) + 2 * int((A != 0).sum()) + M
    per_iter = product(P) + product(A) + product(A.T) + kkt
    shared = int((P != 0).sum()) + int((A != 0).sum())
    return per_iter, shared, 2 * (N + 2 * M)


def peaks(kind):
    with open(os.path.join(spec.BENCH_DIR, 'peaks.json')) as f:
        return json.load(f).get(kind)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.calls:
        return None
    pk = peaks(rec.device_kind)
    if pk is None:
        return None
    t = sum(d for name, _, d, _ in tr.kernels() if PATTERN.search(name))
    if not t:
        return None
    cfg = rec.cell.config
    ref = rec.cell.reference_module()
    qp, _ = ref.formulate({k: v.double() for k, v in rec.one_instance.items()},
                          cfg['sizes'])
    per_iter, shared, per_instance = counts(qp)
    ops = rec.counters['iters_sum'] / tr.calls * per_iter
    nbytes = ELEMENT_BYTES[cfg['precision']] * (
        shared + rec.batch * per_instance)
    least = max(ops / pk['fp32_flops_per_s'], nbytes / pk['hbm_bytes_per_s'])
    return 100.0 * least / (t / tr.calls)
