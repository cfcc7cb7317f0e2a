"""The per-layer readers on a synthetic profiler trace, and the roofline's
count of nonzeros on the MPC family."""
import json
import types

import pytest
import torch

from harness import generate, spec
from harness.trace import CALL_SPAN, TraceView

K1 = '(anonymous namespace)::iterate_kernel(Params)'
K1_DECIDE = '(anonymous namespace)::decide_kernel(Params)'
K3 = '(anonymous namespace)::iterate_resident_kernel(float const*, int)'
GEMM = 'sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32'
OWN_GEMM = '(anonymous namespace)::refactor_gemm_kernel(Params, int, int)'


def _ev(name, ts, dur, cat):
    return {'ph': 'X', 'name': name, 'ts': ts, 'dur': dur, 'cat': cat}


def _chrome():
    # two calls of 1000 us each; times in microseconds
    ev = [_ev(CALL_SPAN, 0, 1000, 'user_annotation'),
          _ev(CALL_SPAN, 1000, 1000, 'user_annotation'),
          _ev('aten::item', 540, 100, 'cpu_op'),
          _ev('cudaStreamSynchronize', 1900, 100, 'cuda_runtime')]
    for base in (0, 1000):
        ev += [_ev(K1, base + 100, 300, 'kernel'),
               _ev(K1_DECIDE, base + 350, 100, 'kernel'),     # overlaps
               _ev(K3, base + 500, 50, 'kernel'),
               _ev(GEMM, base + 600, 150, 'kernel'),
               _ev(OWN_GEMM, base + 760, 20, 'kernel'),
               _ev('Memcpy DtoH (Device -> Pageable)', base + 800, 40,
                   'gpu_memcpy')]
    return {'traceEvents': ev}


def _rec(**kw):
    view = TraceView(json.loads(json.dumps(_chrome())))
    base = dict(trace=view, counters={'iters_sum': 0, 'instances': 0})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_trace_window_busy_and_breakdown():
    view = TraceView(_chrome())
    assert view.calls == 2
    assert view.window_s == pytest.approx(2e-3)
    # per call: [100, 450] + [500, 550] + [600, 750] + [760, 780]
    # + [800, 840] = 350 + 50 + 150 + 20 + 40 us
    assert view.busy_s() == pytest.approx(2 * 610e-6)
    bd = view.breakdown()
    assert bd['device_ops'][0] == [K1, pytest.approx(600e-6)]
    gaps = dict(bd['idle_gaps'])
    assert gaps['aten::item'] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(2e-3 - 2 * 610e-6)


def test_idle_share():
    rec = _rec()
    got = spec.metric_module('device_idle_pct').read(rec)
    assert got == pytest.approx(100 * (1 - 1220 / 2000))


def test_kernel_times_per_call():
    rec = _rec()
    assert spec.metric_module('k3_ms').read(rec) == pytest.approx(0.05)
    # the package's own GEMM kernel is not the library's
    assert spec.metric_module('cublas_gemm_ms').read(rec) == pytest.approx(
        0.15)


def test_readers_return_nothing_without_their_kernels():
    rec = _rec()
    rec.trace.device_ops = [o for o in rec.trace.device_ops
                            if 'iterate_resident' not in o[0]]
    assert spec.metric_module('k3_ms').read(rec) is None
    assert spec.metric_module('k1_roofline').read(
        types.SimpleNamespace(trace=None)) is None
    assert spec.metric_module('iters_mean').read(
        _rec(counters={'iters_sum': 0, 'instances': 0})) is None


def test_iters_mean():
    rec = _rec(counters={'iters_sum': 300, 'instances': 4})
    assert spec.metric_module('iters_mean').read(rec) == 75.0


def _one(name):
    c = spec.Cell(name)
    values = generate.make_pool(c, 1, torch.device('cpu'), 2, 1)
    return c, generate.rows(values, 0, torch.zeros(1, dtype=torch.long))


def test_nonzero_count_mpc():
    k1 = spec.metric_module('k1_roofline')
    c, one = _one('mpc_h10.shared_x0')
    qp, _ = c.reference_module().formulate(
        {k: v.double() for k, v in one.items()}, c.config['sizes'])
    per_iter, shared, per_instance = k1.counts(qp)
    # P: 90 diagonal entries (Q on X_0..X_9, R on U); E: 10 x (6 + 9 + 3)
    # + 6, G: 60; N = 96 variables, 66 + 60 = 126 rows
    nnz_p, nnz_a, N, M = 90, 246, 96, 126
    assert shared == nnz_p + nnz_a
    assert per_instance == 2 * (N + 2 * M)
    kkt = N + 2 * nnz_a + M
    # every row of P, A and A' but P's six rows of X_10 holds a nonzero
    assert per_iter == ((2 * nnz_p - 90) + (2 * nnz_a - M)
                        + (2 * nnz_a - N) + kkt)


def test_roofline_share(monkeypatch):
    k1 = spec.metric_module('k1_roofline')
    c, one = _one('mpc_h10.shared_x0')
    monkeypatch.setattr(k1, 'peaks', lambda kind: {
        'fp32_flops_per_s': 1e9, 'hbm_bytes_per_s': 1e12})
    rec = _rec(counters={'iters_sum': 2 * 1000 * 50, 'instances': 2000},
               cell=c, one_instance=one, batch=1000,
               device_kind='test card')
    qp, _ = c.reference_module().formulate(
        {k: v.double() for k, v in one.items()}, c.config['sizes'])
    per_iter, _, _ = k1.counts(qp)
    # K1's kernels (iterate, decide, refactor_gemm): 300 + 100 + 20 us a
    # call; the operations bound the least time
    least = 1000 * 50 * per_iter / 1e9
    assert k1.read(rec) == pytest.approx(100 * least / 420e-6)
