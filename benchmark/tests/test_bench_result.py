"""The result line's shape, and the checks that the run makes of itself."""
import json
import os
import shutil
import subprocess
import sys
import time

from harness import cell, spec


def _run(traced):
    return cell.run('mpc_h10.per_instance_dyn', 2 ** 31 + 9, 0.5, traced,
                    time.perf_counter(), device='cpu', batch=8, pool=2)


def test_untraced_line():
    out, lines = _run(False)
    assert list(out)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(out)[-1] == 'checks'
    assert set(out['checks']) == {'obj_gap_max', 'obj_gap_median', 'var_gap'}
    for c in out['checks'].values():
        assert set(c) == {'value', 'limit'}
    # no card: peak memory has nothing to read; the rest is there
    assert set(out['metrics']) == {'solves_per_s', 'call_ms_p95', 'setup_s'}
    for m in out['metrics'].values():
        assert set(m) == {'value', 'unit'}
    assert {'platform', 'kind', 'count', 'memory_peak_bytes'} <= set(
        out['device'])
    assert out['attempted'] >= 8 and 0 <= out['failed'] <= out['attempted']
    assert len(lines) == 3 and lines[0].startswith('obj_gap_max: ')
    json.dumps(out)


def test_traced_line():
    out, _ = _run(True)
    assert 'breakdown' in out
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
    assert {'busy_s', 'window_s'} <= set(out['device'])
    # on the CPU the trace holds no device operation: only the count
    assert set(out['metrics']) == {'iters_mean'}


def _command(cwd, *args):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'mpc_h10.shared_x0', '--seed', '3', '--seconds', '1', '--trace',
         '0', *args], capture_output=True, text=True, timeout=300, cwd=cwd,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))


def test_no_card_no_result():
    res = _command(spec.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ''


def test_benchmark_alone_has_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / 'benchmark')
    res = _command(str(tmp_path))
    assert res.returncode != 0 and res.stdout.strip() == ''


def test_line_is_strict_json():
    import run
    line = json.dumps(run.finite({'a': float('inf'), 'b': [float('nan'), 1.5],
                                  'c': {'d': 2}}), allow_nan=False)
    assert json.loads(line) == {'a': None, 'b': [None, 1.5], 'c': {'d': 2}}


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    monkeypatch.setitem(sys.modules, 'cvxpygen_tpu.runtime', sys)
    assert cell.forbidden_modules() == ['cvxpygen_tpu', 'jax']
