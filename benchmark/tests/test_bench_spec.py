"""Cells, configurations, traffic mixes and metrics are found by name."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import spec

BENCH = spec.benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.Cell(name)
    assert cell.config['name'] == cell.workload['config']
    assert callable(cell.family_module().assign)
    assert callable(cell.entry_module().solve)
    assert callable(cell.reference_module().solve)
    assert set(cell.limits()) == {'obj_gap_max', 'obj_gap_median', 'var_gap'}
    assert all(v is not None for v in cell.limits().values())
    assert {m['name'] for m in cell.end_to_end} == {
        'solves_per_s', 'call_ms_p95', 'peak_mem_gib', 'setup_s'}
    for m in cell.per_layer:
        assert m['moves'] in {e['name'] for e in BENCH['end_to_end']}


@pytest.mark.parametrize('metric', [m['name'] for m in BENCH['end_to_end']
                                    + BENCH['per_layer']])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_module(metric).read)


def test_configuration_files_are_distinct_and_under_paths():
    files = [c['file'] for c in BENCH['configs']]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith(BENCH['paths'][0] + '/')
        assert os.path.exists(os.path.join(spec.ROOT, f))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.Cell('mpc_h10.no_such_mix')


def _run_in_copy(tmp_path, cell_name, files, bench_add):
    """Copy the benchmark, add ``files`` (path under benchmark/ -> text)
    and BENCHMARK.json entries, and run the cell there on the CPU."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    for rel, text in files.items():
        assert not (tmp_path / 'benchmark' / rel).exists()
        (tmp_path / 'benchmark' / rel).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    for key, entries in bench_add.items():
        bench[key] += entries
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    code = (
        'import sys, time, json; t = time.perf_counter(); '
        f'sys.path[:0] = [{str(tmp_path / "benchmark")!r}, {spec.ROOT!r}]; '
        'import torch; torch.set_num_threads(1); '
        'from harness import cell; '
        f"out, _ = cell.run({cell_name!r}, 5, 0.5, False, t, "
        "device='cpu'); print(json.dumps(out))")
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _mix(base, **kw):
    mix = json.load(open(os.path.join(spec.BENCH_DIR, 'traffic',
                                      f'{base}.json')))
    mix.update(kw)
    return json.dumps(mix)


def test_a_cell_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a cell through a new mix file and a new
    BENCHMARK.json entry; no harness file changes, and the cell runs."""
    out = _run_in_copy(
        tmp_path, 'mpc_h10.tiny_probe',
        {'traffic/mpc_h10.tiny_probe.json': _mix('mpc_h10.shared_x0',
                                                 batch=8, pool=2)},
        {'workloads': [{'name': 'mpc_h10.tiny_probe', 'config': 'mpc_h10',
                        'traffic': 'tiny_probe', 'chips': 1,
                        'why': 'a probe'}]})
    assert out['workload'] == 'mpc_h10.tiny_probe'
    assert out['correct'] and out['attempted'] % 8 == 0


BANDED_ENTRY = '''"""Entry banded_batch: CompiledBandedQPSolver.solve_batch."""
from cvxpygen_tpu_torch.runtime.solver import (CompiledBandedQPSolver,
                                               pa_theta_mask, use_shared_path)
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings


def make(family, config, dtype, device):
    return CompiledBandedQPSolver(family, ADMMSettings(**config['settings']),
                                  dtype=dtype, device=device)


def solve(solver, theta):
    return solver.solve_batch(theta, shared_PA='auto')


def route(solver, theta):
    shared = use_shared_path(pa_theta_mask(solver.family), theta, 'auto')
    return 'banded_shared' if shared else 'banded_per_instance'
'''


def test_a_cell_of_another_solver_from_new_files_alone(tmp_path):
    """A new configuration (MPC at horizon 30), a new entry (the banded
    solver, another solver class and call) and a new mix that names it
    make a cell from new files and BENCHMARK.json entries alone; the
    family file and its reference serve any horizon."""
    config = json.load(open(os.path.join(spec.BENCH_DIR, 'configs',
                                         'mpc_h10.json')))
    config.update(name='mpc_h30_probe', sizes=dict(config['sizes'], H=30))
    out = _run_in_copy(
        tmp_path, 'mpc_h30_probe.banded',
        {'configs/mpc_h30_probe.json': json.dumps(config),
         'entries/banded_batch.py': BANDED_ENTRY,
         'traffic/mpc_h30_probe.banded.json': _mix(
             'mpc_h10.per_instance_dyn', entry='banded_batch', batch=8,
             pool=2, route='banded_per_instance',
             # a new cell sets its own limits from its readings
             limits={'obj_gap_median': 1e-2, 'var_gap': 0.2})},
        {'configs': [{'name': 'mpc_h30_probe', 'source': 'a probe',
                      'file': 'benchmark/configs/mpc_h30_probe.json',
                      'reduced': [], 'why': 'a probe'}],
         'workloads': [{'name': 'mpc_h30_probe.banded',
                        'config': 'mpc_h30_probe', 'traffic': 'banded',
                        'chips': 1, 'why': 'a probe'}]})
    assert out['route'] == 'banded_per_instance'
    assert out['correct'] and out['judged'] > 0, (out['checks'], out['notes'])
