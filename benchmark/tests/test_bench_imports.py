"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole); the reference loads nothing of the
package under test either."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from harness import spec

JAX = {'jax', 'jaxlib', 'flax', 'cvxpygen_tpu'}
PORT = 'cvxpygen_tpu_torch'


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(
    p for p in glob.glob(os.path.join(spec.BENCH_DIR, '**', '*.py'),
                         recursive=True) if '/tests/' not in p))
def test_no_file_imports_jax(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize('path', sorted(glob.glob(
    os.path.join(spec.BENCH_DIR, 'reference', '*.py'))))
def test_reference_imports_plain_libraries(path):
    assert set(_imports(path)) <= {'torch', 'numpy', 'math'}


def _loaded(code):
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(res.stdout.split())


def test_reference_loads_no_package():
    loaded = _loaded(
        'import sys; sys.path.insert(0, "benchmark"); import torch; '
        'from harness import judge; '
        'rows = {"x_init": torch.ones(2, 6), "A": torch.eye(6).expand(2, 6, 6),'
        ' "B": torch.zeros(2, 6, 3), "Psqrt": torch.eye(6).expand(2, 6, 6),'
        ' "Qsqrt": torch.eye(6).expand(2, 6, 6),'
        ' "Rsqrt": torch.eye(3).expand(2, 3, 3)}; '
        'judge.reference_answers("mpc", {"H": 10, "n": 6, "m": 3}, rows); '
        'print(*{m.split(".")[0] for m in sys.modules})')
    assert not loaded & (JAX | {PORT})


def test_a_run_loads_no_jax():
    loaded = _loaded(
        'import sys, time; sys.path.insert(0, "benchmark"); import torch; '
        'torch.set_num_threads(1); from harness import cell; '
        'cell.run("mpc_h10.shared_x0", 4, 0.05, True, time.perf_counter(), '
        'device="cpu", batch=8, pool=1); '
        'print(*{m.split(".")[0] for m in sys.modules})')
    assert PORT in loaded
    assert not loaded & JAX
