"""The benchmark's own tests.  They run on the CPU, at tiny sizes, with the
package's plain versions of its kernels; tests marked ``cuda`` need a card
and skip without one.  Run them from the repository's root:

    python -m pytest benchmark/tests -q
"""
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny batched solves gain nothing from more,
    and the CPU's batched LU has misbehaved at two."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')
