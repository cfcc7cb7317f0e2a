"""Build a CUDA source of the port with nvcc and load it with ctypes.

Every hand-written kernel of the port is one ``csrc/<name>.cu`` file with a
plain C interface.  ``load_library`` compiles it for ``sm_90a`` into
``build/cvxpygen_tpu_torch/`` (listed in ``.gitignore``), keyed on a hash of
the source and of every header in ``csrc/``, so an edit to a shared header
rebuilds each library that may include it.  The build runs at first use,
never at import: the CPU tests import every module on machines without
``nvcc``.  Builds of different sources may run in parallel threads (nvcc
runs in a subprocess); a second caller for the same source waits for the
first.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc')
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, 'build', 'cvxpygen_tpu_torch')

_LIBS = {}
_LOCKS = {}
_LOCKS_LOCK = threading.Lock()


def _nvcc():
    nvcc = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    return nvcc if os.path.exists(nvcc) else 'nvcc'


def _source_tag(src):
    h = hashlib.sha1()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, '*.cuh'))):
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def load_library(name, bind, verbose=False):
    """Compile ``csrc/<name>.cu`` (once per content) and load it.

    ``bind(lib)`` sets the C functions' argument and result types.  Returns
    ``(lib, seconds)``: the wall time of this call's build and load, 0.0
    when the library was already loaded.  Raises when nvcc is missing or
    the build fails; with ``verbose`` prints ptxas's register and shared
    memory report."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name], 0.0
        t0 = time.perf_counter()
        src = os.path.join(CSRC, f'{name}.cu')
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f'lib{name}_{_source_tag(src)}.so')
        if not os.path.exists(so):
            tmp = f'{so}.{os.getpid()}.tmp'
            cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
                   '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                   '-Xptxas', '-v', '-I', CSRC, '-o', tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f'nvcc failed for {name}.cu:\n'
                                   + res.stdout + res.stderr)
            if verbose:
                print(res.stderr.strip())
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        bind(lib)
        _LIBS[name] = lib
        return lib, time.perf_counter() - t0


def checked(t, name, shape, dev):
    """``t`` as a contiguous float32 tensor on ``dev`` of ``shape``, or a
    TypeError/ValueError naming the argument."""
    if t.device != dev or t.dtype != torch.float32:
        raise TypeError(f'{name}: float32 on {dev} expected, got {t.dtype} '
                        f'on {t.device}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(shape)} expected, got '
                         f'{tuple(t.shape)}')
    return t.contiguous()
