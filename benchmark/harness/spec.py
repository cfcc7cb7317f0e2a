"""Finding a cell's files by the names in BENCHMARK.json.

A cell ``<config>.<traffic>`` is made of:

- ``configs/<config>.json``: the deployment (sizes, the inputs it fixes,
  settings, precision, stated tolerance), listed under ``configs`` in
  BENCHMARK.json;
- ``families/<family>.py``: the problem written in the package's modeling
  layer (``build``) and how its parameters follow from the inputs
  (``assign``), ``family`` being named in the configuration;
- ``traffic/<config>.<traffic>.json``: the mix, read by ``generate.py``: the
  entry it drives, the batch, the pool, the inputs it draws, the route it
  is for, and the limits, set from readings, of the comparison that decides
  ``correct`` in this cell;
- ``entries/<entry>.py``: the program's call that the window times,
  ``entry`` being named in the mix;
- ``reference/<family>.py``: the family solved again in plain PyTorch;
- ``metrics/<metric>.py``: one reader per metric, end-to-end or per-layer.

Adding a cell, a configuration, an entry or a metric adds files and
entries; no file of the harness changes.
"""
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, 'BENCHMARK.json'))


def load_module(path, name):
    """Import the Python file at ``path`` under a private module name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(folder, name):
    return load_module(os.path.join(BENCH_DIR, folder, f'{name}.py'),
                       f'bench_{folder}_{name.replace(".", "_")}')


class Cell:
    """Everything one workload of BENCHMARK.json names, loaded by name."""

    def __init__(self, name, bench=None, root=ROOT):
        bench = bench or benchmark(root)
        work = {w['name']: w for w in bench['workloads']}
        if name not in work:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json; there '
                           f'are {sorted(work)}')
        self.workload = work[name]
        self.name = name
        cfg_entry = {c['name']: c for c in bench['configs']}[
            self.workload['config']]
        self.config = load_json(os.path.join(root, cfg_entry['file']))
        self.traffic = load_json(os.path.join(
            BENCH_DIR, 'traffic',
            f"{self.workload['config']}.{self.workload['traffic']}.json"))
        self.family = self.config['family']
        self.end_to_end = [m for m in bench['end_to_end']
                           if _applies(m, name)]
        self.per_layer = [m for m in bench['per_layer'] if _applies(m, name)]

    def limits(self):
        """The limits of the comparison: the objective tolerance that the
        configuration states, and the mix's limits set from readings."""
        return {'obj_gap_max': self.config['objective_tolerance'],
                **self.traffic['limits']}

    def family_module(self):
        return _named('families', self.family)

    def entry_module(self):
        return _named('entries', self.traffic['entry'])

    def reference_module(self):
        return reference_module(self.family)


def reference_module(family):
    """``reference/<family>.py``, imported as a module of the ``reference``
    package so that it can share the package's plain solvers."""
    return importlib.import_module(f'reference.{family}')


def metric_module(name):
    return _named('metrics', name)


def _applies(metric, cell):
    return 'workloads' not in metric or cell in metric['workloads']
