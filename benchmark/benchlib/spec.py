"""BENCHMARK.json and the files it names, found by name: a cell's
configuration ``configs/<config>.json``, traffic ``traffic/<traffic>.json``,
correctness limits ``limits/<workload>.json``, a per-layer metric's
reader ``metrics/<metric>.py`` and a kernel's work count and
implementations ``kernels/<kernel>/``."""
import glob
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def root_dir(bench_dir=BENCH_DIR):
    """The checkout's root: the directory above the benchmark's."""
    return os.path.dirname(bench_dir)


def load_json(path):
    with open(path) as fp:
        return json.load(fp)


def load_module(path, name=None):
    """A Python file as a module (its name need not be an identifier)."""
    name = name or 'bench_' + os.path.basename(path).replace('.', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one workload of BENCHMARK.json names."""

    def __init__(self, workload, bench_dir=BENCH_DIR):
        self.bench_dir = bench_dir
        self.bench = load_json(os.path.join(root_dir(bench_dir),
                                            'BENCHMARK.json'))
        cells = {w['name']: w for w in self.bench['workloads']}
        if workload not in cells:
            raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
        self.entry = cells[workload]
        self.name = workload
        self.config = load_json(self.path('configs',
                                          self.entry['config'] + '.json'))
        self.traffic = load_json(self.path('traffic',
                                           self.entry['traffic'] + '.json'))
        self.limits = load_json(self.path('limits', workload + '.json'))
        self.chips = int(self.entry['chips'])

    def path(self, *parts):
        return os.path.join(self.bench_dir, *parts)

    def metrics(self, kind):
        """The metric entries of ``kind`` ('end_to_end' or 'per_layer')
        that this cell reports: those without ``workloads``, and those
        whose ``workloads`` list it."""
        return [m for m in self.bench[kind]
                if 'workloads' not in m or self.name in m['workloads']]

    def reader(self, metric):
        return load_module(self.path('metrics', metric + '.py'))

    def driver(self):
        return load_module(self.path('drivers',
                                     self.traffic['driver'] + '.py'))


def kernel_table(bench_dir=BENCH_DIR):
    """{kernel: dict(work=module, impls=[implementation dicts])} of
    every folder under kernels/: its ``work.py`` and each ``*.json``
    naming one implementation's device kernels."""
    out = {}
    for d in sorted(glob.glob(os.path.join(bench_dir, 'kernels', '*'))):
        if not os.path.isfile(os.path.join(d, 'work.py')):
            continue
        impls = [load_json(f) for f in sorted(glob.glob(
            os.path.join(d, '*.json')))]
        out[os.path.basename(d)] = dict(
            work=load_module(os.path.join(d, 'work.py')), impls=impls)
    return out
