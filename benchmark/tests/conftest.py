"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, with toy cells added as new files only (a small
template grid, short arms, a few files or objects), so that a whole run
of each driver takes a minute on the CPU."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# a coarse grid over the published node range, so that the traffic's
# stars lie inside it as they do in the cells' grids
TOY_NODES = {"teff": [2300., 4000., 5500., 7000., 9000., 12000.],
             "logg": [0., 2., 4., 6.], "feh": [-4., -2., -0.5, 1.],
             "alpha": [-0.2, 0.5, 1.2]}
DESI_TOY = 'toy_desi.toy_files'
GAIA_TOY = 'toy_gaia.toy_stream'


def _dump(obj, path):
    with open(path, 'w') as fp:
        json.dump(obj, fp, indent=1)


def add_toy_cells(root):
    """Add the toy configurations, traffic mixes, limits and cells to the
    benchmark copied under ``root`` (new files, and new entries in its
    BENCHMARK.json)."""
    bench = os.path.join(root, 'benchmark')
    load = lambda *p: json.load(open(os.path.join(bench, *p)))
    c = load('configs', 'desi_petal_norot.json')
    c.update(name='toy_desi', arms={
        'b': {'setup': 'desi_b', 'lam0': 4200.0, 'lam1': 4600.0, 'step': 0.8},
        'r': {'setup': 'desi_r', 'lam0': 6000.0, 'lam1': 6300.0, 'step': 0.8}})
    c['templates'].update(nodes=TOY_NODES, setups={
        'desi_b': {'lam0': 4150.0, 'lam1': 4650.0, 'fwhm': 1.55},
        'desi_r': {'lam0': 5950.0, 'lam1': 6350.0, 'fwhm': 1.55}})
    c['ccf']['every'] = 4
    _dump(c, os.path.join(bench, 'configs', 'toy_desi.json'))
    g = load('configs', 'gaia_rvs.json')
    g['name'] = 'toy_gaia'
    g['templates']['nodes'] = TOY_NODES
    g['ccf']['every'] = 3
    g['arms']['rvs'].update(lam0=8480.0, lam1=8580.0)
    g['templates']['setups']['gaia_rvs'].update(lam0=8470.0, lam1=8590.0)
    _dump(g, os.path.join(bench, 'configs', 'toy_gaia.json'))
    t = load('traffic', 'tile500_norot.json')
    t.update(files=4, fibres_per_file=6, sample_per_file=6)
    _dump(t, os.path.join(bench, 'traffic', 'toy_files.json'))
    t = load('traffic', 'stream.json')
    t.update(objects=10, sample=9)
    _dump(t, os.path.join(bench, 'traffic', 'toy_stream.json'))
    # the toy Gaia cell takes DESI's limits: the single-object driver
    # reports no errors and no CCF answer, which stay unjudged
    for w in (DESI_TOY, GAIA_TOY):
        shutil.copy(os.path.join(bench, 'limits',
                                 'desi_petal_norot.tile500.json'),
                    os.path.join(bench, 'limits', w + '.json'))
    b = json.load(open(os.path.join(root, 'BENCHMARK.json')))
    b['workloads'] += [
        dict(name=DESI_TOY, config='toy_desi', traffic='toy_files', chips=1,
             why='toy'),
        dict(name=GAIA_TOY, config='toy_gaia', traffic='toy_stream',
             chips=1, why='toy')]
    for m in b['per_layer'] + b['end_to_end']:
        ws = m.get('workloads', [])
        if any(w.startswith('desi_petal') for w in ws):
            ws.append(DESI_TOY)
    # the single-object metrics, whose cell waits (PERF.md, Open questions)
    b['per_layer'] += [
        dict(name=n, unit='s/spec', better='lower', source='program_span',
             layer='single-object fit', moves='spectra_per_s',
             workloads=[GAIA_TOY])
        for n in ('single.ccf_s_per_spec', 'single.process_s_per_spec')]
    for m in b['end_to_end']:
        if m['name'] == 'rv_abs_dev_kms':
            m['workloads'] = [DESI_TOY]
    _dump(b, os.path.join(root, 'BENCHMARK.json'))


def copy_benchmark(dst):
    """BENCHMARK.json and benchmark/ (without its tests) under ``dst``."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), dst)
    shutil.copytree(BENCH, os.path.join(dst, 'benchmark'),
                    ignore=shutil.ignore_patterns('tests', '__pycache__'))
    return os.path.join(dst, 'benchmark')


@pytest.fixture(scope='session')
def toy_bench(tmp_path_factory):
    """The benchmark directory of a temporary checkout with the toy
    cells."""
    root = tmp_path_factory.mktemp('checkout')
    bench = copy_benchmark(str(root))
    add_toy_cells(str(root))
    return bench


def run_toy(bench, workload, trace=0, dtype=None, seed=2**33 + 5):
    """One CPU run of a toy cell: the harness's result dict."""
    import time

    import torch
    from benchlib import harness
    return harness.run(workload, seed, 0.0, trace, time.time(),
                       device='cpu', dtype=dtype or torch.float64,
                       bench_dir=bench)
