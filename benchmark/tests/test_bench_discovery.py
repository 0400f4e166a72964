"""A new configuration, traffic mix and per-layer metric are new files
only: the harness finds them by the names in BENCHMARK.json."""
import json
import os
import shutil

from benchlib import spec
from conftest import DESI_TOY, add_toy_cells, copy_benchmark, run_toy

READER = '''"""Toy metric: the spectra of the window."""


def read(ctx, win, dtrace):
    return float(win.spectra())
'''


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    bench = copy_benchmark(str(tmp_path))
    before = {p for p in _files(bench)}
    add_toy_cells(str(tmp_path))
    with open(os.path.join(bench, 'metrics', 'toy.window_spectra.py'),
              'w') as fp:
        fp.write(READER)
    b = json.load(open(tmp_path / 'BENCHMARK.json'))
    b['per_layer'].append(dict(
        name='toy.window_spectra', unit='spectra', better='higher',
        source='program_counter', layer='drivers, host I/O and prep',
        moves='spectra_per_s', workloads=[DESI_TOY]))
    json.dump(b, open(tmp_path / 'BENCHMARK.json', 'w'))
    # no file the benchmark had was edited: only files were added
    for p in before:
        assert open(os.path.join(bench, p), 'rb').read() == open(
            os.path.join(spec.BENCH_DIR, p), 'rb').read(), p

    cell = spec.Cell(DESI_TOY, bench)
    assert cell.config['name'] == 'toy_desi'
    assert cell.traffic['files'] == 4
    assert 'toy.window_spectra' in [m['name']
                                    for m in cell.metrics('per_layer')]
    res = run_toy(bench, DESI_TOY, trace=1)
    assert res['metrics']['toy.window_spectra']['value'] > 0


def _files(bench):
    for dp, _, fs in os.walk(bench):
        for f in fs:
            if '__pycache__' not in dp:
                yield os.path.relpath(os.path.join(dp, f), bench)


def test_kernel_implementation_is_a_file_of_its_own(tmp_path):
    bench = copy_benchmark(str(tmp_path))
    shutil.copy(os.path.join(bench, 'kernels', 'kernel_b', 'cuda_f64.json'),
                os.path.join(bench, 'kernels', 'kernel_b', 'other.json'))
    table = spec.kernel_table(bench)
    assert len(table['kernel_b']['impls']) == 3
