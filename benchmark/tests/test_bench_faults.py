"""The comparison fails a run whose timed path is broken underneath: the
harness's run of a toy cell on the CPU (the look for a card skipped),
with one fault of benchlib/faults.py planted at a time, gives correct
false; and so does the precision control, the program's own float32
path."""
import contextlib

import pytest
import torch

from benchlib import faults
from conftest import DESI_TOY, GAIA_TOY, run_toy


@pytest.mark.parametrize('workload,driver,fault', [
    (DESI_TOY, 'desi_files', 'stuck'), (DESI_TOY, 'desi_files', 'half'),
    (DESI_TOY, 'desi_files', 'altered'), (DESI_TOY, 'desi_files', 'ccf'),
    (GAIA_TOY, 'single_object', 'stuck'),
    (GAIA_TOY, 'single_object', 'altered')])
def test_fault_is_not_correct(toy_bench, workload, driver, fault):
    with contextlib.ExitStack() as stack:
        for p in faults.patches(driver, fault):
            stack.enter_context(p)
        res = run_toy(toy_bench, workload)
    assert res['correct'] is False, res['checks']


@pytest.mark.parametrize('workload', [DESI_TOY, GAIA_TOY])
def test_float32_control_is_not_correct(toy_bench, workload):
    res = run_toy(toy_bench, workload, dtype=torch.float32)
    assert res['correct'] is False, res['checks']


def test_calibrate_writes_each_reading(toy_bench, tmp_path):
    """calibrate.py's readings of a sound run and of a fault, one JSON
    line each, with every compared number of every judged answer."""
    import json
    import os
    import sys

    from benchlib import spec
    cal = spec.load_module(os.path.join(toy_bench, 'calibrate.py'))
    out = tmp_path / 'readings.jsonl'
    path = list(sys.path)
    try:
        assert cal.main(['--workload', DESI_TOY, '--out', str(out),
                         '--reading', 'sound:11', '--reading', 'stuck:12',
                         '--device', 'cpu', '--bench-dir', toy_bench]) == 0
    finally:
        sys.path[:] = path
    sound, stuck = [json.loads(line) for line in open(out)]
    limit = spec.load_json(os.path.join(toy_bench, 'limits',
                                        DESI_TOY + '.json'))['param_gap']
    assert sound['mode'] == 'sound' and stuck['mode'] == 'stuck'
    assert len(sound['numbers']['param_gap']) == sound['attempted'] > 0
    assert sound['checks']['param_gap'] <= limit < stuck['checks'][
        'param_gap']
