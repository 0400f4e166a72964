"""Each cell's harness path, end to end at a toy size on the CPU: set-up,
the completion-stamped window, the reference's judgement and the result
line's keys; and on a card (marked ``cuda``), the same toy runs there."""
import json

import pytest
import torch

from benchlib import compare
from conftest import DESI_TOY, GAIA_TOY, run_toy


def _check_line(res, names):
    assert res['correct'] is True, res['checks']
    assert res['attempted'] > 0 and res['failed'] == 0
    assert set(res['metrics']) == set(names)
    assert all(v['value'] > 0 for v in res['metrics'].values())
    assert list(res)[-1] == 'checks'
    assert set(res['checks']) == set(compare.NUMBERS)
    json.dumps(res)


@pytest.mark.parametrize('workload,e2e', [
    (DESI_TOY, ('spectra_per_s', 'rv_abs_dev_kms', 'setup_s')),
    (GAIA_TOY, ('spectra_per_s', 'setup_s'))])
def test_toy_cell_runs_and_is_correct(toy_bench, workload, e2e):
    res = run_toy(toy_bench, workload)
    # peak_device_gb reads 0 on the CPU, which has no device allocator
    _check_line(dict(res, metrics={k: v for k, v in res['metrics'].items()
                                   if k != 'peak_device_gb'}), e2e)
    assert res['device']['platform'] == 'cpu'


def test_toy_cells_traced_report_their_span_metrics(toy_bench):
    res = run_toy(toy_bench, DESI_TOY, trace=1)
    _check_line(res, ('driver.prep_s_per_kspec', 'driver.write_s_per_kspec',
                      'fit.nm_s_per_kspec', 'fit.tail_s_per_kspec'))
    res = run_toy(toy_bench, GAIA_TOY, trace=1)
    _check_line(res, ('single.ccf_s_per_spec', 'single.process_s_per_spec'))


def test_a_hook_the_program_never_calls_fails_the_run(toy_bench):
    from unittest import mock

    from rvspecfit_torch.survey import desi
    with mock.patch.object(desi, 'proc_many', lambda *a, **k: None):
        with pytest.raises(RuntimeError, match='never called'):
            run_toy(toy_bench, DESI_TOY)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('workload', [DESI_TOY, GAIA_TOY])
def test_toy_cell_on_the_card(toy_bench, card, workload):
    import time

    from benchlib import harness
    res = harness.run(workload, 2**33 + 7, 0.0, 1, time.time(),
                      bench_dir=toy_bench)
    assert res['correct'] is True, res['checks']
    assert res['device']['busy_s'] > 0
    assert 'kernel_b_roofline' in res['metrics']
    assert 0 < res['metrics']['kernel_b_roofline']['value'] <= 105
