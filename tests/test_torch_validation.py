"""The port's RV pull harness (validation.py) against the reference's,
in float64 on the CPU: the same trials (one RandomState), the same
fit (scan -> Nelder-Mead -> polish -> refinement) and the same
statistics."""
import json

import numpy as np
import pytest

from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu import validation as rvalidation
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import simulation, validation

CONFIG = dict(validation.DEFAULT_CONFIG, second_minimizer=False)
KEYS = {'ntrials', 'snr', 'median_bias', 'median_err', 'scatter',
        'pull_std', 'pull_std_robust', 'frac_within_3sig'}
SMALL = dict(ntrials=6, npix=200)


@pytest.fixture(scope='module')
def models():
    """The synthetic 4,4,4,3 grid at 1024 px: (port's, reference's)."""
    return (simulation.build_template_model(4, 4, 4, 3, npix=1024,
                                            device='cpu'),
            rsim.build_template_model(4, 4, 4, 3, npix=1024))


def _run_both(models, config):
    tm, rtm = models
    got = validation.run_accuracy(templates={'acc': tm}, config=config,
                                  **SMALL)
    want = rvalidation.run_accuracy(templates={'acc': rtm},
                                    config=freeze(config), **SMALL)
    return got, want


def _assert_within_half_sigma(got, want):
    (stats, raw), (rstats, rraw) = got, want
    assert set(stats) == set(rstats) == KEYS
    np.testing.assert_array_equal(raw['v0'], rraw['v0'])
    dv = np.abs(raw['vfit'] - rraw['vfit'])
    assert (dv < 0.5 * rraw['verr']).all(), dv / rraw['verr']
    assert stats['ntrials'] == SMALL['ntrials']


def test_pull_harness_matches_reference(models):
    """Scan -> NM -> refinement: per-trial velocities within sigma/2
    (they agree to ~1e-11 sigma), the same statistics keys."""
    _assert_within_half_sigma(*_run_both(models, CONFIG))


def test_pull_harness_with_the_polish_recovers_velocities(models):
    """The default pipeline (second_minimizer: the gradient polish
    before the refinement) on the port alone: every velocity within
    max(10 km/s, 5 sigma), finite statistics."""
    stats, raw = validation.run_accuracy(templates={'acc': models[0]},
                                         **SMALL)
    assert set(stats) == KEYS and all(np.isfinite(list(stats.values())))
    assert (np.abs(raw['vfit'] - raw['v0'])
            < np.maximum(10.0, 5 * raw['verr'])).all()


@pytest.mark.slow
def test_pull_harness_with_the_polish_matches_reference(models):
    """As test_pull_harness_matches_reference, with the polish (the
    reference's polish program compiles for minutes on the CPU)."""
    _assert_within_half_sigma(*_run_both(
        models, dict(CONFIG, second_minimizer=True)))


def test_main_writes_statistics(tmp_path, monkeypatch, capsys, models):
    """--cpu --output: the JSON line and a file with the git revision,
    the device and the date."""
    monkeypatch.setattr(simulation, 'build_template_model',
                        lambda *a, **k: models[0])
    out = tmp_path / 'v.json'
    validation.main(['--ntrials', '3', '--npix', '150', '--cpu',
                     '--output', str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == KEYS and printed['ntrials'] == 3
    rec = json.loads(out.read_text())
    assert rec['device'] == 'cpu' and rec['git_rev'] and rec['date']
    assert {k: rec[k] for k in KEYS} == printed
