"""FLOP accounting of the port (rvspecfit_torch/perf.py and
run_neldermead's obj_evals): the reference's tests/test_perf.py on the
port, and the H100 peak table."""
import numpy as np
import pytest

import synth
from rvspecfit_torch import convert, perf
from rvspecfit_torch.fit import vel_fit
from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
from rvspecfit_tpu.interp.api import TemplateModel
from rvspecfit_tpu.interp.grid import GridInterpState
from rvspecfit_tpu.ops.spline import SplineGeometry

CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2, second_minimizer=False)
NFIB = 3


@pytest.fixture(scope='module')
def fitter_and_mapper():
    """tests/test_perf.py's fitter: a 4x4x3x2 grid at 512 px (built as
    the reference's template model, carried over), 3 fibers of 300 px."""
    lam, uvecs, idgrid, vecs, specs, parnames = synth.make_template_grid(
        4, 4, 3, 2, npix=512)
    state = GridInterpState.build(uvecs, idgrid, vecs, specs,
                                  log_spec=True)
    geom = SplineGeometry.from_knots(lam, log_step=True)
    tm = convert.template_model(
        TemplateModel(kind='grid', state=state, geom=geom,
                      parnames=parnames, log_ids=(0,)), device='cpu')
    rng = np.random.RandomState(3)
    dlam = np.linspace(4600, 5400, 300)
    flux = np.zeros((NFIB, dlam.size))
    ivar = np.zeros((NFIB, dlam.size))
    for i in range(NFIB):
        _, spec, espec = synth.observed_spectrum(
            rng.uniform(-200, 200), 6000.0, 3.0, -1.0, 0.5,
            npix=dlam.size, snr=100.0, seed=40 + i)
        flux[i] = spec
        ivar[i] = 1.0 / espec**2
    bf = BatchedFitter([BatchArm('config1', dlam, flux, ivar)],
                       {'config1': tm}, CONFIG, options={'npoly': 5})
    mapper = vel_fit.ParamMapper(
        tm.parnames, dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5),
        [], None, False)
    return bf, mapper


def test_run_neldermead_counts_objective_evals(fitter_and_mapper):
    bf, mapper = fitter_and_mapper
    res = bf.run_neldermead(mapper, np.zeros(NFIB), maxiter=64)
    # at least the simplex set-up (n+1 per fiber) plus some executed
    # NM iterations (2 trials each) must be counted
    nvec = len(mapper.start_vector(0.0))
    assert res['obj_evals'] > NFIB * (nvec + 1)


def test_objective_flops_per_trial_positive(fitter_and_mapper):
    """The counted products of the chi-square (2 npoly^2 npix for the
    normal matrix alone, ~1.5e4 here) plus kernel A's arithmetic (21
    FLOPs a point on a log grid, 6300 here): well over 1e4, and over
    the spline's share alone."""
    bf, mapper = fitter_and_mapper
    fpt = perf.objective_flops_per_trial(bf, mapper, ncand=4)
    assert fpt > 1e4
    assert fpt > 300 * perf.SPLINE_POINT_FLOPS['log']
    assert perf.objective_flops_per_trial(bf, mapper, width=5, ncand=2) \
        == pytest.approx(fpt, rel=1e-12)


def test_device_peak_table(monkeypatch):
    monkeypatch.setenv('RVST_PEAK_TFLOPS', '275')
    peak, label = perf.device_peak_tflops()
    assert peak == 275.0 and label == 'RVST_PEAK_TFLOPS'
    monkeypatch.delenv('RVST_PEAK_TFLOPS')
    name = 'NVIDIA H100 80GB HBM3'
    assert perf.device_peak_tflops(name)[0] == 67.0
    assert perf.device_peak_tflops(name, 'fp64')[0] == 34.0
    assert perf.device_peak_tflops(name, 'fp32')[0] == 67.0
    assert perf.device_peak_tflops('Tesla T4') == (None, 'Tesla T4')
    assert perf.device_peak_tflops('cpu') == (None, 'cpu')
    msg = perf.mfu_report(1.34e12, 2.0, name)
    assert '0.6700 TFLOP/s' in msg and '1.00% of 67 TFLOP/s' in msg
