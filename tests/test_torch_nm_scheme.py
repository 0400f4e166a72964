"""The port's Nelder-Mead candidate schemes (RVST_NM_SCHEME: scan2 and
cand4) against scipy, as tests/test_neldermead.py holds the reference's,
and run_neldermead's accounting under each scheme and RVST_NM_CHUNK."""
import numpy as np
import pytest
import scipy.optimize
import torch

import synth
from rvspecfit_torch import convert
from rvspecfit_torch.fit import neldermead as nm
from rvspecfit_torch.fit import vel_fit
from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
from rvspecfit_tpu.interp.api import TemplateModel
from rvspecfit_tpu.interp.grid import GridInterpState
from rvspecfit_tpu.ops.spline import SplineGeometry

SCHEMES = ['scan2', 'cand4']
CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2, second_minimizer=False)
NFIB = 4


@pytest.fixture(params=SCHEMES)
def scheme(request, monkeypatch):
    monkeypatch.setenv('RVST_NM_SCHEME', request.param)
    return request.param


def _rosen(x):
    return (100.0 * (x[..., 1:] - x[..., :-1]**2)**2
            + (1.0 - x[..., :-1])**2).sum(-1)


def test_rosenbrock_batch_matches_scipy(scheme):
    """16 4-D Rosenbrock instances (global minimum 1...1 and a local one
    at f ~ 3.70) from the same simplexes as scipy: the same stationary
    points."""
    x0 = np.random.RandomState(0).uniform(-2, 2, size=(16, 4))
    simplex = nm.build_simplex(x0, np.full(4, 0.5), vel_fit.SIMPLEX_SEED)
    res = nm.minimize_batch(_rosen, torch.as_tensor(simplex), fatol=1e-10,
                            xatol=1e-10, maxiter=5000)
    assert bool(res['converged'].all())
    for i in range(16):
        ref = scipy.optimize.minimize(
            _rosen, simplex[i, 0], method='Nelder-Mead',
            options=dict(initial_simplex=simplex[i], fatol=1e-10,
                         xatol=1e-10, maxiter=5000, maxfev=np.inf))
        np.testing.assert_allclose(float(res['fun'][i]), ref.fun, atol=1e-8,
                                   err_msg=f'instance {i}')
        np.testing.assert_allclose(res['x'][i].numpy(), ref.x, atol=1e-4,
                                   err_msg=f'instance {i}')


def test_matches_scipy_on_quadratic(scheme):
    a = np.array([1.0, 3.0, 0.5])

    def f(x):
        d = x - (torch.as_tensor(a) if torch.is_tensor(x) else a)
        return (d**2).sum(-1) + 0.3 * x[..., 0] * x[..., 1]

    simplex = nm.build_simplex(np.zeros((1, 3)), np.full(3, 0.7),
                               vel_fit.SIMPLEX_SEED)
    ref = scipy.optimize.minimize(
        f, simplex[0, 0], method='Nelder-Mead',
        options=dict(initial_simplex=simplex[0], fatol=1e-8, xatol=1e-8,
                     maxiter=10000))
    got = nm.minimize_batch(f, torch.as_tensor(simplex),
                            fatol=1e-8, xatol=1e-8, maxiter=10000,
                            scheme=scheme)
    np.testing.assert_allclose(got['x'][0].numpy(), ref.x, atol=1e-5)
    np.testing.assert_allclose(float(got['fun'][0]), ref.fun, atol=1e-8)


def test_unknown_scheme_raises(monkeypatch):
    """No silent fallback: an unknown RVST_NM_SCHEME (or scheme=) raises
    before any evaluation; the default is scan2."""
    monkeypatch.delenv('RVST_NM_SCHEME', raising=False)
    assert nm.nm_scheme() == 'scan2' and nm.nm_ncand() == 2
    assert nm.nm_ncand('cand4') == 4
    simplex = torch.as_tensor(nm.build_simplex(
        np.zeros((1, 2)), np.full(2, 0.5), vel_fit.SIMPLEX_SEED))
    monkeypatch.setenv('RVST_NM_SCHEME', 'cand3')
    calls = []
    for run in (lambda: nm.minimize_batch(lambda x: calls.append(x)
                                          or _rosen(x), simplex),
                lambda: nm.nm_ncand(),
                lambda: nm.minimize_batch(_rosen, simplex, scheme='scan4')):
        with pytest.raises(ValueError, match='scheme'):
            run()
    assert calls == []


@pytest.fixture(scope='module')
def fitter_and_mapper():
    """A 4x4x3x2 grid at 512 px (the reference's template model,
    carried over) and 4 fibers of 300 px."""
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


def _counted_run(bf, mapper, **kw):
    """run_neldermead with its objective's rows counted by the number
    of points per instance (K) and its iterations and chunk lengths
    recorded: (result, {K: [rows per call]}, steps, chunks)."""
    rows, steps, chunks = {}, [0], []
    real_objective, real_step, real_chunk = (
        BatchedFitter._objective, nm._step, nm.nm_chunk)

    def objective(self, *args):
        fun = real_objective(self, *args)

        def counted(x):
            rows.setdefault(x.shape[1], []).append(x.shape[0] * x.shape[1])
            return fun(x)
        return counted

    def step(*args):
        steps[0] += 1
        return real_step(*args)

    def chunk(*args):
        chunks.append(args[6])
        return real_chunk(*args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchedFitter, '_objective', objective)
        mp.setattr(nm, '_step', step)
        mp.setattr(nm, 'nm_chunk', chunk)
        res = bf.run_neldermead(mapper, np.zeros(NFIB), **kw)
    return res, rows, steps[0], chunks


def test_obj_evals_count_the_scheme_trials(fitter_and_mapper, scheme):
    """obj_evals = (nvec + 1) per simplex set up + nm_ncand (2 under
    scan2, 4 under cand4) per fiber and iteration; the iterations call
    the objective once (cand4, 4 points per fiber) or twice (scan2, one
    point each); the two schemes reach the same optima."""
    bf, mapper = fitter_and_mapper
    nvec = mapper.nvec
    res, rows, steps, _ = _counted_run(bf, mapper, maxiter=64,
                                       maxrestart=1)
    k = nm.nm_ncand(scheme)
    kk = 4 if scheme == 'cand4' else 1
    assert set(rows) <= {kk, nvec + 1}
    assert len(rows[kk]) == steps * (1 if scheme == 'cand4' else 2)
    fiber_iters = sum(rows[kk]) // k
    # the first (nvec + 1)-point call is the one set-up (no restart);
    # later ones are shrink steps, which obj_evals does not count
    setup = rows[nvec + 1][0]
    assert setup == NFIB * (nvec + 1)
    assert res['obj_evals'] == setup + k * fiber_iters
    other = 'scan2' if scheme == 'cand4' else 'cand4'
    res2 = bf.run_neldermead(mapper, np.zeros(NFIB), maxiter=64,
                             maxrestart=1, scheme=other)
    np.testing.assert_allclose(res2['fun'], res['fun'], rtol=1e-12)
    np.testing.assert_array_equal(res2['converged'], res['converged'])
    assert res2['obj_evals'] - setup == \
        (res['obj_evals'] - setup) * nm.nm_ncand(other) // k


def test_nm_chunk_switch_sets_the_round_length(fitter_and_mapper,
                                               monkeypatch):
    """RVST_NM_CHUNK, set and non-zero, overrides nm_chunk: rounds of 8
    iterations; 0 keeps nm_chunk.  The optima are the same (a round's
    length only moves where converged fibers leave the tile)."""
    bf, mapper = fitter_and_mapper
    monkeypatch.setenv('RVST_NM_CHUNK', '0')
    want, _, _, chunks = _counted_run(bf, mapper, maxiter=48, nm_chunk=16)
    assert set(chunks) == {16}
    monkeypatch.setenv('RVST_NM_CHUNK', '8')
    got, _, _, chunks = _counted_run(bf, mapper, maxiter=48, nm_chunk=16)
    assert set(chunks) == {8} and len(chunks) >= 2
    np.testing.assert_allclose(got['fun'], want['fun'], rtol=1e-12)
    np.testing.assert_array_equal(got['converged'], want['converged'])
