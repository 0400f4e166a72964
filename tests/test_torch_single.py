"""Parity of the port's single-object fit with the JAX reference (float64,
CPU): resolution builders, the single-trial chi-square, FusedChisq,
find_best, the single-object CCF, Nelder-Mead's float64 bookkeeping,
the velocity gradient through kernel A, and vel_fit.process and
firstguess.

The reference's process and firstguess compile their Nelder-Mead, BFGS
and Hessian programs for minutes on the CPU, so the tests that run
them are marked slow; tier 1 holds the port's process to its own RV
recovery, to the reference's chi-square at the port's optimum and to
finite differences of the reference's chi-square."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import synth
from conftest import SETUP_NAME
from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.fit import ccf as rccf
from rvspecfit_tpu.fit import find_best as rfind
from rvspecfit_tpu.fit import likelihood as rlik
from rvspecfit_tpu.fit import neldermead as rnm
from rvspecfit_tpu.fit import vel_fit as rvf
from rvspecfit_tpu.fit.spec_data import SpecData as RSpecData
from rvspecfit_tpu.interp.api import TemplateModel as RTemplateModel
from rvspecfit_tpu.interp.grid import GridInterpState as RGridInterpState
from rvspecfit_tpu.ops import chisq as rchisq
from rvspecfit_tpu.ops import resolution as rres
from rvspecfit_tpu.ops.spline import SplineGeometry as RSplineGeometry
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert
from rvspecfit_torch.fit import ccf, find_best, likelihood, vel_fit
from rvspecfit_torch.fit import neldermead as nm
from rvspecfit_torch.fit.spec_data import ArmState, SpecData
from rvspecfit_torch.ops import chisq, resolution, spline, spline_eval

CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=300,
              min_vsini=1e-2, min_vel_step=0.2)
OPTIONS = {'npoly': 6}
TRUTH = dict(vel=120.0, teff=6500.0, logg=2.5, feh=-0.8, alpha=0.4)
START = dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5)
ARMS = [(4600.0, 5000.0), (5000.0, 5400.0)]


@pytest.fixture(scope='module')
def models():
    rtm = rsim.build_template_model(3, 3, 3, 2, npix=512)
    return rtm, convert.template_model(rtm, device='cpu')


def _object(seed=0, npix=200, resolution=False, snr=80.0):
    """One star in the two arms: (reference SpecData list, port SpecData
    list), the second arm with a Gaussian resolution matrix if asked."""
    rsds = []
    for k, (l0, l1) in enumerate(ARMS):
        lam, spec, espec = rsim.observed_spectrum(
            TRUTH['vel'], TRUTH['teff'], TRUTH['logg'], TRUTH['feh'],
            TRUTH['alpha'], npix=npix, lam0=l0, lam1=l1, snr=snr,
            seed=seed + k)
        res = rres.gaussian_resolution_matrix(lam, resol=3000.0) \
            if resolution and k else None
        rsds.append(RSpecData(f'arm{k}', lam, spec, espec, resolution=res))
    return rsds, [convert.spec_data(sd) for sd in rsds]


def _templates(tm):
    return {f'arm{k}': tm for k in range(len(ARMS))}


def _trials(n=7, seed=5):
    rng = np.random.RandomState(seed)
    vels = rng.uniform(-500, 500, n)
    params = np.array([TRUTH[p] for p in ('teff', 'logg', 'feh', 'alpha')])
    params = params + rng.normal(size=(n, 4)) * [600.0, 0.5, 0.3, 0.2]
    return vels, params, rng.uniform(0.0, 50.0, n)


# ------------------------------------------------------------------
# host builders and the single-trial chi-square

@pytest.mark.parametrize('kind', ['resol', 'width', 'desi'])
def test_resolution_builders_match_reference(kind):
    """The port's host builders against the reference's, as dense
    matrices: within 1e-12."""
    lam = np.linspace(4600.0, 4700.0, 120)
    if kind == 'resol':
        args, fn = (lam,), dict(resol=np.linspace(2000.0, 5000.0, 120))
    elif kind == 'width':
        args, fn = (lam,), dict(width=0.6)
    if kind == 'desi':
        band = np.random.RandomState(2).uniform(0.0, 1.0, (11, 120))
        got = resolution.banded_from_desi_resolution(band)
        want = rres.banded_from_desi_resolution(band)
    else:
        got = resolution.gaussian_resolution_matrix(*args, **fn)
        want = rres.gaussian_resolution_matrix(*args, **fn)
    assert got.offsets == want.offsets
    np.testing.assert_allclose(got.to_dense(), want.to_dense(), rtol=0,
                               atol=1e-12)
    x = np.random.RandomState(4).normal(size=120)
    np.testing.assert_allclose(
        resolution.BandedMatrix(got.offsets, torch.as_tensor(
            got.bands)).matvec(torch.as_tensor(x)),
        want.matvec(jnp.asarray(x)), rtol=1e-12, atol=1e-12)


def test_gaussian_resolution_matrix_rejects_bad_arguments():
    lam = np.linspace(4600.0, 4700.0, 20)
    with pytest.raises(ValueError, match='exactly one'):
        resolution.gaussian_resolution_matrix(lam)
    with pytest.raises(ValueError, match='increasing'):
        resolution.gaussian_resolution_matrix(lam[::-1], width=0.5)


def test_chisq_continuum_marg_matches_reference():
    """chi-square and continuum coefficients of one template: 1e-9
    relative."""
    rng = np.random.RandomState(1)
    lam = np.linspace(4600.0, 5000.0, 150)
    from rvspecfit_torch.ops import basis
    polys = basis.continuum_basis(lam, 7)
    espec = rng.uniform(0.5, 1.5, 150)
    spec = 3.0 + rng.normal(size=150)
    templ = 1.0 + 0.3 * np.sin(lam / 7.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    got = chisq.chisq_continuum_marg(t(spec / espec), t(templ / espec),
                                     t(polys), t(np.log(espec).sum()),
                                     with_coeffs=True)
    want = rchisq.chisq_continuum_marg(
        jnp.asarray(spec / espec), jnp.asarray(templ / espec),
        jnp.asarray(polys), jnp.asarray(np.log(espec).sum()),
        with_coeffs=True)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9,
                               atol=1e-9 * np.abs(want[1]).max())


# ------------------------------------------------------------------
# SpecData, ArmState and FusedChisq

def test_spec_data_identity_and_resolution_rules(models):
    _, tm = models
    _, (a, b) = _object(resolution=True)
    assert a == a and a != b and hash(a) != hash(b) and len({a, b}) == 2
    assert len(b) == 200 and repr(b).startswith("SpecData('arm1', npix=200")
    with pytest.raises(TypeError, match='BandedMatrix'):
        SpecData('x', a.lam, a.spec, a.espec, resolution=np.eye(3))
    rm = resolution.gaussian_resolution_matrix(b.lam, width=0.5)
    with pytest.raises(ValueError, match='cannot be combined'):
        ArmState.build(b, tm.geom, resol_matrix=rm, device='cpu')
    # fast_interp is ported (tests/test_torch_fast_interp.py): the
    # nearest-pixel likelihood builds and evaluates
    fast = likelihood.FusedChisq([a], {'arm0': tm}, CONFIG,
                                 options={'fast_interp': True})
    assert fast.fast_interp and np.isfinite(
        fast.chisq_one(120.0, [6500.0, 2.5, -0.8, 0.4]))


FUSED_CASES = {
    'plain': dict(),
    'vsini': dict(use_vsini=True),
    'resol_mats': dict(resol_mats=True),
    'specdata_resolution': dict(resolution=True),
    'espec_systematic': dict(espec_systematic={'arm0': 0.01, 'arm1': 0.02},
                             use_vsini=True),
}


def _fused_pair(models, case):
    rtm, tm = models
    kw = dict(FUSED_CASES[case])
    rsds, psds = _object(resolution=kw.pop('resolution', False))
    rmats = pmats = None
    if kw.pop('resol_mats', False):
        rmats = {'arm0': rres.gaussian_resolution_matrix(rsds[0].lam,
                                                          width=0.7)}
        pmats = {'arm0': convert.banded_matrix(rmats['arm0'])}
    ref = rlik.FusedChisq(rsds, _templates(rtm), CONFIG, options=OPTIONS,
                          resol_mats=rmats, **kw)
    got = likelihood.FusedChisq(psds, _templates(tm), CONFIG,
                                options=OPTIONS, resol_mats=pmats, **kw)
    return ref, got, kw.get('use_vsini', False)


@pytest.mark.parametrize('case', sorted(FUSED_CASES))
def test_fused_chisq_trials_match_reference(models, case):
    """chisq_trials (whole and chunked with a padded last chunk) and
    chisq_one: 1e-8 relative."""
    ref, got, use_vsini = _fused_pair(models, case)
    vels, params, vs = _trials()
    vs = vs if use_vsini else None
    want = np.asarray(ref.chisq_trials(jnp.asarray(vels),
                                       jnp.asarray(params),
                                       None if vs is None
                                       else jnp.asarray(vs)))
    np.testing.assert_allclose(got.chisq_trials(vels, params, vs), want,
                               rtol=1e-8)
    np.testing.assert_allclose(got.chisq_trials(vels, params, vs, chunk=3),
                               want, rtol=1e-8)
    np.testing.assert_allclose(
        got.chisq_one(vels[0], params[0], None if vs is None else vs[0]),
        want[0], rtol=1e-8)


@pytest.mark.parametrize('case', ['plain', 'specdata_resolution', 'vsini'])
def test_full_output_matches_reference(models, case):
    """Models, raw models, chi-square and the per-arm arrays at one
    point: 1e-8 relative."""
    ref, got, use_vsini = _fused_pair(models, case)
    vsini = 12.0 if use_vsini else None
    params = np.array([6300.0, 2.7, -0.9, 0.3])
    want = ref.full_output(115.0, params, vsini)
    out = got.full_output(115.0, params, vsini)
    np.testing.assert_allclose(out['chisq'], want['chisq'], rtol=1e-8)
    np.testing.assert_allclose(out['logl'], want['logl'], rtol=1e-8)
    for key in ('models', 'raw_models'):
        for g, w in zip(out[key], want[key]):
            np.testing.assert_allclose(g, w, rtol=1e-8,
                                       atol=1e-10 * np.abs(w).max())
    for key in ('chisq_array', 'red_chisq_array'):
        np.testing.assert_allclose(out[key], want[key], rtol=1e-8)
    assert out['npix_array'] == want['npix_array']


def test_get_chisq_continuum_matches_reference():
    rsds, psds = _object(resolution=True)
    for opts in (None, {'npoly': 4, 'rbf_continuum': False}):
        want = rlik.get_chisq_continuum(rsds, options=opts)
        got = likelihood.get_chisq_continuum(psds, options=opts)
        for key in ('chisq_array', 'redchisq_array'):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-8)


@pytest.mark.parametrize('vsini', [None, 20.0])
def test_find_best_matches_reference(models, vsini):
    """Every key: best_vel within 1e-6 km/s, the grid and the moments
    within 1e-8 relative."""
    case = 'vsini' if vsini else 'specdata_resolution'
    ref, got, _ = _fused_pair(models, case)
    grid = np.arange(-1000.0, 1000.0, 5.0)
    plist = [[5000.0, 2.0, -1.0, 0.2], [6500.0, 2.5, -0.8, 0.4],
             [8000.0, 4.0, -0.5, 0.8]]
    want = convert.host(rfind.find_best(ref, grid, plist, vsini=vsini))
    out = find_best.find_best(got, grid, plist, vsini=vsini, chunk=800)
    assert abs(out['best_vel'] - want['best_vel']) <= 1e-6
    np.testing.assert_array_equal(out['best_param'], want['best_param'])
    np.testing.assert_allclose(out['chisq_grid'], want['chisq_grid'],
                               rtol=1e-8)
    for key in ('best_chi', 'vel_err', 'kurtosis', 'skewness'):
        np.testing.assert_allclose(out[key], want[key], rtol=1e-8)
    np.testing.assert_allclose(out['probs'], want['probs'], rtol=1e-6,
                               atol=1e-12)
    assert abs(out['best_vel'] - TRUTH['vel']) < 10.0
    for i in (0, 5, 399):
        assert find_best.quadratic_interp_min(
            grid, want['chisq_grid'][:, 1], i) == \
            rfind.quadratic_interp_min(grid, want['chisq_grid'][:, 1], i)


def test_ccf_fit_matches_reference(pipeline_library):
    """The single-object CCF on the pipeline library: the same best
    template, velocity within 1e-6 km/s, the same curve and models."""
    lam, spec, espec = synth.observed_spectrum(
        -140.0, 5600.0, 3.2, -0.6, 0.4, npix=700, lam0=4620.0,
        lam1=5380.0, snr=60.0, seed=4)
    rsd = RSpecData(SETUP_NAME, lam, spec, espec)
    cfg = dict(template_lib=pipeline_library, max_vel=800, vel_step0=4)
    want = rccf.fit(rsd, cfg)
    got = ccf.fit(convert.spec_data(rsd), cfg, device='cpu')
    assert got['best_par'] == want['best_par']
    assert got['best_vsini'] == want['best_vsini']
    assert abs(got['best_vel'] - want['best_vel']) <= 1e-6
    assert abs(got['best_vel'] + 140.0) < 20.0
    np.testing.assert_array_equal(got['vel_grid'], want['vel_grid'])
    np.testing.assert_allclose(got['best_ccf'], want['best_ccf'],
                               rtol=1e-8)
    np.testing.assert_allclose(got['proc_spec'][SETUP_NAME],
                               want['proc_spec'][SETUP_NAME], rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_array_equal(got['best_model'][SETUP_NAME],
                                  want['best_model'][SETUP_NAME])


def test_make_ccf_spectrum_functions_match_reference():
    """make_ccf's single-spectrum functions (continuum, bad-pixel
    infill, CCF preprocessing) against the reference's: 1e-8
    relative (40 IRLS steps amplify last-bit differences)."""
    from rvspecfit_tpu.pipeline import make_ccf as rmake_ccf
    from rvspecfit_torch.pipeline import make_ccf
    lam, spec, espec = rsim.observed_spectrum(
        80.0, 5200.0, 2.0, -1.0, 0.3, npix=300, lam0=4700.0, lam1=5100.0,
        snr=40.0, seed=2)
    bad = np.zeros(300, bool)
    bad[40:52] = bad[:3] = True
    conf = make_ccf.get_ccf_config(np.log(4720.0), np.log(5080.0), 512)
    np.testing.assert_allclose(
        make_ccf.get_continuum(lam, spec, espec, conf, device='cpu'),
        rmake_ccf.get_continuum(lam, spec, espec, conf), rtol=1e-8)
    np.testing.assert_array_equal(make_ccf.interp_masker(lam, spec, bad),
                                  rmake_ccf.interp_masker(lam, spec, bad))
    got = make_ccf.preprocess_data(lam, spec, espec, conf, badmask=bad,
                                   device='cpu')
    want = rmake_ccf.preprocess_data(lam, spec, espec, conf, badmask=bad)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-10 * w.max())


def test_ccf_fit_checks_setups_and_failures(models):
    """Two setups with different banks raise; a non-finite best
    chi-square raises; an in-memory bank without models rolls the
    inverse rFFT of its best row."""
    bank = rsim.build_ccf_bank(3, 3, 3, 2, npix=512, every=2, step=2.0)
    other = rsim.build_ccf_bank(3, 3, 3, 2, npix=512, every=3, step=2.0)
    _, psds = _object()
    cfg = dict(max_vel=600, vel_step0=10)
    banks = {'arm0': convert.ccf_bank(*bank, device='cpu'),
             'arm1': convert.ccf_bank(*other, device='cpu')}
    with pytest.raises(RuntimeError, match='differ between setups'):
        ccf.fit(psds, cfg, banks=banks)
    banks['arm1'] = banks['arm0']
    out = ccf.fit(psds, cfg, banks=banks)
    assert abs(out['best_vel'] - TRUTH['vel']) < 30.0
    best = [list(p) for p in bank[2]['params']].index(
        list(out['best_par'].values()))
    row = np.fft.irfft(bank[0][best], n=bank[2]['ccfconf']['npoints'])
    step = (np.exp((bank[2]['ccfconf']['logl1'] - bank[2]['ccfconf'][
        'logl0']) / bank[2]['ccfconf']['npoints']) - 1) * 3e5
    np.testing.assert_allclose(
        out['best_model']['arm0'],
        np.roll(row, int(out['best_vel'] / step)), rtol=0, atol=1e-12)
    bad = SpecData('arm0', psds[0].lam, np.full(200, np.nan),
                   psds[0].espec)
    with pytest.raises(RuntimeError, match='Cross-correlation'):
        ccf.fit([bad], cfg, banks=banks)


# ------------------------------------------------------------------
# Nelder-Mead bookkeeping and the velocity gradient

def _rosen(x):
    return ((1 - x[..., :-1])**2
            + 100 * (x[..., 1:] - x[..., :-1]**2)**2).sum(-1)


def test_minimize_batch_matches_reference():
    """minimize_batch against the reference's on Rosenbrock from the
    same simplexes: same iterations, convergence and sorted simplexes
    (1e-9: the centroid sums round in another order, and hundreds of
    iterations compound that to ~1e-10)."""
    x0 = np.array([[-1.2, 1.0, 0.5], [0.3, 0.1, 2.0]])
    simplex = nm.build_simplex(x0, np.array([0.5, 0.5, 0.5]),
                               vel_fit.SIMPLEX_SEED)
    want = rnm.minimize_batch(_rosen, jnp.asarray(simplex), fatol=1e-8,
                              xatol=(1e-5, 1e-5, 1e-5), maxiter=3000)
    got = nm.minimize_batch(_rosen, torch.as_tensor(simplex), fatol=1e-8,
                            xatol=(1e-5, 1e-5, 1e-5), maxiter=3000)
    assert got['nit'] == int(want['nit'])
    np.testing.assert_array_equal(got['converged'], want['converged'])
    np.testing.assert_allclose(got['final_simplex'], want['final_simplex'],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got['fun'], want['fun'], rtol=1e-9,
                               atol=1e-14)


def test_minimize_batch_keeps_float64_bookkeeping():
    """A float32 objective gets float32 points; the simplex, values and
    result stay float64, and the iteration cap holds mid-chunk."""
    seen = set()

    def fun(x):
        seen.add(x.dtype)
        return _rosen(x)

    simplex = torch.as_tensor(nm.build_simplex(
        np.array([[-1.2, 1.0]]), np.array([0.5, 0.5]),
        vel_fit.SIMPLEX_SEED))
    out = nm.minimize_batch(fun, simplex, fatol=1e-12, xatol=1e-12,
                            maxiter=70, dtype=torch.float32)
    assert seen == {torch.float32}
    assert out['x'].dtype == out['fun'].dtype == torch.float64
    assert out['nit'] == 70 and not bool(out['converged'][0])


@pytest.mark.parametrize('log_step', [True, False])
def test_velocity_gradient_through_derivative_coeffs(log_step):
    """d out/du of the plain evaluation equals the evaluation of the
    derivative's coefficients (1e-12 of max|du|), and the autograd pair
    carries it (gradcheck in the queries and the coefficients)."""
    xs = np.exp(np.linspace(np.log(4550.0), np.log(4650.0), 40)) \
        if log_step else np.linspace(4550.0, 4650.0, 40)
    geom = spline.SplineGeometry.from_knots(xs, log_step, device='cpu')
    rng = np.random.RandomState(1)
    c = torch.tensor(rng.normal(size=(3, 4, 39)), requires_grad=True)
    u = torch.tensor(np.sort(rng.uniform(-2.0, 41.0, (3, 25)), 1),
                     requires_grad=True)
    g = torch.tensor(rng.normal(size=(3, 25)))
    want, = torch.autograd.grad(
        spline_eval.spline_eval_index_plain(geom, c, u), u, g)
    got = g * spline_eval.spline_eval_index_plain(
        geom, spline_eval.derivative_coeffs(geom, c.detach()), u.detach())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * float(want.abs().max()))
    fwd = lambda c, u: spline_eval.SplineEval.apply(c, u, geom,
                                                    spline_eval.PLAIN)
    assert torch.autograd.gradcheck(fwd, (c, u))


# ------------------------------------------------------------------
# process and firstguess

def _half_chisq_hessian_fd(fused, vel, params, vsini, h):
    """Central-difference Hessian of 0.5 chisq of the reference's
    FusedChisq in the parameters, steps h (n,)."""
    n = len(params)
    e = np.eye(n)
    pts = [params]
    for i in range(n):
        pts += [params + h[i] * e[i], params - h[i] * e[i]]
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    for i, j in pairs:
        pts += [params + si * h[i] * e[i] + sj * h[j] * e[j]
                for si, sj in ((1, 1), (1, -1), (-1, 1), (-1, -1))]
    pts = np.array(pts)
    f = 0.5 * np.asarray(fused.chisq_trials(
        jnp.full(len(pts), vel), jnp.asarray(pts),
        None if vsini is None else jnp.full(len(pts), vsini)))
    hess = np.zeros((n, n))
    for i in range(n):
        hess[i, i] = (f[1 + 2 * i] - 2 * f[0] + f[2 + 2 * i]) / h[i]**2
    base = 1 + 2 * n
    for k, (i, j) in enumerate(pairs):
        fpp, fpm, fmp, fmm = f[base + 4 * k:base + 4 * k + 4]
        hess[i, j] = hess[j, i] = (fpp - fpm - fmp + fmm) / (4 * h[i] * h[j])
    return hess


@pytest.mark.parametrize('second_minimizer', [False, True])
def test_process_recovers_and_matches_reference_chisq(models,
                                                      second_minimizer):
    """The port's process: RV within max(10 km/s, 3 sigma) (the gate of
    tests/test_fit_fake.py); its chi-square is the reference's at the
    port's optimum (1e-6 relative); its errors are those of the
    finite-difference Hessian of the reference's chi-square (1%)."""
    rtm, tm = models
    rsds, psds = _object(seed=7, npix=300)
    cfg = dict(CONFIG, second_minimizer=second_minimizer)
    res = vel_fit.process(psds, START, config=cfg, options=OPTIONS,
                          templates=_templates(tm))
    assert abs(res['vel'] - TRUTH['vel']) < max(10.0, 3 * res['vel_err'])
    assert res['minimize_success'] and not res['bad_hessian']
    assert set(res) == {'param', 'param_err', 'param_covar', 'vel',
                        'vel_err', 'vel_skewness', 'vel_kurtosis', 'yfit',
                        'raw_models', 'chisq', 'logl', 'chisq_array',
                        'npix_array', 'minimize_success', 'bad_hessian'}
    params = np.array([res['param'][p] for p in tm.parnames])
    ref = rlik.FusedChisq(rsds, _templates(rtm), freeze(cfg),
                          options=OPTIONS)
    np.testing.assert_allclose(res['chisq'],
                               ref.chisq_one(res['vel'], params),
                               rtol=1e-6)
    err = np.array([res['param_err'][p] for p in tm.parnames])
    hess = _half_chisq_hessian_fd(ref, res['vel'], params, None,
                                  0.01 * err)
    err_fd = np.sqrt(np.diag(np.linalg.inv(hess)))
    np.testing.assert_allclose(err, err_fd, rtol=0.01)
    assert [m.shape for m in res['yfit']] == [(300,), (300,)]


def test_process_with_vsini_priors_and_resolution(models):
    """Rotation fitted, a prior, a fixed parameter and a per-call
    resolution: RV recovered, the fixed parameter kept, and the
    chi-square is the reference's at the port's optimum (1e-6)."""
    rtm, tm = models
    rsds, psds = _object(seed=3, npix=250)
    rmats = {'arm1': rres.gaussian_resolution_matrix(rsds[1].lam,
                                                     width=0.4)}
    cfg = dict(CONFIG, second_minimizer=True)
    start = dict(START, vsini=5.0)
    priors = {'feh': (-0.8, 0.3)}
    res = vel_fit.process(psds, start, fixParam=['alpha'], config=cfg,
                          options=OPTIONS, templates=_templates(tm),
                          priors=priors, resolParams={
                              'arm1': convert.banded_matrix(rmats['arm1'])})
    assert abs(res['vel'] - TRUTH['vel']) < max(10.0, 3 * res['vel_err'])
    assert res['param']['alpha'] == 0.5 and 'vsini' in res
    ref = rlik.FusedChisq(rsds, _templates(rtm), freeze(cfg),
                          options=OPTIONS, resol_mats=rmats,
                          use_vsini=True)
    params = np.array([res['param'][p] for p in tm.parnames])
    np.testing.assert_allclose(
        res['chisq'], ref.chisq_one(res['vel'], params, res['vsini']),
        rtol=1e-6)


@pytest.fixture(scope='module')
def fake_models():
    """test_fit_fake's template model (6x6x6x4 at 2048 px), reference
    and port."""
    lam, uvecs, idgrid, vecs, specs, parnames = synth.make_template_grid(
        6, 6, 6, 4, npix=2048)
    rtm = RTemplateModel(
        kind='grid', state=RGridInterpState.build(uvecs, idgrid, vecs,
                                                  specs, log_spec=True),
        geom=RSplineGeometry.from_knots(lam, log_step=True),
        parnames=parnames, log_ids=(0,))
    return rtm, convert.template_model(rtm, device='cpu')


FAKE_CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
                   min_vsini=1e-2, min_vel_step=0.2, second_minimizer=False,
                   template_lib='')


def _assert_process_close(got, want, names):
    sig = np.array([want['param_err'][p] for p in names])
    dv = abs(got['vel'] - want['vel'])
    assert dv <= max(0.1, 0.05 * want['vel_err']), dv
    dp = np.abs([got['param'][p] - want['param'][p] for p in names])
    assert (dp <= 0.05 * sig).all(), dp / sig
    gerr = np.array([got['param_err'][p] for p in names])
    np.testing.assert_allclose(gerr, sig, rtol=0.02)
    np.testing.assert_allclose(got['vel_err'], want['vel_err'], rtol=0.02)
    assert got['bad_hessian'] == want['bad_hessian']
    assert got['minimize_success'] == want['minimize_success']


@pytest.mark.slow
@pytest.mark.parametrize('second_minimizer', [False, True])
def test_process_matches_reference_process(fake_models, second_minimizer):
    """process against the reference's on test_fit_fake's inputs:
    velocity within max(0.1 km/s, 0.05 sigma), parameters within 0.05
    sigma, errors within 2%, the same flags."""
    rtm, tm = fake_models
    v0 = float(np.random.RandomState(44).normal(0, 100))
    lam, spec, espec = synth.observed_spectrum(
        v0, 5400.0, 2.2, -0.8, 0.25, npix=800, snr=1000.0, seed=11)
    start = dict(teff=5000.0, logg=2.0, feh=0.0, alpha=0.2, vsini=0.1)
    cfg = dict(FAKE_CONFIG, second_minimizer=second_minimizer)
    want = rvf.process([RSpecData('config1', lam, spec, espec)], start,
                       options={'npoly': 15}, config=freeze(cfg),
                       templates={'config1': rtm})
    got = vel_fit.process([SpecData('config1', lam, spec, espec)], start,
                          options={'npoly': 15}, config=cfg,
                          templates={'config1': tm})
    _assert_process_close(got, want, tm.parnames)
    assert abs(got['vsini'] - want['vsini']) <= 0.05 * max(
        1.0, abs(want['vsini']))


@pytest.mark.slow
def test_firstguess_matches_reference_firstguess(fake_models):
    """firstguess against the reference's on test_fit_fake's input, over
    its default grids: the same start."""
    rtm, tm = fake_models
    lam, spec, espec = synth.observed_spectrum(
        300.0, 8000.0, 4.0, -1.0, 0.0, npix=700, snr=100.0, seed=21)
    want = rvf.firstguess([RSpecData('config1', lam, spec, espec)],
                          config=freeze(FAKE_CONFIG), options={'npoly': 10},
                          templates={'config1': rtm})
    got = vel_fit.firstguess([SpecData('config1', lam, spec, espec)],
                             config=FAKE_CONFIG, options={'npoly': 10},
                             templates={'config1': tm})
    assert got == want
