"""Parity of the port's Nelder-Mead, parameter mapping, scan statistics
and the whole fit slice (CCF -> NM -> refinement -> models) with the
JAX reference (float64, CPU)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.fit import batch as rbatch
from rvspecfit_tpu.fit import ccf as rccf
from rvspecfit_tpu.fit import neldermead as rnm
from rvspecfit_tpu.fit import vel_fit as rvf
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert
from rvspecfit_torch.fit import batch, ccf, neldermead, vel_fit

CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2)
START = dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5)


@pytest.mark.parametrize('seed', [vel_fit.SIMPLEX_SEED,
                                  vel_fit.SIMPLEX_SEED + 1])
def test_simplex_noise_tables_equal_jax(seed):
    assert vel_fit.SIMPLEX_SEED == rvf.SIMPLEX_SEED
    for n in range(1, 9):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            (1, n, n), dtype=jnp.float64))
        np.testing.assert_array_equal(neldermead.simplex_noise(seed, n),
                                      want[0])
    x0 = np.random.RandomState(0).randn(3, 5)
    scales = np.arange(1.0, 6.0)
    np.testing.assert_array_equal(
        neldermead.build_simplex(x0, scales, seed),
        rnm.build_simplex(jnp.asarray(x0), scales, seed=seed))


def _rosen(x):
    """Batched Rosenbrock for (B, K, n) candidates, numpy-free."""
    return (100.0 * (x[..., 1:] - x[..., :-1]**2)**2
            + (1.0 - x[..., :-1])**2).sum(-1)


@pytest.mark.parametrize('scheme', ['scan2', 'cand4'])
def test_neldermead_chunks_match_reference(scheme, monkeypatch):
    """Same simplexes after init and each chunk, under either candidate
    scheme (RVST_NM_SCHEME on both sides; the reference keys its
    stepper by scheme)."""
    monkeypatch.setenv('RVST_NM_SCHEME', scheme)
    x0 = np.random.RandomState(1).uniform(-1.5, 1.5, (6, 3))
    simplex = rnm.build_simplex(jnp.asarray(x0), np.full(3, 0.3),
                                seed=vel_fit.SIMPLEX_SEED)
    fatol, xatol = 1e-8, (1e-5, 1e-5, 1e-5)
    init_r, chunk_r = rnm.make_stepper(_rosen, fatol=fatol, xatol=xatol,
                                       chunk=25)
    s_r, f_r, d_r, _ = init_r(simplex)
    s_p = torch.as_tensor(np.array(simplex))
    f_p, d_p = neldermead.nm_init(_rosen, s_p, fatol, xatol)
    for _ in range(6):
        s_r, f_r, d_r, _, it_r = chunk_r(s_r, f_r, d_r)
        s_p, f_p, d_p, it_p = neldermead.nm_chunk(_rosen, s_p, f_p, d_p,
                                                  fatol, xatol, 25)
        assert it_p == int(it_r)
        # same decisions; the centroid sums round in another order, and
        # 150 iterations compound that to ~1e-11
        np.testing.assert_allclose(s_p, s_r, rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(d_p, d_r)
    assert d_p.any() and not d_p.all()


def test_param_mapper_matches_reference():
    args = (('teff', 'logg', 'feh', 'alpha'),
            dict(START, vsini=5.0), ['logg'])
    for fit_vsini in (False, True):
        r = rvf.ParamMapper(*args, rvf.VSiniMapper(300.0, 1e-2), fit_vsini)
        p = vel_fit.ParamMapper(*args, vel_fit.VSiniMapper(300.0, 1e-2),
                                fit_vsini)
        assert p.nvec == r.nvec
        assert p.get_fitted_params() == r.get_fitted_params()
        np.testing.assert_array_equal(p.start_vector(3.0),
                                      r.start_vector(3.0))
        np.testing.assert_array_equal(p.scales(), r.scales())
        x = np.random.RandomState(2).uniform(-2, 400, (4, p.nvec))
        for got, want in zip(p.unpack(torch.as_tensor(x)),
                             r.unpack(jnp.asarray(x))):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(p.unpack_host(x), r.unpack_host(x)):
            np.testing.assert_array_equal(got, want)


def test_scan_stats_match_reference():
    rng = np.random.RandomState(3)
    vels = np.tile(np.linspace(-50.0, 50.0, 21), (5, 1)) \
        + rng.uniform(-3, 3, (5, 1))
    chi = (vels - rng.uniform(-40, 40, (5, 1)))**2 / 30.0 \
        + rng.uniform(0, 0.5, vels.shape)
    chi[1] = np.linspace(0.0, 10.0, 21)          # minimum on the edge
    mask = np.ones(vels.shape, bool)
    mask[2, 15:] = False
    ref = jax.vmap(rbatch._device_scan_stats)(
        jnp.asarray(vels), jnp.asarray(mask), jnp.asarray(chi))
    got, _ = batch.scan_stats(torch.as_tensor(vels), torch.as_tensor(mask),
                              torch.as_tensor(chi))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


@pytest.fixture(scope='module')
def slice_runs():
    """The slice on 8 fibers through the reference BatchedFitter (XLA
    path on the CPU) and through the port, each stage fed by its own
    previous stage."""
    rtm = rsim.build_template_model(3, 3, 3, 2, npix=512)
    arms_data, truth = rsim.make_exposure(8, npix_arm=160, seed=3)
    bank = rsim.build_ccf_bank(3, 3, 3, 2, npix=512, every=2, step=2.0)
    cfg = dict(CONFIG, second_minimizer=False, template_lib='')
    batches = [(n, lam, fl, 1.0 / np.sqrt(iv), None)
               for n, (lam, fl, iv) in arms_data.items()]
    tm = convert.template_model(rtm, device='cpu')
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the reference's XLA path (its Pallas kernels off on the CPU)
        for var in ('RVST_PALLAS_SPLINE', 'RVST_PALLAS_CCF'):
            mp.delenv(var, raising=False)
        for side in ('ref', 'port'):
            out[side] = _run_slice(side, rtm, tm, arms_data, bank, cfg,
                                   batches)
    out['truth'] = truth
    return out


def _run_slice(side, rtm, tm, arms_data, bank, cfg, batches):
    """CCF -> NM -> refinement -> models on one side ('ref' or 'port')."""
    if side == 'ref':
        c = rccf.fit_batch(batches, freeze(cfg),
                           banks={n: bank for n in arms_data})
        bf = rbatch.BatchedFitter(
            [rbatch.BatchArm(n, *a) for n, a in arms_data.items()],
            {n: rtm for n in arms_data}, freeze(cfg), options={'npoly': 10})
        mapper = rvf.ParamMapper(rtm.parnames, START, [], None, False)
    else:
        c = ccf.fit_batch(batches, CONFIG,
                          {n: convert.ccf_bank(*bank, device='cpu')
                           for n in arms_data})
        bf = batch.BatchedFitter(
            [batch.BatchArm(n, *a) for n, a in arms_data.items()],
            {n: tm for n in arms_data}, CONFIG, options={'npoly': 10})
        mapper = vel_fit.ParamMapper(tm.parnames, START, [], None, False)
    x0 = np.concatenate([c['best_vel'][:, None], c['best_params']], 1)
    nmres = bf.run_neldermead(mapper, c['best_vel'], x0=x0)
    vel, params, _ = mapper.unpack_host(nmres['x'])
    ref = bf.refine_velocities(vel, params)
    mods = bf.best_models(ref['best_vel'], params)
    return dict(ccf=c, nm=nmres, ref=ref, models=mods)


def test_slice_ccf_and_neldermead(slice_runs):
    r, p = slice_runs['ref'], slice_runs['port']
    np.testing.assert_array_equal(p['ccf']['best_id'], r['ccf']['best_id'])
    np.testing.assert_allclose(p['ccf']['best_vel'], r['ccf']['best_vel'],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p['nm']['converged'],
                                  r['nm']['converged'])
    np.testing.assert_allclose(p['nm']['fun'], r['nm']['fun'], rtol=1e-6)


def test_slice_neldermead_cand4(slice_runs, monkeypatch):
    """The slice's NM under RVST_NM_SCHEME=cand4 on both sides, from the
    CCF starts of the scan2 runs: same convergence, values within rtol
    1e-6, and the trials counted at 4 per fiber and iteration (more
    than the scan2 run's 2)."""
    monkeypatch.setenv('RVST_NM_SCHEME', 'cand4')
    rtm = rsim.build_template_model(3, 3, 3, 2, npix=512)
    arms_data, _ = rsim.make_exposure(8, npix_arm=160, seed=3)
    tm = convert.template_model(rtm, device='cpu')
    cfg = dict(CONFIG, second_minimizer=False, template_lib='')
    res = {}
    for side in ('ref', 'port'):
        c = slice_runs[side]['ccf']
        x0 = np.concatenate([c['best_vel'][:, None], c['best_params']], 1)
        if side == 'ref':
            monkeypatch.delenv('RVST_PALLAS_SPLINE', raising=False)
            bf = rbatch.BatchedFitter(
                [rbatch.BatchArm(n, *a) for n, a in arms_data.items()],
                {n: rtm for n in arms_data}, freeze(cfg),
                options={'npoly': 10})
            mapper = rvf.ParamMapper(rtm.parnames, START, [], None, False)
        else:
            bf = batch.BatchedFitter(
                [batch.BatchArm(n, *a) for n, a in arms_data.items()],
                {n: tm for n in arms_data}, CONFIG, options={'npoly': 10})
            mapper = vel_fit.ParamMapper(tm.parnames, START, [], None,
                                         False)
        res[side] = bf.run_neldermead(mapper, c['best_vel'], x0=x0)
    r, p = res['ref'], res['port']
    np.testing.assert_array_equal(p['converged'], r['converged'])
    np.testing.assert_allclose(p['fun'], r['fun'], rtol=1e-6)
    assert p['obj_evals'] > slice_runs['port']['nm']['obj_evals']


def test_slice_refinement_and_models(slice_runs):
    r, p = slice_runs['ref'], slice_runs['port']
    np.testing.assert_allclose(p['ref']['best_vel'], r['ref']['best_vel'],
                               rtol=0, atol=1e-3)
    for key in ('vel_err', 'best_chi', 'iterations'):
        np.testing.assert_allclose(p['ref'][key], r['ref'][key], rtol=1e-6)
    for key in ('models', 'raw_models', 'cont_models'):
        for arm, want in r['models'][key].items():
            np.testing.assert_allclose(p['models'][key][arm], want,
                                       rtol=1e-8)
    for key in ('chisq', 'cont_chisq', 'red_chisq'):
        for arm, want in r['models'][key].items():
            np.testing.assert_allclose(p['models'][key][arm], want,
                                       rtol=1e-8)
    dv = p['ref']['best_vel'] - slice_runs['truth']['vel']
    assert (np.abs(dv) < np.maximum(10.0, 5 * p['ref']['vel_err'])).all()
