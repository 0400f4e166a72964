"""The port's copies of the reference's small public functions, each
against the reference on the CPU: pipeline/library.get_spec_params,
serializer.verify_data, pipeline/make_ccf.preprocess_model,
ops/vsini.broaden, ops/spline.spline_eval and spline_fit_eval,
simulation.observed_spectrum, BatchedFitter.scan_chisq and the
Nelder-Mead knobs RVST_NM_XATOL_FRAC and RVST_NM_SIMPLEX_SCALE."""
import logging

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu import serializer as rserializer
from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.fit import batch as rbatch
from rvspecfit_tpu.fit import vel_fit as rvf
from rvspecfit_tpu.ops import spline as rspline
from rvspecfit_tpu.ops import vsini as rvsini
from rvspecfit_tpu.pipeline import library as rlibrary
from rvspecfit_tpu.pipeline import make_ccf as rmake_ccf
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert, serializer, simulation
from rvspecfit_torch.fit import batch, vel_fit
from rvspecfit_torch.fit import neldermead as nm
from rvspecfit_torch.ops import spline, vsini
from rvspecfit_torch.pipeline import library, make_ccf

from test_torch_tail import CONFIG, START


def test_get_spec_params_matches_reference(desi_library):
    cfg = dict(CONFIG, template_lib=desi_library)
    for s in ('desi_b', 'desi_z'):
        assert library.get_spec_params(s, cfg, device='cpu') == tuple(
            rlibrary.get_spec_params(s, cfg))


_ORIGINAL = dict(a=np.arange(4.0), b=dict(c='x', d=None, e=[1, 2.5]),
                 f=np.array([np.nan, 1.0]), g=True, h=np.int64(3),
                 i=float('nan'), j=('p', 'q'))


def _changed(path, value):
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in _ORIGINAL.items()}
    if value is KeyError:
        del out[path]
    elif '/' in path:
        out['b'][path.split('/')[1]] = value
    else:
        out[path] = value
    return out


@pytest.mark.parametrize('loaded', [
    _ORIGINAL, _changed('a', np.arange(4)), _changed('a', np.arange(5.0)),
    _changed('a', np.ones(4)), _changed('b/c', 'y'), _changed('b/d', 0),
    _changed('b/e', [1, 2]), _changed('f', np.array([np.nan, 2.0])),
    _changed('g', False), _changed('h', 3), _changed('h', 4.0),
    _changed('i', 1.0), _changed('j', ['p', 'q']), _changed('j', 'pq'),
    _changed('g', KeyError)], ids=range(15))
def test_verify_data_matches_reference(loaded, caplog):
    with caplog.at_level(logging.WARNING):
        want = rserializer.verify_data(_ORIGINAL, loaded)
        ref_log = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = serializer.verify_data(_ORIGINAL, loaded)
    assert got is want
    assert [r.getMessage() for r in caplog.records] == ref_log


@pytest.mark.parametrize('vsini_', [None, 0.0, 40.0])
@pytest.mark.parametrize('continuum', [True, False])
def test_preprocess_model_matches_reference(vsini_, continuum):
    lam = np.exp(np.linspace(np.log(4500.0), np.log(5500.0), 3000))
    model = rsim.fake_spectrum(lam, 6000.0, 3.0, -0.5, 0.2, wresol=0.5)
    conf = rmake_ccf.get_ccf_config(np.log(4600.0), np.log(5600.0), 1024,
                                    splinestep=1000 if continuum else None)
    logl = np.linspace(conf['logl0'], conf['logl1'], conf['npoints'])
    want = rmake_ccf.preprocess_model(logl, lam, model, vsini=vsini_,
                                      ccfconf=conf)
    got = make_ccf.preprocess_model(logl, lam, model, vsini=vsini_,
                                    ccfconf=conf, device='cpu')
    # the robust continuum is an iterative fit on each side
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    assert (got[logl > np.log(5500.0)] == 1.0).all()


def test_broaden_matches_reference():
    step = np.log(1 + 10.0 / 3e5)
    hw = vsini.kernel_half_width(300.0, step)
    rng = np.random.RandomState(1)
    spec = 1 + 0.1 * rng.normal(size=400)
    for vs in (0.0, 25.0, 250.0):
        want = rvsini.broaden(jnp.asarray(spec), vs, step, hw)
        got = vsini.broaden(torch.as_tensor(spec), vs, step, hw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)
    many = vsini.broaden(torch.as_tensor(np.stack([spec, 2 * spec])),
                         torch.tensor([25.0, 250.0], dtype=torch.float64),
                         step, hw)
    np.testing.assert_allclose(
        many[1].numpy(), np.asarray(rvsini.broaden(jnp.asarray(2 * spec),
                                                   250.0, step, hw)),
        rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize('log_step', [True, False])
def test_spline_eval_matches_reference(log_step):
    knots = np.exp(np.linspace(np.log(4500.0), np.log(5500.0), 200)) \
        if log_step else np.linspace(4500.0, 5500.0, 200)
    ys = np.sin(knots / 37.0) + 0.01 * knots
    rgeom = rspline.SplineGeometry.from_knots(knots, log_step=log_step)
    geom = spline.SplineGeometry.from_knots(knots, log_step=log_step,
                                            device='cpu')
    x = np.concatenate([np.linspace(4400.0, 5600.0, 777), knots[:3],
                        knots[-2:]])
    want, want_in = rspline.spline_fit_eval(rgeom, jnp.asarray(ys),
                                            jnp.asarray(x))
    got, got_in = spline.spline_fit_eval(geom, torch.as_tensor(ys), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    coeffs = spline.spline_coeffs(geom, torch.as_tensor(ys))
    v, _ = spline.spline_eval(geom, coeffs, torch.as_tensor(x[:5]))
    np.testing.assert_array_equal(v.numpy(), got.numpy()[:5])


def test_observed_spectrum_matches_reference():
    for kw in (dict(), dict(npix=300, lam0=5000.0, lam1=5300.0, wresol=1.0,
                            snr=30.0, seed=4)):
        want = rsim.observed_spectrum(123.0, 5800.0, 2.5, -1.2, 0.3, **kw)
        got = simulation.observed_spectrum(123.0, 5800.0, 2.5, -1.2, 0.3,
                                           **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope='module')
def fitters():
    rtm = rsim.build_template_model(3, 3, 3, 2, npix=512)
    arms_data, truth = rsim.make_exposure(3, npix_arm=100, seed=2)
    tm = convert.template_model(rtm, device='cpu')
    port = batch.BatchedFitter(
        [batch.BatchArm(n, *a) for n, a in arms_data.items()],
        {n: tm for n in arms_data}, CONFIG, options={'npoly': 5})
    ref = rbatch.BatchedFitter(
        [rbatch.BatchArm(n, *a) for n, a in arms_data.items()],
        {n: rtm for n in arms_data}, freeze(CONFIG), options={'npoly': 5})
    return port, ref, truth, tm.parnames


def test_scan_chisq_matches_reference(fitters):
    port, ref, truth, _ = fitters
    grids = truth['vel'][:, None] + np.arange(-200.0, 200.0, 4.0)[None]
    params = np.tile([6000.0, 3.0, -1.0, 0.5], (3, 1))
    want = ref.scan_chisq(grids, params, vchunk=64)
    got = port.scan_chisq(grids, params, vchunk=64)
    assert got.shape == want.shape == grids.shape
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize('frac,scale', [(None, None), ('0.03', '0.5')])
def test_nm_knobs_match_reference(fitters, monkeypatch, frac, scale):
    """RVST_NM_XATOL_FRAC sets the tolerance the reference's nm_xatol
    gives, RVST_NM_SIMPLEX_SCALE the first simplex's size (a restart's
    stays the mapper's scales)."""
    port, _, truth, parnames = fitters
    for k, v in (('RVST_NM_XATOL_FRAC', frac),
                 ('RVST_NM_SIMPLEX_SCALE', scale)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    pmap = vel_fit.ParamMapper(parnames, START, [], None, False)
    rmap = rvf.ParamMapper(parnames, START, [], None, False)
    seen = dict(scales=[], xatol=[])
    real_simplex, real_init = nm.build_simplex, nm.nm_init

    def build_simplex(x0, scales, seed):
        seen['scales'].append(np.asarray(scales))
        return real_simplex(x0, scales, seed)

    def nm_init(fun, simplex, fatol, xatol):
        seen['xatol'].append(xatol.numpy())
        return real_init(fun, simplex, fatol, xatol)
    monkeypatch.setattr(nm, 'build_simplex', build_simplex)
    monkeypatch.setattr(nm, 'nm_init', nm_init)
    port.run_neldermead(pmap, truth['vel'], maxiter=16, nm_chunk=16)
    np.testing.assert_allclose(
        seen['xatol'][0], rbatch.BatchedFitter.nm_xatol(None, rmap),
        rtol=1e-15)
    np.testing.assert_allclose(
        seen['scales'][0], pmap.scales() * float(scale or 1.0), rtol=1e-15)
    if len(seen['scales']) > 1:
        np.testing.assert_allclose(seen['scales'][1], pmap.scales())
