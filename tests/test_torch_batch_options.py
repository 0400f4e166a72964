"""Options of the port's BatchedFitter (rvspecfit_torch/fit/batch.py):
fiber microbatching (``microbatch``, the DESI driver's
``config['fit_microbatch']``, the pull harness's ``microbatch``) and the
polish's environment knobs RVST_POLISH_STEPS and RVST_POLISH_FREEZE_H.

A tiled fit is the whole one, fiber by fiber (every stage is
elementwise over fibers): held per fiber through NM and the whole
tail.  Against the reference's own ``BatchedFitter(microbatch=)`` and
polish the reference's programs compile for minutes on the CPU, so
those tests are marked slow, as tests/test_torch_tail.py's are."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.fit import batch as rbatch
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert, validation
from rvspecfit_torch.fit import batch, vel_fit
from rvspecfit_torch.pipeline import library
from rvspecfit_torch.survey import desi

from test_torch_tail import CONFIG, START, _desi_group, small  # noqa: F401

NFIB = 5
MB = 2
# a tile is the whole fit's fibers, so the CPU's float64 arithmetic is
# the same up to the summation order of batched products: 1e-9 relative
RTOL = 1e-9


@pytest.fixture(scope='module')
def fitters():
    """5 fibers x 3 arms x 100 px on a 3x3x3x2 grid: the port's fitter
    whole and in tiles of 2, the mapper and NM starts near the truth."""
    rtm = rsim.build_template_model(3, 3, 3, 2, npix=512)
    arms_data, truth = rsim.make_exposure(NFIB, npix_arm=100, seed=5)
    tm = convert.template_model(rtm, device='cpu')
    arms = [batch.BatchArm(n, *a) for n, a in arms_data.items()]
    make = lambda mb: batch.BatchedFitter(  # noqa: E731
        arms, {n: tm for n in arms_data}, CONFIG, options={'npoly': 5},
        microbatch=mb)
    pmap = vel_fit.ParamMapper(tm.parnames, START, [], None, False)
    x0 = np.tile(pmap.start_vector(0.0), (NFIB, 1))
    x0[:, 0] = truth['vel'] + 3.0
    return dict(whole=make(None), tiled=make(MB), pmap=pmap, x0=x0,
                parnames=tm.parnames, arms_data=arms_data, rtm=rtm)


def _fit(bf, pmap, x0, parnames):
    nmres = bf.run_neldermead(pmap, x0=x0)
    tail = bf.run_tail(pmap, nmres['x'], fun=nmres['fun'],
                       parnames=parnames, polish=True)
    return nmres, tail


def test_tiles_cover_every_fiber_once(fitters):
    bf = fitters['tiled']
    tiles = bf._tiles(torch.arange(NFIB))
    assert [t.tolist() for t in tiles] == [[0, 1], [2, 3], [4]]
    assert [t.tolist() for t in fitters['whole']._tiles(
        torch.arange(NFIB))] == [list(range(NFIB))]
    with pytest.raises(ValueError, match='microbatch'):
        batch.BatchedFitter(bf.batch_arms, bf.templates, CONFIG,
                            microbatch=0)


def test_microbatched_fit_equals_the_whole_fit_per_fiber(fitters):
    """NM, polish, refinement, Hessian errors and models, tiles of 2
    against the whole batch, fiber by fiber (rtol 1e-9)."""
    nm_w, tail_w = _fit(fitters['whole'], fitters['pmap'], fitters['x0'],
                        fitters['parnames'])
    nm_t, tail_t = _fit(fitters['tiled'], fitters['pmap'], fitters['x0'],
                        fitters['parnames'])
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())
    close(nm_t['x'], nm_w['x'])
    close(nm_t['fun'], nm_w['fun'])
    np.testing.assert_array_equal(nm_t['converged'], nm_w['converged'])
    assert nm_t['obj_evals'] > NFIB * (nm_t['x'].shape[1] + 1)
    for k in ('x', 'fun', 'params', 'errs', 'covars'):
        close(tail_t[k], tail_w[k])
    np.testing.assert_array_equal(tail_t['bad_hess'], tail_w['bad_hess'])
    for k in ('best_vel', 'vel_err', 'best_chi', 'skewness', 'kurtosis'):
        close(tail_t['ref'][k], tail_w['ref'][k])
    for k in ('models', 'raw_models', 'cont_models', 'chisq', 'cont_chisq',
              'npix'):
        for name in tail_w['mods'][k]:
            close(tail_t['mods'][k][name], tail_w['mods'][k][name])
    # chisq and the velocity scan go through the tiles too
    vels = np.tile(np.linspace(-50, 50, 3), (NFIB, 1))
    pars = np.repeat(tail_w['params'][:, None], 3, axis=1)
    close(fitters['tiled'].chisq(vels, pars).numpy(),
          fitters['whole'].chisq(vels, pars).numpy())
    grid = np.arange(-400.0, 400.0, 20.0)
    for k, v in fitters['whole'].scan_velocities(
            grid, tail_w['params']).items():
        close(fitters['tiled'].scan_velocities(grid, tail_w['params'])[k],
              v)


def test_fit_microbatch_is_honoured_by_the_driver(desi_library,
                                                  monkeypatch):
    """``config['fit_microbatch']`` reaches BatchedFitter's
    ``microbatch`` (unset: None, the whole group), and the group fit in
    tiles of 2 equals the whole one per fiber (rtol 1e-9)."""
    seen = []
    real = desi.BatchedFitter

    def spy(*args, **kw):
        seen.append(kw.get('microbatch'))
        return real(*args, **kw)
    monkeypatch.setattr(desi, 'BatchedFitter', spy)
    data, truth = _desi_group()
    out = {}
    for mb in (None, 2):
        cfg = dict(CONFIG, second_minimizer=True, template_lib=desi_library)
        if mb is not None:
            cfg['fit_microbatch'] = mb
        templates = {s: library.load_template_model(s, cfg, device='cpu')
                     for s in data}
        arms = [batch.BatchArm(s, *d, setup=s) for s, d in data.items()]
        out[mb] = desi._run_group_fit(arms, templates, cfg, {'npoly': 5})
    assert seen == [None, 2]
    for k in ('params', 'errs', 'vsini'):
        np.testing.assert_allclose(out[2][k], out[None][k], rtol=RTOL)
    np.testing.assert_allclose(out[2]['ref']['best_vel'],
                               out[None]['ref']['best_vel'], rtol=RTOL)
    dv = out[2]['ref']['best_vel'] - truth['vel']
    assert (np.abs(dv) < np.maximum(10.0, 5 * out[2]['ref']['vel_err'])).all()


def test_pull_harness_microbatch(monkeypatch):
    """run_accuracy(microbatch=) fits in tiles and gives the whole run's
    statistics (rtol 1e-9); ``--microbatch`` reaches it."""
    kw = dict(ntrials=5, npix=120, seed=3, device='cpu',
              templates={'acc': convert.template_model(
                  rsim.build_template_model(3, 3, 3, 2, npix=512),
                  device='cpu')})
    whole, _ = validation.run_accuracy(**kw)
    tiled, _ = validation.run_accuracy(microbatch=2, **kw)
    for k, v in whole.items():
        np.testing.assert_allclose(tiled[k], v, rtol=RTOL, err_msg=k)
    got = {}
    monkeypatch.setattr(validation, 'run_accuracy',
                        lambda **k: got.update(k) or ({}, None))
    validation.main(['--cpu', '--ntrials', '3', '--microbatch', '2'])
    assert got['microbatch'] == 2


# ------------------------------------------------------------------
# the polish's knobs

def _reference_f(small, x):  # noqa: F811
    vel, params, _ = small['pmap'].unpack_host(x)
    return np.asarray(small['rbf'].chisq(jnp.asarray(vel[:, None]),
                                         jnp.asarray(params[:, None])))[:, 0]


def test_polish_steps_knob(small, monkeypatch):  # noqa: F811
    """RVST_POLISH_STEPS sets the default number of Newton steps; the
    polished values are the reference's chi-square at the polished
    points, and no fiber gets worse."""
    pbf, pmap, nm = small['pbf'], small['pmap'], small['nm']
    one = pbf.run_polish(pmap, nm['x'], fun0=nm['fun'], steps=1)
    monkeypatch.setenv('RVST_POLISH_STEPS', '1')
    env = pbf.run_polish(pmap, nm['x'], fun0=nm['fun'])
    np.testing.assert_array_equal(env['x'], one['x'])
    np.testing.assert_array_equal(env['fun'], one['fun'])
    monkeypatch.setenv('RVST_POLISH_STEPS', '3')
    three = pbf.run_polish(pmap, nm['x'], fun0=nm['fun'])
    np.testing.assert_array_equal(
        three['x'], pbf.run_polish(pmap, nm['x'], fun0=nm['fun'],
                                   steps=3)['x'])
    assert (three['fun'] <= one['fun']).all()
    np.testing.assert_allclose(three['fun'], _reference_f(small,
                                                          three['x']),
                               rtol=1e-10)


def test_polish_freeze_h_knob(small, monkeypatch):  # noqa: F811
    """RVST_POLISH_FREEZE_H=1: one AD Hessian per tile serves every
    step (two steps: one Hessian, one extra gradient); its first step is
    the unfrozen one; it moves only downhill on the reference's
    chi-square."""
    pbf, pmap, nm = small['pbf'], small['pmap'], small['nm']
    calls = dict(hessian=0, gradient=0)
    real_gh, real_g = batch.grad_hessian, batch._gradient

    def gh(*a):
        calls['hessian'] += 1
        return real_gh(*a)

    def g(*a):
        calls['gradient'] += 1
        return real_g(*a)
    monkeypatch.setattr(batch, 'grad_hessian', gh)
    monkeypatch.setattr(batch, '_gradient', g)
    free = pbf.run_polish(pmap, nm['x'], fun0=nm['fun'], steps=2)
    assert calls == dict(hessian=2, gradient=0)
    monkeypatch.setenv('RVST_POLISH_FREEZE_H', '1')
    calls.update(hessian=0, gradient=0)
    frozen = pbf.run_polish(pmap, nm['x'], fun0=nm['fun'], steps=2)
    assert calls == dict(hessian=1, gradient=1)
    first = pbf.run_polish(pmap, nm['x'], fun0=nm['fun'], steps=1)
    monkeypatch.delenv('RVST_POLISH_FREEZE_H')
    np.testing.assert_array_equal(
        first['x'], pbf.run_polish(pmap, nm['x'], fun0=nm['fun'],
                                   steps=1)['x'])
    assert (frozen['fun'] <= nm['fun']).all()
    assert (free['fun'] <= nm['fun']).all()
    np.testing.assert_allclose(frozen['fun'],
                               _reference_f(small, frozen['x']), rtol=1e-10)


@pytest.mark.slow
@pytest.mark.parametrize('env', [dict(RVST_POLISH_STEPS='1'),
                                 dict(RVST_POLISH_FREEZE_H='1')])
def test_polish_knobs_match_reference(small, monkeypatch, env):  # noqa: F811
    """The port's polish against the reference's run_polish under the
    same knob, both reading it from the environment: same moved flags,
    x and fun within rtol 1e-7 (test_torch_tail's tolerances)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    nm = small['nm']
    rp = small['rbf'].run_polish(small['rmap'], nm['x'], fun0=nm['fun'])
    pp = small['pbf'].run_polish(small['pmap'], nm['x'], fun0=nm['fun'])
    np.testing.assert_array_equal(pp['moved'], rp['moved'])
    np.testing.assert_allclose(pp['x'], rp['x'], rtol=1e-7)
    np.testing.assert_allclose(pp['fun'], rp['fun'], rtol=1e-7)


@pytest.mark.slow
def test_microbatch_matches_reference_batched_fitter(fitters):
    """BatchedFitter(microbatch=2) of both packages from the same
    starts: NM end points, the polish, the refinement, the Hessian
    errors and the models (test_torch_tail's tolerances: rtol 1e-7 on
    the polish and errors, 1e-6 km/s on the velocities)."""
    f = fitters
    rbf = rbatch.BatchedFitter(
        [rbatch.BatchArm(n, *a) for n, a in f['arms_data'].items()],
        {n: f['rtm'] for n in f['arms_data']},
        freeze(dict(CONFIG, second_minimizer=True, template_lib='')),
        options={'npoly': 5}, microbatch=MB)
    from rvspecfit_tpu.fit import vel_fit as rvf
    rmap = rvf.ParamMapper(f['rtm'].parnames, START, [], None, False)
    rnm = rbf.run_neldermead(rmap, None, x0=f['x0'])
    pnm = f['tiled'].run_neldermead(f['pmap'], x0=f['x0'])
    np.testing.assert_array_equal(pnm['converged'], rnm['converged'])
    np.testing.assert_allclose(pnm['x'], rnm['x'], rtol=1e-7)
    rp = rbf.run_polish(rmap, rnm['x'], fun0=rnm['fun'])
    pt = f['tiled'].run_tail(f['pmap'], rnm['x'], fun=rnm['fun'],
                             parnames=f['parnames'])
    np.testing.assert_allclose(pt['x'], rp['x'], rtol=1e-7)
    vel, params, _ = rmap.unpack_host(rp['x'])
    ref = rbf.refine_velocities(vel, params)
    np.testing.assert_allclose(pt['ref']['best_vel'], ref['best_vel'],
                               rtol=0, atol=1e-6)
    re, _, rb = rbf.hessian_errors(ref['best_vel'], params,
                                   parnames=f['parnames'])
    np.testing.assert_array_equal(pt['bad_hess'], rb)
    np.testing.assert_allclose(pt['errs'], re, rtol=1e-6)
    rm = rbf.best_models(ref['best_vel'], params)
    for name, m in rm['models'].items():
        np.testing.assert_allclose(pt['mods']['models'][name], m,
                                   rtol=1e-6, atol=1e-6 * np.abs(m).max())
