"""``fast_interp``, nearest-pixel template evaluation, in the port
(ops/spline.nearest_eval_index, fit/likelihood, FusedChisq, the fitter's
velocity scan) against the reference's (rvspecfit_tpu/ops/spline.py,
rvspecfit_tpu/fit/likelihood.py) on the same inputs, float64 on the
CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu.fit import likelihood as rlik
from rvspecfit_tpu.ops import spline as rspline
from rvspecfit_torch.fit import likelihood, vel_fit
from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
from rvspecfit_torch.ops import spline

from test_torch_single import (CONFIG, OPTIONS, _object, _templates,
                               _trials, models)  # noqa: F401

FAST = dict(OPTIONS, fast_interp=True)


@pytest.mark.parametrize('log_step', [True, False])
def test_nearest_eval_index_equals_the_references(log_step):
    """The same values and in-range flags, exactly: halves round to
    even, indices clip to the grid, queries outside it gather its end
    knots."""
    xs = np.exp(np.linspace(np.log(4500.0), np.log(5500.0), 40)) \
        if log_step else np.linspace(4500.0, 5500.0, 40)
    rgeom = rspline.SplineGeometry.from_knots(xs, log_step=log_step)
    geom = spline.SplineGeometry.from_knots(xs, log_step=log_step,
                                            device='cpu')
    rng = np.random.RandomState(1)
    values = rng.normal(size=(6, 40))
    u = rng.uniform(-3.0, 43.0, (6, 25))
    u[:, :6] = [-0.5, 0.5, 1.5, 2.5, 38.5, 39.0]
    got, inr = spline.nearest_eval_index(geom, torch.as_tensor(values),
                                         torch.as_tensor(u))
    want, winr = jax.vmap(lambda v, q: rspline.nearest_eval_index(
        rgeom, v, q))(jnp.asarray(values), jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(inr.numpy(), np.asarray(winr))
    x = rng.uniform(4400.0, 5600.0, 30)
    np.testing.assert_allclose(
        spline.fractional_index_device(geom, torch.as_tensor(x)).numpy(),
        np.asarray(rspline.fractional_index_device(rgeom, jnp.asarray(x))),
        rtol=0, atol=1e-10)


@pytest.mark.parametrize('use_vsini', [False, True])
def test_fused_chisq_fast_interp_matches_reference(models,  # noqa: F811
                                                  use_vsini):
    """FusedChisq(options={'fast_interp': True}): chi-squares at the
    same trials, a velocity scan and the models at one point against
    the reference's (rtol 1e-8, FusedChisq's tolerance in
    tests/test_torch_single.py); the nearest-pixel chi-squares differ
    from the spline's."""
    rtm, tm = models
    rsds, psds = _object()
    ref = rlik.FusedChisq(rsds, _templates(rtm), CONFIG, options=FAST,
                          use_vsini=use_vsini)
    got = likelihood.FusedChisq(psds, _templates(tm), CONFIG, options=FAST,
                                use_vsini=use_vsini)
    spl = likelihood.FusedChisq(psds, _templates(tm), CONFIG,
                                options=OPTIONS, use_vsini=use_vsini)
    assert got.fast_interp and not spl.fast_interp
    vels, params, vs = _trials()
    vs = vs if use_vsini else None
    want = np.asarray(ref.chisq_trials(
        jnp.asarray(vels), jnp.asarray(params),
        None if vs is None else jnp.asarray(vs)))
    fast = got.chisq_trials(vels, params, vs).numpy()
    np.testing.assert_allclose(fast, want, rtol=1e-8)
    assert not np.allclose(spl.chisq_trials(vels, params, vs).numpy(), fast,
                           rtol=1e-6)
    vsini = 12.0 if use_vsini else None
    p0 = np.array([6300.0, 2.7, -0.9, 0.3])
    wout = ref.full_output(115.0, p0, vsini)
    out = got.full_output(115.0, p0, vsini)
    np.testing.assert_allclose(out['chisq'], wout['chisq'], rtol=1e-8)
    for g, w in zip(out['models'], wout['models']):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max())
    grid = np.linspace(50.0, 180.0, 27)
    scan = got.scan(grid, p0[None], None if vsini is None else [vsini])
    want_scan = np.asarray(ref.chisq_trials(
        jnp.asarray(grid), jnp.asarray(np.tile(p0, (27, 1))),
        None if vsini is None else jnp.full(27, vsini)))
    np.testing.assert_allclose(scan.numpy()[0], want_scan, rtol=1e-8)


def test_process_and_the_fitter_scan_take_fast_interp(models):  # noqa: F811
    """vel_fit.process with options fast_interp runs (nearest-pixel in
    every stage) and recovers the velocity; the fitter's velocity scan
    with ``fast_interp`` equals FusedChisq's nearest-pixel chi-squares
    at the same points."""
    _, tm = models
    _, psds = _object()
    res = vel_fit.process(psds, dict(teff=6000.0, logg=3.0, feh=-1.0,
                                     alpha=0.5), config=dict(CONFIG),
                          options=FAST, templates=_templates(tm),
                          device='cpu')
    assert abs(res['vel'] - 120.0) < max(10.0, 5 * res['vel_err'])
    arms = [BatchArm(sd.name, sd.lam, sd.spec[None], 1 / sd.espec[None]**2)
            for sd in psds]
    bf = BatchedFitter(arms, _templates(tm), CONFIG, options=OPTIONS)
    p0 = np.array([[6300.0, 2.7, -0.9, 0.3]])
    grid = np.linspace(50.0, 180.0, 27)
    vels = torch.as_tensor(grid)[None]
    chi = bf._scan(bf.arms, vels, torch.as_tensor(p0),
                   torch.zeros(1, dtype=torch.float64), fast_interp=True)
    fused = likelihood.FusedChisq(psds, _templates(tm), CONFIG,
                                  options=FAST)
    np.testing.assert_allclose(chi.numpy()[0],
                               fused.scan(grid, p0).numpy()[0], rtol=1e-10)
    st = bf.scan_velocities(grid, p0, fast_interp=True)
    assert abs(st['best_vel'][0] - 120.0) < 10.0
