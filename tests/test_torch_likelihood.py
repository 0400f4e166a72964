"""Parity of the port's chi-square, grid interpolation, broadening,
resolution and fused likelihood with the JAX reference (float64, CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.fit import likelihood as rlik
from rvspecfit_tpu.fit.batch import BatchArm as RBatchArm
from rvspecfit_tpu.fit.batch import BatchedFitter as RBatchedFitter
from rvspecfit_tpu.fit.spec_data import ArmState as RArmState
from rvspecfit_tpu.fit.spec_data import SpecData as RSpecData
from rvspecfit_tpu.interp import grid as rgrid
from rvspecfit_tpu.ops import basis as rbasis
from rvspecfit_tpu.ops import chisq as rchisq
from rvspecfit_tpu.ops import resolution as rres
from rvspecfit_tpu.ops import vsini as rvsini
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert
from rvspecfit_torch.fit import likelihood
from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
from rvspecfit_torch.fit.spec_data import ArmState, SpecData
from rvspecfit_torch.interp import grid
from rvspecfit_torch.ops import basis, chisq, resolution, vsini

CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=300,
              min_vsini=1e-2, min_vel_step=0.2)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@pytest.fixture(scope='module')
def ref_tm():
    return rsim.build_template_model(3, 3, 3, 2, npix=512)


@pytest.fixture(scope='module')
def ref_arms(ref_tm):
    """Two single-object arms, the second with a resolution matrix."""
    out = []
    for k, (l0, l1) in enumerate([(4600.0, 5000.0), (5000.0, 5400.0)]):
        lam, spec, espec = rsim.observed_spectrum(
            120.0, 6500.0, 2.5, -0.8, 0.4, npix=200, lam0=l0, lam1=l1,
            snr=80.0, seed=k)
        res = rres.gaussian_resolution_matrix(lam, resol=3000.0) if k \
            else None
        sd = RSpecData(f'arm{k}', lam, spec, espec, resolution=res)
        out.append(RArmState.build(sd, npoly=6, geom=ref_tm.geom))
    return out


def test_chisq_batch_matches_reference():
    rng = np.random.RandomState(0)
    lam = np.linspace(4600.0, 5400.0, 300)
    polys = rbasis.continuum_basis(lam, 8)
    np.testing.assert_array_equal(basis.continuum_basis(lam, 8), polys)
    np.testing.assert_array_equal(basis.continuum_basis(lam, 5, rbf=False),
                                  rbasis.continuum_basis(lam, 5, rbf=False))
    dvec = 30.0 + rng.randn(300)
    tove = (1.0 + 0.1 * rng.randn(6, 300)) * 1e5 ** rng.uniform(0, 1, 6)[
        :, None]
    ref_chi, ref_coef = rchisq.chisq_continuum_marg_batch(
        jnp.asarray(dvec), jnp.asarray(tove), jnp.asarray(polys),
        rchisq.basis_products(jnp.asarray(polys)), 12.5, with_coeffs=True)
    pt = _t(polys)
    chi, coef = chisq.chisq_continuum_marg_batch(
        _t(dvec), _t(tove), pt, chisq.basis_products(pt), 12.5,
        with_coeffs=True)
    np.testing.assert_allclose(chi, ref_chi, rtol=1e-9)
    np.testing.assert_allclose(coef, ref_coef, rtol=1e-9)


def test_chol_solve_ridge_retry_and_failure():
    """A singular PSD matrix is rescued by the ridge retry exactly as in
    the reference; an indefinite one gives NaN."""
    v = np.array([1.0, 2.0, 0.5])
    a = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 2.0]])
    m = np.stack([a, -np.eye(3), np.diag([2.0, 3.0, 4.0])])
    ref_a, ref_ld = rchisq.chol_solve_logdet(jnp.asarray(m),
                                             jnp.asarray(np.tile(v, (3, 1))))
    got_a, got_ld = chisq.chol_solve_logdet(_t(m), _t(np.tile(v, (3, 1))))
    assert torch.isfinite(got_ld[[0, 2]]).all() and torch.isnan(got_ld[1])
    np.testing.assert_allclose(got_ld[[0, 2]], np.asarray(ref_ld)[[0, 2]],
                               rtol=1e-8)
    np.testing.assert_allclose(got_a[[0, 2]], np.asarray(ref_a)[[0, 2]],
                               rtol=1e-6)
    assert np.isnan(np.asarray(ref_ld)[1])


def test_interp_batch_matches_reference(ref_tm):
    """Inside points, points outside the grid (nearest-template
    fallback and distance) and non-finite parameters."""
    state = convert.grid_state(ref_tm.state, device='cpu')
    rng = np.random.RandomState(1)
    lo = np.array([np.log10(4000.0), 0.5, -2.0, 0.0])
    hi = np.array([np.log10(10000.0), 5.0, 0.0, 1.0])
    p = lo + (hi - lo) * rng.uniform(-0.3, 1.3, (40, 4))
    p[3] = np.nan
    p[4] = hi                        # on the top corner
    ref_spec, ref_out = rgrid.interp_batch(ref_tm.state, jnp.asarray(p))
    spec, out = grid.interp_batch(state, _t(p))
    assert (np.asarray(ref_out) > 0).sum() > 10
    np.testing.assert_allclose(out, ref_out, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(spec, ref_spec, rtol=1e-10)
    # the port's own constructor gives the same state as the conversion
    lam, uvecs, idgrid, vecs, specs, _ = rsim.make_template_grid(
        3, 3, 3, 2, npix=512)
    own = grid.GridInterpState.build(uvecs, idgrid, vecs, specs,
                                      device='cpu')
    for name in ('vecs_scaled', 'ptp_inv', 'dats', 'idgrid'):
        np.testing.assert_allclose(getattr(own, name), getattr(state, name),
                                   rtol=1e-15)


@pytest.mark.parametrize('vs', [0.0, 0.3, 7.0, 150.0])
def test_rotation_broadening_matches_reference(vs):
    log_step = 1e-4
    hw = vsini.kernel_half_width(200.0, log_step)
    assert hw == rvsini.kernel_half_width(200.0, log_step)
    ref_k = rvsini.rotation_kernel(jnp.asarray(vs), log_step, hw)
    k = vsini.rotation_kernel(_t([vs]), log_step, hw)
    np.testing.assert_allclose(k[0], ref_k, rtol=1e-10, atol=1e-14)
    spec = 1.0 + np.random.RandomState(2).rand(120)
    ref = rvsini.convolve_kernel_same(jnp.asarray(spec), ref_k)
    got = vsini.convolve_kernel_same(_t(spec)[None], k)
    np.testing.assert_allclose(got[0], ref, rtol=1e-10)


def test_banded_matvec_matches_reference():
    lam = np.linspace(5000.0, 5100.0, 90)
    ref = rres.gaussian_resolution_matrix(lam, resol=2000.0)
    x = np.random.RandomState(3).randn(90)
    got = resolution.BandedMatrix(ref.offsets, _t(ref.bands)).matvec(_t(x))
    np.testing.assert_allclose(got, ref.matvec(jnp.asarray(x)), rtol=1e-12)


def test_arm_state_build_matches_conversion(ref_tm, ref_arms):
    tm = convert.template_model(ref_tm, device='cpu')
    ra = ref_arms[1]
    espec = 1.0 / np.asarray(ra.espec_inv)
    band = resolution.BandedMatrix(ra.band.offsets, np.asarray(ra.band.bands))
    sd = SpecData(ra.name, np.asarray(ra.lam), np.asarray(ra.dvec) * espec,
                  espec, resolution=band)
    own = ArmState.build(sd, tm.geom, npoly=6, device='cpu')
    conv = convert.arm_state(ra, device='cpu')
    for name in ('lam', 'dvec', 'espec_inv', 'polys', 'polys_prod',
                 'log_espec_sum', 'idx0'):
        np.testing.assert_allclose(getattr(own, name), getattr(conv, name),
                                   rtol=1e-12)
    np.testing.assert_allclose(own.band.bands, conv.band.bands, rtol=1e-15)


def _trials():
    """(vels, params, vsinis) including out-of-grid and non-finite
    trial points."""
    rng = np.random.RandomState(4)
    n = 12
    params = np.column_stack([rng.uniform(4500, 9500, n),
                              rng.uniform(0.8, 4.8, n),
                              rng.uniform(-1.9, -0.1, n),
                              rng.uniform(0.05, 0.95, n)])
    params[2, 0] = 15000.0           # outside the grid: penalty
    params[3, 1] = -1.0
    params[4, 2] = np.nan            # non-finite parameter
    vels = rng.uniform(-400, 400, n)
    vels[5] = np.nan                 # non-finite chi-square: salvage
    params[5, 0] = 12000.0
    vels[6] = np.nan                 # ... and inside the grid: +inf
    vsinis = rng.uniform(0.0, 80.0, n)
    return vels, params, vsinis


@pytest.mark.parametrize('use_vsini', [False, True])
def test_chisq_trials_core_matches_reference(ref_tm, ref_arms, use_vsini):
    vels, params, vsinis = _trials()
    badchi = float(10 * sum(a.npix for a in ref_arms))
    hw = {'arm0': rvsini.kernel_half_width(300.0, ref_tm.log_step)} \
        if use_vsini else {}
    ref = np.asarray(rlik.chisq_trials_core(
        ref_arms, {'arm0': ref_tm, 'arm1': ref_tm}, jnp.asarray(vels),
        jnp.asarray(params), jnp.asarray(vsinis), badchi=badchi,
        use_vsini=use_vsini, half_widths={**hw, 'arm1': hw.get('arm0')},
        outside_penalty=True, solve_dtype=None))
    tm = convert.template_model(ref_tm, device='cpu')
    got = likelihood.chisq_trials_core(
        [convert.arm_state(a, device='cpu') for a in ref_arms],
        {'arm0': tm, 'arm1': tm},
        _t(vels)[None], _t(params)[None], _t(vsinis)[None], badchi=badchi,
        use_vsini=use_vsini, half_widths={**hw, 'arm1': hw.get('arm0')})
    assert np.isinf(ref[6]) and np.isfinite(ref[5])
    np.testing.assert_allclose(got[0], ref, rtol=1e-8)


def test_scan_core_matches_reference(ref_tm, ref_arms):
    vels = np.linspace(-600.0, 600.0, 25)
    badchi = float(10 * sum(a.npix for a in ref_arms))
    tm = convert.template_model(ref_tm, device='cpu')
    for par in ([6500.0, 2.5, -0.8, 0.4], [14000.0, 2.5, -0.8, 0.4]):
        ref = np.asarray(rlik.scan_core(
            ref_arms, {'arm0': ref_tm, 'arm1': ref_tm}, jnp.asarray(vels),
            jnp.asarray(par), jnp.asarray(0.0), badchi=badchi,
            use_vsini=False, half_widths={}, outside_penalty=True,
            solve_dtype=None))
        got = likelihood.scan_core(
            [convert.arm_state(a, device='cpu') for a in ref_arms],
            {'arm0': tm, 'arm1': tm}, _t(vels)[None], _t(par)[None],
            _t([0.0]), badchi=badchi, use_vsini=False, half_widths={})
        np.testing.assert_allclose(got[0], ref, rtol=1e-8)


def test_batched_fitter_matches_reference(ref_tm):
    """Per-fiber stacked arm data (masked and non-finite pixels,
    per-fiber resolution bands) through the fitter's chi-square and
    velocity scan."""
    arms_data, truth = rsim.make_exposure(3, npix_arm=150, seed=5)
    lam, flux, ivar = arms_data['B']
    flux, ivar = flux.copy(), ivar.copy()
    badmask = np.zeros(flux.shape, bool)
    badmask[:, 10:14] = True
    flux[0, 40] = np.nan
    ivar[1, 50] = 0.0
    # row-indexed (B, noff, npix) bands, normalized per output pixel
    res = np.random.RandomState(6).uniform(0.1, 1.0, (3, 5, len(lam)))
    res /= res.sum(axis=1, keepdims=True)
    cfg = dict(CONFIG, second_minimizer=False, template_lib='')
    rbf = RBatchedFitter([RBatchArm('B', lam, flux, ivar, badmask, res)],
                         {'B': ref_tm}, freeze(cfg), options={'npoly': 7})
    bf = BatchedFitter([BatchArm('B', lam, flux, ivar, badmask, res)],
                       {'B': convert.template_model(ref_tm, device='cpu')},
                       cfg,
                       options={'npoly': 7})
    vels = np.tile(np.linspace(-300.0, 300.0, 5), (3, 1))
    params = np.tile([7000.0, 3.0, -1.0, 0.5], (3, 5, 1))
    ref = np.asarray(rbf.chisq(jnp.asarray(vels), jnp.asarray(params)))
    np.testing.assert_allclose(bf.chisq(vels, params), ref, rtol=1e-8)
    start = np.column_stack([truth[k] for k in ('teff', 'logg', 'feh',
                                                'alpha')])
    grid_v = np.linspace(-600.0, 600.0, 31)
    want = rbf.scan_velocities(grid_v, start)
    got = bf.scan_velocities(grid_v, start)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-8,
                                   atol=1e-8)
