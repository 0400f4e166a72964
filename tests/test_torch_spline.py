"""Parity of the port's spline geometry, coefficient solve and Doppler
evaluation (kernel A's plain version) with the JAX reference, in
float64 on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu.ops import pallas_spline as ps
from rvspecfit_tpu.ops import spline as rspline
from rvspecfit_torch.ops import spline, spline_eval

RTOL = 1e-10


def _knots(log_step, n):
    if log_step:
        return np.exp(np.linspace(np.log(4500.0), np.log(5500.0), n))
    return np.linspace(4500.0, 5500.0, n)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL):
    """rtol comparison; the atol (rtol x the array's scale) only covers
    entries that cancel to ~0."""
    got = np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# banded-inverse solve (m2 >= 120) and the Thomas fallback, log and linear
GRIDS = [(True, 400), (False, 300), (True, 60), (False, 40)]


@pytest.mark.parametrize('log_step,n', GRIDS)
def test_geometry_matches_reference(log_step, n):
    xs = _knots(log_step, n)
    ref = rspline.SplineGeometry.from_knots(xs, log_step=log_step)
    got = spline.SplineGeometry.from_knots(xs, log_step=log_step, device='cpu')
    assert (got.x0, got.x_last, got.n, got.log_step) == \
        (ref.x0, ref.x_last, ref.n, ref.log_step)
    assert got.step == pytest.approx(ref.step, rel=RTOL)
    assert (got.inv_kernel is None) == (ref.inv_kernel is None) \
        == (n < 122)
    for name in spline.ARRAY_FIELDS:
        if getattr(ref, name) is not None:
            _close(getattr(got, name), getattr(ref, name))


@pytest.mark.parametrize('log_step,n', GRIDS)
def test_spline_coeffs_match_reference(log_step, n):
    xs = _knots(log_step, n)
    ys = 1.0 + np.random.RandomState(n).randn(3, 2, n).cumsum(-1) / 30.0
    ref = rspline.spline_coeffs(
        rspline.SplineGeometry.from_knots(xs, log_step=log_step),
        jnp.asarray(ys))
    got = spline.spline_coeffs(
        spline.SplineGeometry.from_knots(xs, log_step=log_step, device='cpu'),
        _t(ys))
    assert got.shape == (3, 2, 4, n - 1)
    _close(got, ref)


def _eval_setup(log_step, rows=3, npix_t=500, npix_d=300, seed=0):
    """Spline coefficients of random rows + Doppler-shifted queries."""
    rng = np.random.RandomState(seed)
    xs = _knots(log_step, npix_t)
    rgeom = rspline.SplineGeometry.from_knots(xs, log_step=log_step)
    ys = 1.0 + 0.1 * rng.randn(rows, npix_t).cumsum(axis=1) / 30.0
    coeffs = np.asarray(rspline.spline_coeffs(rgeom, jnp.asarray(ys)))
    lam_d = np.linspace(4600.0, 5400.0, npix_d)
    idx0 = rspline.fractional_index(rgeom, lam_d)
    shifts = rng.uniform(-300, 300, rows)
    if log_step:
        u = idx0[None, :] + (shifts / 3e5 / rgeom.step)[:, None]
    else:
        u = idx0[None, :] + (shifts / 3e5)[:, None] \
            * (lam_d / rgeom.step)[None, :]
    return rgeom, spline.SplineGeometry.from_knots(
        xs, log_step, device='cpu'), \
        coeffs, u, idx0


@pytest.mark.parametrize('log_step', [True, False])
def test_plain_eval_matches_reference_gather(log_step):
    rgeom, geom, coeffs, u, _ = _eval_setup(log_step)
    # out-of-range queries take the clamped end interval's cubic
    u[0, :3] = [-2.5, -0.3, geom.n + 4.2]
    ref = jax.vmap(lambda c, uu: rspline.spline_eval_index(rgeom, c, uu)[0])(
        jnp.asarray(coeffs), jnp.asarray(u))
    _close(spline_eval.spline_eval_index_plain(geom, _t(coeffs), _t(u)),
           ref)


@pytest.mark.parametrize('log_step', [True, False])
def test_plain_eval_matches_pallas_per_row(log_step):
    rgeom, geom, coeffs, u, idx0 = _eval_setup(log_step, seed=3)
    ref, _ = ps.spline_eval_index_pallas(
        rgeom, jnp.asarray(coeffs), jnp.asarray(u), ps.window_size(idx0),
        interpret=True)
    _close(spline_eval.spline_eval_index_plain(geom, _t(coeffs), _t(u)),
           ref)


def test_plain_eval_matches_pallas_shared():
    """One fiber's coefficient row shared by V velocity rows."""
    rgeom, geom, coeffs, _, idx0 = _eval_setup(True, rows=1, seed=5)
    vels = np.linspace(-500.0, 500.0, 11)
    u = idx0[None, :] + (vels / 3e5 / rgeom.step)[:, None]
    ref, _ = ps.spline_eval_index_pallas_shared(
        rgeom, jnp.asarray(coeffs[0]), jnp.asarray(u),
        ps.window_size(idx0), interpret=True)
    got = spline_eval.spline_eval_index_plain(geom, _t(coeffs), _t(u),
                                              rows_per_coeff=len(vels))
    _close(got, ref)


def test_plain_eval_nan_query_gives_nan():
    _, geom, coeffs, u, _ = _eval_setup(True, rows=1)
    u[0, 5] = np.nan
    got = spline_eval.spline_eval_index_plain(geom, _t(coeffs), _t(u))
    assert torch.isnan(got[0, 5]) and torch.isfinite(got[0, 6:]).all()


@pytest.mark.parametrize('log_step', [True, False])
def test_doppler_index_shift_matches_reference(log_step):
    xs = _knots(log_step, 200)
    vels = np.linspace(-900.0, 900.0, 7)
    ref = rspline.doppler_index_shift(
        rspline.SplineGeometry.from_knots(xs, log_step=log_step),
        jnp.asarray(vels), lam_over_step=1.0)
    got = spline.doppler_index_shift(
        spline.SplineGeometry.from_knots(xs, log_step, device='cpu'),
        _t(vels))
    _close(got, ref)
