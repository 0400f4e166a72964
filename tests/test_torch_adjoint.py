"""Parity of kernel A's adjoint (its plain version, the CPU path and the
CUDA kernel's oracle) with the JAX reference: the VJP with respect to
the coefficients of rvspecfit_tpu.ops.spline.spline_eval_index,
vmapped over rows, in float64 on the CPU.

NaN queries are left out: the reference's ``jnp.take`` (fill mode) drops
a NaN query's index from its VJP, where the port puts NaN into interval
0, as the port's forward does (covered by
tests/test_torch_tail.py::test_autograd_pair_with_plain_versions)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu.ops import spline as rspline
from rvspecfit_torch.ops import spline, spline_eval

# float64 sums of each interval's queries in another order than XLA's
TOL = 1e-12


def _rows(kind, log_step, seed):
    """(knots, u, g) of a few rows of one kind."""
    rng = np.random.RandomState(seed)
    nm1, npix, rows = (49, 5000, 2) if kind == 'long' else (199, 300, 4)
    n = nm1 + 1
    xs = np.exp(np.linspace(np.log(4550.0), np.log(5450.0), n)) \
        if log_step else np.linspace(4550.0, 5450.0, n)
    geom = spline.SplineGeometry.from_knots(xs, log_step, device='cpu')
    lam = np.linspace(4600.0, 5400.0, npix)
    shift = spline.doppler_index_shift(
        geom, torch.as_tensor(rng.uniform(-1000.0, 1000.0, rows))).numpy()
    u = spline.fractional_index(geom, lam)[None] \
        + shift[:, None] * (1.0 if log_step else (lam / geom.step)[None])
    if kind == 'reversed':
        u = u[:, ::-1]
    elif kind == 'out_of_range':
        # below 0, inside, and past the last knot, in increasing order
        u = np.sort(rng.uniform(-8.0, n + 8.0, (rows, npix)), 1)
    elif kind == 'shuffled':
        u = rng.permutation(u.T).T
    return xs, np.ascontiguousarray(u), rng.normal(size=u.shape)


@pytest.mark.parametrize('log_step', [True, False])
@pytest.mark.parametrize('kind', ['monotone', 'reversed', 'out_of_range',
                                  'long', 'shuffled'])
def test_adjoint_matches_reference_vjp(kind, log_step):
    xs, u, g = _rows(kind, log_step, seed=len(kind) + log_step)
    nm1 = len(xs) - 1
    rgeom = rspline.SplineGeometry.from_knots(xs, log_step=log_step)

    def evaluate(coeffs):
        return jax.vmap(lambda c, uu: rspline.spline_eval_index(
            rgeom, c, uu)[0])(coeffs, jnp.asarray(u))
    # the evaluation is linear in the coefficients: any point serves
    _, vjp = jax.vjp(evaluate, jnp.zeros((u.shape[0], 4, nm1)))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    geom = spline.SplineGeometry.from_knots(xs, log_step, device='cpu')
    got = spline_eval.spline_eval_index_vjp_plain(
        geom, torch.as_tensor(u), torch.as_tensor(g), nm1)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    # the port's entry point takes the plain version on CPU tensors
    torch.testing.assert_close(spline_eval.spline_eval_index_vjp(
        geom, torch.as_tensor(u), torch.as_tensor(g), nm1), got, rtol=0,
        atol=0)
