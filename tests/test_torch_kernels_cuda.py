"""The port's two CUDA kernels against their plain PyTorch versions on
the card, at ragged shapes.  Imports no jax (the card's machine has
none): run there with

    python -m pytest --noconftest -m cuda tests/test_torch_import.py \\
        tests/test_torch_kernels_cuda.py

Every test skips where torch sees no CUDA device."""
import itertools

import numpy as np
import pytest
import torch

from rvspecfit_torch.fit import ccf
from rvspecfit_torch.ops import ccf_chisq, spline, spline_eval

pytestmark = pytest.mark.cuda

# kernel B's stated tolerance (3xTF32 on tensor cores vs cuBLAS fp32)
B_TOL = 1e-4
# kernel A's stated tolerance (same float32 formula, other op order)
A_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _ccf_inputs(nb, nt, nf, nv, seed, device):
    """Bank and exposure rFFTs of real series (positive T2 and IV, so
    c1 > 0) and the DFT-at-lag matrices, complex64/float32 on device."""
    rng = np.random.RandomState(seed)
    n = max(1, 2 * (nf - 1))
    tm = 1.0 + 0.1 * rng.normal(size=(nt, n))
    spec = 1.0 + 0.1 * rng.normal(size=(nb, n))
    ivar = rng.uniform(0.5, 2.0, (nb, n))
    cplx = [np.fft.rfft(tm, axis=1), np.fft.rfft(tm**2, axis=1),
            np.conj(np.fft.rfft(spec * ivar, axis=1)),
            np.conj(np.fft.rfft(ivar, axis=1))]
    ecos, esin = ccf.dft_mats(dict(npoints=n, logl0=0.0, logl1=n * 1e-4),
                              np.linspace(-400.0, 400.0, nv), device,
                              torch.float32)
    return [torch.as_tensor(c, dtype=torch.complex64, device=device)
            for c in cplx] + [ecos, esin]


def _assert_close(got, want, tol):
    """|got - want| <= tol * max|want| where want is finite; NaN where
    want is NaN."""
    torch.cuda.synchronize()
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    scale = float(want[~nan].abs().max())
    err = float((got[~nan] - want[~nan]).abs().max())
    assert err <= tol * scale, (err, scale)


# T >= 128 (a block's rows) gives every row its own template slot, and
# at B = 37 row blocks cross fiber boundaries
@pytest.mark.parametrize('continuum', [True, False])
@pytest.mark.parametrize('nb,nt,nf,nv',
                         list(itertools.product((1, 37), (1, 108, 129, 216),
                                                (1, 2049), (1, 401))))
def test_kernel_b_matches_plain(cuda_device, continuum, nb, nt, nf, nv):
    args = _ccf_inputs(nb, nt, nf, nv, seed=nb + nt + nf + nv,
                       device=cuda_device)
    before = ccf_chisq.launches
    got = ccf_chisq.ccf_chisq(*args, continuum=continuum)
    assert ccf_chisq.launches == before + 1
    want = ccf_chisq.ccf_chisq_plain(*args, continuum=continuum)
    assert got.shape == (nb, nt, nv)
    _assert_close(got, want, B_TOL)


def _spline_case(log_step, npix, ncoef, rows_per_coeff, seed, device):
    """Coefficients of smooth random spectra on a 4096-knot grid and
    Doppler-shifted queries, with a NaN, out-of-range queries and (in
    shared mode) one row whose queries are not monotone."""
    rng = np.random.RandomState(seed)
    xs = np.exp(np.linspace(np.log(4550.0), np.log(5450.0), 4096)) \
        if log_step else np.linspace(4550.0, 5450.0, 4096)
    geom = spline.SplineGeometry.from_knots(xs, log_step, device='cpu')
    ys = 1.0 + rng.normal(size=(ncoef, 4096)).cumsum(1) / 300.0
    coeffs = spline.spline_coeffs(geom, torch.as_tensor(ys))
    lam = np.linspace(4600.0, 5400.0, npix)
    idx0 = spline.fractional_index(geom, lam)
    vels = rng.uniform(-1000.0, 1000.0, ncoef * rows_per_coeff)
    if rows_per_coeff > 1:
        vels = np.tile(np.linspace(-1000.0, 1000.0, rows_per_coeff), ncoef)
    shift = spline.doppler_index_shift(geom, torch.as_tensor(vels)).numpy()
    u = idx0[None] + shift[:, None] * (1.0 if log_step
                                       else (lam / geom.step)[None])
    u[0, 5] = np.nan
    u[-1, :3] = [-2.5, -0.3, geom.n + 4.2]
    if rows_per_coeff > 1:
        u[1] = rng.permutation(u[1])
    geom_d = spline.SplineGeometry.from_knots(xs, log_step,
                                              device=device)
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device).contiguous()
    return geom_d, to(coeffs), to(u)


@pytest.mark.parametrize('log_step', [True, False])
@pytest.mark.parametrize('npix', [1023, 1024])
@pytest.mark.parametrize('ncoef,rows_per_coeff', [(300, 1), (3, 401),
                                                  (2, 16), (5, 3)])
def test_kernel_a_matches_plain(cuda_device, log_step, npix, ncoef,
                                rows_per_coeff):
    geom, coeffs, u = _spline_case(log_step, npix, ncoef, rows_per_coeff,
                                   seed=npix + ncoef, device=cuda_device)
    before = spline_eval.launches
    got = spline_eval.spline_eval_index(geom, coeffs, u, rows_per_coeff)
    assert spline_eval.launches == before + 1
    want = spline_eval.spline_eval_index_plain(geom, coeffs, u,
                                               rows_per_coeff)
    assert torch.isnan(want).sum() == 1
    _assert_close(got, want, A_TOL)


def test_kernel_a_shared_above_65535_rows(cuda_device):
    """The refine scan's shape class: more rows than gridDim.y."""
    geom, coeffs, u = _spline_case(True, 1024, 164, 401, seed=1,
                                   device=cuda_device)
    assert u.shape[0] > 65535
    got = spline_eval.spline_eval_index(geom, coeffs, u, 401)
    want = spline_eval.spline_eval_index_plain(geom, coeffs, u, 401)
    _assert_close(got, want, A_TOL)
