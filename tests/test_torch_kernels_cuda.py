"""The port's CUDA kernels (kernel A, its adjoint, kernel B), in their
float32 and float64 forms, against their plain PyTorch versions on the
card, at ragged shapes and at the main path's.  Imports
no jax (the card's machine has none): run there with

    python -m pytest --noconftest -m cuda tests/test_torch_import.py \\
        tests/test_torch_kernels_cuda.py

Every test skips where torch sees no CUDA device."""
import itertools

import numpy as np
import pytest
import torch

from rvspecfit_torch import trace
from rvspecfit_torch.fit import ccf
from rvspecfit_torch.ops import ccf_chisq, spline, spline_eval

pytestmark = pytest.mark.cuda

# kernel B's stated tolerance (3xTF32 on tensor cores vs cuBLAS fp32)
B_TOL = 1e-4
# kernel A's stated tolerance (same float32 formula, other op order)
A_TOL = 1e-5
# the adjoint's: float32 sums of a run of queries in another order than
# scatter_add's, relative to the largest |dcoeffs| of the row set
ADJ_TOL = 1e-5
# the float64 forms: the same number of rounding errors as each float32
# limit allows, at float64's unit roundoff (2^-53 against 2^-24)
F64_SCALE = 2.0**-29
TOL = {torch.float32: dict(A=A_TOL, B=B_TOL, ADJ=ADJ_TOL),
       torch.float64: dict(A=A_TOL * F64_SCALE, B=B_TOL * F64_SCALE,
                           ADJ=ADJ_TOL * F64_SCALE)}
COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
DTYPES = [torch.float32, torch.float64]


def _launches(prefix):
    """Launches so far of the kernels whose launch counters
    (rvspecfit_torch.trace) start with ``prefix``."""
    return sum(trace.counters(prefix).values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _ccf_inputs(nb, nt, nf, nv, seed, device, dtype=torch.float32):
    """Bank and exposure rFFTs of real series (positive T2 and IV, so
    c1 > 0) and the DFT-at-lag matrices, complex and real of ``dtype``
    on device."""
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
                              dtype)
    return [torch.as_tensor(c, dtype=COMPLEX[dtype], device=device)
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


# T >= 128 (the float32 kernel's block rows) gives every row its own
# template slot, and at B = 37 row blocks cross fiber boundaries; in
# float64 the blocks are templates x fibers (the wrapper's plan_f64),
# B = 1 is split over F in a cluster, and V = 409 takes a fourth
# column block of which one velocity is used
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('continuum', [True, False])
@pytest.mark.parametrize('nb,nt,nf,nv',
                         list(itertools.product((1, 37), (1, 108, 129, 216),
                                                (1, 2049), (1, 401, 409))))
def test_kernel_b_matches_plain(cuda_device, continuum, nb, nt, nf, nv,
                                dtype):
    args = _ccf_inputs(nb, nt, nf, nv, seed=nb + nt + nf + nv,
                       device=cuda_device, dtype=dtype)
    before = _launches('kernel_b.')
    got = ccf_chisq.ccf_chisq(*args, continuum=continuum)
    assert _launches('kernel_b.') == before + 1
    want = ccf_chisq.ccf_chisq_plain(*args, continuum=continuum)
    assert got.shape == (nb, nt, nv) and got.dtype == dtype
    _assert_close(got, want, TOL[dtype]['B'])
    if dtype == torch.float64:
        assert torch.equal(got, ccf_chisq.ccf_chisq(*args,
                                                    continuum=continuum))


@pytest.mark.parametrize('continuum', [True, False])
@pytest.mark.parametrize('nb', [1, 37, 500, 1000])
def test_kernel_b_f64_at_path_shapes(cuda_device, continuum, nb):
    """The float64 kernel at the path's T, F, V (108 templates, 2049
    frequencies, 401 velocities): B = 1 (ccf.fit, split over F in
    clusters whose sums go through a workspace), 37, 500 (an exposure)
    and 1000 (a driver group); two launches give the same bits (the
    slices are added in order, no atomics)."""
    args = _ccf_inputs(nb, 108, 2049, 401, seed=nb, device=cuda_device,
                       dtype=torch.float64)
    got = ccf_chisq.ccf_chisq(*args, continuum=continuum)
    again = ccf_chisq.ccf_chisq(*args, continuum=continuum)
    want = ccf_chisq.ccf_chisq_plain(*args, continuum=continuum)
    _assert_close(got, want, TOL[torch.float64]['B'])
    assert torch.equal(got, again)


@pytest.mark.parametrize('nb,continuum', [(2, True), (3, True),
                                           (3, False), (10, True),
                                           (16, True), (20, True)])
def test_kernel_b_f64_cluster_sizes(cuda_device, nb, continuum):
    """At the path's T, F, V and few fiber rows the float64 kernel is
    right, and gives the same bits on relaunch, at each cluster size
    that the planner picks (on 132 SMs: 16 slices in 2 clusters of 8
    and a workspace at B = 2, one cluster of 8, 7, 4, 3 and 2 slices at
    B = 3, 3 without continuum, 10, 16 and 20)."""
    args = _ccf_inputs(nb, 108, 2049, 401, seed=nb, device=cuda_device,
                       dtype=torch.float64)
    got = ccf_chisq.ccf_chisq(*args, continuum=continuum)
    want = ccf_chisq.ccf_chisq_plain(*args, continuum=continuum)
    _assert_close(got, want, TOL[torch.float64]['B'])
    assert torch.equal(got, ccf_chisq.ccf_chisq(*args, continuum=continuum))


def test_kernel_b_f64_takes_the_operands_of_its_own_bank(cuda_device):
    """Two banks of one shape on one grid, called in turn, and a bank
    written to in place: each launch gives its own bank's chi-squares
    (the wrapper keeps each bank's operands apart and rebuilds them
    after a write)."""
    a = _ccf_inputs(3, 108, 64, 401, seed=1, device=cuda_device,
                    dtype=torch.float64)
    b = _ccf_inputs(3, 108, 64, 401, seed=2, device=cuda_device,
                    dtype=torch.float64)
    b[4], b[5] = a[4], a[5]
    for args in (a, b, a, b):
        _assert_close(ccf_chisq.ccf_chisq(*args),
                      ccf_chisq.ccf_chisq_plain(*args),
                      TOL[torch.float64]['B'])
    a[0].mul_(0.5)
    _assert_close(ccf_chisq.ccf_chisq(*a), ccf_chisq.ccf_chisq_plain(*a),
                  TOL[torch.float64]['B'])


def test_kernel_b_f64_from_worker_threads_and_their_streams(cuda_device):
    """Kernel B launched from four worker threads at once on the jobs'
    stream, not the caller's (device.Background, as the prep pipeline
    runs the next group's CCF), on one bank whose operands the calling
    thread built on its stream: every result equals the plain version,
    and the launch counter adds every launch (it is locked)."""
    from rvspecfit_torch.device import Background
    args = _ccf_inputs(500, 108, 2049, 401, seed=5, device=cuda_device,
                       dtype=torch.float64)
    want = ccf_chisq.ccf_chisq_plain(*args)
    _assert_close(ccf_chisq.ccf_chisq(*args), want,
                  TOL[torch.float64]['B'])
    before = _launches('kernel_b.')

    def job():
        outs = [ccf_chisq.ccf_chisq(*args) for _ in range(5)]
        torch.cuda.current_stream().synchronize()
        return outs, torch.cuda.current_stream()
    jobs = [Background(job, cuda_device) for _ in range(4)]
    results = [j.result() for j in jobs]
    assert _launches('kernel_b.') == before + 20
    assert all(st != torch.cuda.default_stream(cuda_device)
               for _, st in results)
    for outs, _ in results:
        for got in outs:
            _assert_close(got, want, TOL[torch.float64]['B'])


def _spline_case(log_step, npix, ncoef, rows_per_coeff, seed, device,
                 dtype=torch.float32):
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
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=device).contiguous()
    return geom_d, to(coeffs), to(u)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('log_step', [True, False])
@pytest.mark.parametrize('npix', [1023, 1024])
@pytest.mark.parametrize('ncoef,rows_per_coeff', [(300, 1), (3, 401),
                                                  (2, 16), (5, 3)])
def test_kernel_a_matches_plain(cuda_device, log_step, npix, ncoef,
                                rows_per_coeff, dtype):
    geom, coeffs, u = _spline_case(log_step, npix, ncoef, rows_per_coeff,
                                   seed=npix + ncoef, device=cuda_device,
                                   dtype=dtype)
    before = (_launches('kernel_a.'), _launches('kernel_a.per_row.'),
              _launches('kernel_a.shared.'))
    got = spline_eval.spline_eval_index(geom, coeffs, u, rows_per_coeff)
    per_row = rows_per_coeff == 1
    assert (_launches('kernel_a.'), _launches('kernel_a.per_row.'),
            _launches('kernel_a.shared.')) == (before[0] + 1,
                                             before[1] + per_row,
                                             before[2] + (not per_row))
    want = spline_eval.spline_eval_index_plain(geom, coeffs, u,
                                               rows_per_coeff)
    assert torch.isnan(want).sum() == 1
    assert got.dtype == dtype
    _assert_close(got, want, TOL[dtype]['A'])


@pytest.mark.parametrize('rows_per_coeff', [1, 401])
@pytest.mark.parametrize('nfib', [1, 500, 1000])
def test_kernel_a_f64_at_path_shapes(cuda_device, nfib, rows_per_coeff):
    """The float64 kernel at the path's shapes: one trial per fiber
    (per-row mode) or 401 velocities per fiber (shared mode, 401000 rows
    at a driver group), 1024 pixels on the 4096-knot grid."""
    geom, coeffs, u = _spline_case(True, 1024, nfib, rows_per_coeff,
                                   seed=nfib, device=cuda_device,
                                   dtype=torch.float64)
    got = spline_eval.spline_eval_index(geom, coeffs, u, rows_per_coeff)
    want = spline_eval.spline_eval_index_plain(geom, coeffs, u,
                                               rows_per_coeff)
    _assert_close(got, want, TOL[torch.float64]['A'])


def test_kernel_a_shared_above_65535_rows(cuda_device):
    """The refine scan's shape class: more rows than gridDim.y."""
    geom, coeffs, u = _spline_case(True, 1024, 164, 401, seed=1,
                                   device=cuda_device)
    assert u.shape[0] > 65535
    got = spline_eval.spline_eval_index(geom, coeffs, u, 401)
    want = spline_eval.spline_eval_index_plain(geom, coeffs, u, 401)
    _assert_close(got, want, A_TOL)


def _adjoint_case(log_step, rows, npix, nm1, seed, device, kind='mixed',
                  dtype=torch.float32):
    """Queries of an arm's pixels Doppler-shifted per row on an
    (nm1 + 1)-knot grid and a random upstream gradient.  ``kind``:
    'mixed' adds a NaN, out-of-range queries and a row in reverse order;
    'constant' puts every query in one interval, 'below' / 'above' every
    query out of range on that side (u still increasing); 'descent'
    moves the last query of every other row back to an earlier
    interval; 'monotone' keeps the shifted rows as they are."""
    rng = np.random.RandomState(seed)
    n = nm1 + 1
    xs = np.exp(np.linspace(np.log(4550.0), np.log(5450.0), n)) \
        if log_step else np.linspace(4550.0, 5450.0, n)
    geom = spline.SplineGeometry.from_knots(xs, log_step, device=device)
    geom_cpu = spline.SplineGeometry.from_knots(xs, log_step, device='cpu')
    lam = np.linspace(4600.0, 5400.0, npix)
    idx0 = spline.fractional_index(geom_cpu, lam)
    vels = rng.uniform(-1000.0, 1000.0, rows)
    shift = spline.doppler_index_shift(geom_cpu,
                                       torch.as_tensor(vels)).numpy()
    u = idx0[None] + shift[:, None] * (1.0 if log_step
                                       else (lam / geom_cpu.step)[None])
    if kind == 'mixed':
        u[0, npix // 2] = np.nan
        u[-1, :min(3, npix)] = [-2.5, -0.3, n + 4.2][:min(3, npix)]
        if rows > 2:
            u[1] = u[1, ::-1]
    elif kind == 'constant':
        u[:] = 17.3
    elif kind == 'below':
        u[:] = -npix * 0.01 - 3.0 + np.arange(npix) * 0.01
    elif kind == 'above':
        u[:] = nm1 + 5.0 + np.arange(npix) * 0.01
    elif kind == 'descent':
        u[::2, -1] = u[::2, npix // 3]
    g = rng.normal(size=(rows, npix))
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
    return geom, to(u), to(g)


def _assert_adjoint_close(got, want):
    """NaN where the plain version has NaN, else within the adjoint's
    limit for the dtype of the largest finite |want|."""
    torch.cuda.synchronize()
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    fin = want[~nan]
    scale = float(fin.abs().max()) if fin.numel() else 0.0
    err = float((got[~nan] - fin).abs().max()) if fin.numel() else 0.0
    assert err <= TOL[got.dtype]['ADJ'] * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('log_step', [True, False])
@pytest.mark.parametrize('rows,npix,nm1',
                         list(itertools.product((1, 37, 500), (1, 1023, 1024),
                                                (49, 4095, 4097)))
                         + [(37, 2500, 49), (5, 2500, 4095), (1, 5000, 49),
                            (500, 5000, 49), (37, 5000, 4097)])
def test_adjoint_matches_plain(cuda_device, log_step, rows, npix, nm1,
                               dtype):
    """Ragged shapes: n-1 not a multiple of the kernel's segment of
    intervals (4096 in float32, 2048 in float64) and not 4-aligned
    (4095, 4097); 2500 and 5000 queries span several tiles (on 49
    intervals a run of one interval, ~100 queries, crosses a tile
    boundary; on 4095 and 4097 runs lie on both sides of each segment
    boundary)."""
    geom, u, g = _adjoint_case(log_step, rows, npix, nm1,
                               seed=rows + npix + nm1, device=cuda_device,
                               dtype=dtype)
    before = _launches('kernel_a_adjoint.')
    got = spline_eval.spline_eval_index_vjp(geom, u, g, nm1)
    assert _launches('kernel_a_adjoint.') == before + 1
    want = spline_eval.spline_eval_index_vjp_plain(geom, u, g, nm1)
    assert got.shape == (rows, 4, nm1)
    _assert_adjoint_close(got, want)


@pytest.mark.parametrize('kind', ['constant', 'below', 'above'])
@pytest.mark.parametrize('rows', [1, 500])
@pytest.mark.parametrize('nm1', [49, 4095, 4097])
def test_adjoint_rows_in_one_interval(cuda_device, kind, rows, nm1):
    """Every query of a row in one interval: one run of 1024 queries
    (constant u), or all clamped to the first or last interval.

    A float32 sum of 1024 terms is only as exact as the sum of their
    magnitudes allows, so the reference is the plain version in float64
    on the same float32 inputs, and the tolerance is ADJ_TOL of that
    sum of |terms| per element.  Within one of these intervals each
    plane's terms keep one sign apart from g's, so the plain version of
    |g| gives that sum."""
    geom, u, g = _adjoint_case(True, rows, 1024, nm1, seed=rows + nm1,
                               device=cuda_device, kind=kind)
    got = spline_eval.spline_eval_index_vjp(geom, u, g, nm1)
    want = spline_eval.spline_eval_index_vjp_plain(geom, u.double(),
                                                   g.double(), nm1)
    mags = spline_eval.spline_eval_index_vjp_plain(geom, u.double(),
                                                   g.double().abs(),
                                                   nm1).abs()
    torch.cuda.synchronize()
    assert ((got.double() - want).abs() <= ADJ_TOL * mags).all()
    assert (want != 0).any(1).sum(1).eq(1).all()
    assert (got != 0).any(1).sum(1).eq(1).all()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('log_step', [True, False])
@pytest.mark.parametrize('rows', [1, 500])
@pytest.mark.parametrize('nm1', [49, 4095, 4097])
def test_adjoint_sums_in_position_order_on_every_row(cuda_device, log_step,
                                                     rows, nm1, dtype):
    """A row whose last query steps back to an earlier interval takes the
    kernel's path for rows that are not monotone; it must give the same
    bits as the monotone row without that query on every interval the
    query does not touch (both paths sum in position order)."""
    geom, u, g = _adjoint_case(log_step, rows, 1024, nm1, seed=rows + nm1,
                               device=cuda_device, kind='descent',
                               dtype=dtype)
    got = spline_eval.spline_eval_index_vjp(geom, u, g, nm1)
    _assert_adjoint_close(got, spline_eval.spline_eval_index_vjp_plain(
        geom, u, g, nm1))
    cut = spline_eval.spline_eval_index_vjp(geom, u[:, :-1].contiguous(),
                                            g[:, :-1].contiguous(), nm1)
    torch.cuda.synchronize()
    last = torch.clamp(torch.floor(u[:, -1]), 0, nm1 - 1).long()
    keep = torch.ones((rows, nm1), dtype=torch.bool, device=cuda_device)
    keep[torch.arange(rows, device=cuda_device), last] = False
    keep = keep[:, None, :].expand(-1, 4, -1)
    assert torch.equal(got[keep], cut[keep])
    assert not torch.equal(got, cut)


@pytest.mark.parametrize('rows', [1, 500, 1000])
def test_adjoint_f64_at_path_shapes(cuda_device, rows):
    """The float64 adjoint at the polish's shape (one row of 1024
    queries per fiber on 4095 intervals: two segments of 2048 a row),
    for 1, 500 and 1000 fibers; two launches give the same bits."""
    geom, u, g = _adjoint_case(True, rows, 1024, 4095, seed=rows,
                               device=cuda_device, kind='monotone',
                               dtype=torch.float64)
    got = spline_eval.spline_eval_index_vjp(geom, u, g, 4095)
    again = spline_eval.spline_eval_index_vjp(geom, u, g, 4095)
    _assert_adjoint_close(got, spline_eval.spline_eval_index_vjp_plain(
        geom, u, g, 4095))
    assert torch.equal(got, again)


def test_adjoint_of_a_nan_query_is_nan_in_interval_0(cuda_device):
    geom, u, g = _adjoint_case(True, 3, 64, 4095, seed=2,
                               device=cuda_device)
    u[2] = float('nan')
    got = spline_eval.spline_eval_index_vjp(geom, u, g, 4095)
    torch.cuda.synchronize()
    assert torch.isnan(got[2, :, 0]).all()
    assert not torch.isnan(got[2, :, 1:]).any()


@pytest.mark.parametrize('dtype', DTYPES)
def test_adjoint_is_bit_reproducible(cuda_device, dtype):
    geom, u, g = _adjoint_case(True, 500, 1024, 4095, seed=3,
                               device=cuda_device, dtype=dtype)
    a = spline_eval.spline_eval_index_vjp(geom, u, g, 4095)
    b = spline_eval.spline_eval_index_vjp(geom, u, g, 4095)
    torch.cuda.synchronize()
    assert torch.equal(torch.nan_to_num(a, nan=7.0),
                       torch.nan_to_num(b, nan=7.0))


@pytest.mark.parametrize('log_step', [True, False])
def test_kernel_pair_derivatives_match_plain_pair(cuda_device, log_step):
    """First and second derivatives through the CUDA pair equal those
    through the plain pair in float32 (a gradgradcheck of the wiring
    with the kernels in it)."""
    geom, u, g = _adjoint_case(log_step, 37, 1023, 4095, seed=4,
                               device=cuda_device)
    u = torch.nan_to_num(u, nan=100.0)
    rng = np.random.RandomState(5)
    c0 = torch.as_tensor(rng.normal(size=(37, 4, 4095)),
                         dtype=torch.float32, device=cuda_device)
    gg = torch.as_tensor(rng.normal(size=(37, 4, 4095)),
                         dtype=torch.float32, device=cuda_device)
    out = {}
    for name, route in (('cuda', spline_eval.KERNELS),
                        ('plain', spline_eval.PLAIN)):
        c = c0.clone().requires_grad_(True)
        gu = g.clone().requires_grad_(True)
        y = spline_eval.SplineEval.apply(c, u, geom, route)
        dc, = torch.autograd.grad(y, c, gu, create_graph=True)
        dg, = torch.autograd.grad(dc, gu, gg)
        out[name] = (y.detach(), dc.detach(), dg)
    for got, want in zip(out['cuda'], out['plain']):
        _assert_adjoint_close(got, want)


@pytest.mark.parametrize('log_step', [True, False])
def test_velocity_gradient_through_kernels_matches_plain(cuda_device,
                                                         log_step):
    """d out/du through the CUDA pair (kernel A on the derivative's
    coefficients) against the plain pair's, float32 on the card."""
    geom, u, g = _adjoint_case(log_step, 5, 1024, 4095, seed=6,
                               device=cuda_device)
    u = torch.nan_to_num(u, nan=100.0)
    c = torch.as_tensor(np.random.RandomState(7).normal(size=(5, 4, 4095)),
                        dtype=torch.float32, device=cuda_device)
    out = {}
    for name, route in (('cuda', spline_eval.KERNELS),
                        ('plain', spline_eval.PLAIN)):
        uu = u.clone().requires_grad_(True)
        y = spline_eval.SplineEval.apply(c, uu, geom, route)
        out[name], = torch.autograd.grad(y, uu, g)
    _assert_close(out['cuda'], out['plain'], A_TOL)


def _single_object(device, seed=3):
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit.spec_data import SpecData
    tm = simulation.build_template_model(3, 3, 3, 2, npix=512,
                                         device=device)
    arms, truth = simulation.make_exposure(1, npix_arm=300, seed=seed)
    sds = [SpecData(n, lam, fl[0], 1.0 / np.sqrt(iv[0]))
           for n, (lam, fl, iv) in arms.items()]
    return sds, {n: tm for n in arms}, truth


def _ccf_contraction(sds, cfg, bank):
    """Kernel B's (T, V) chi-squares (without sse) in ccf.fit, summed
    over the arms, on the CPU in float64."""
    out = 0.0
    for sd in sds:
        p = ccf.prepare_arm_batch(sd.name, sd.lam, sd.spec, sd.espec,
                                  sd.badmask[None], cfg, bank)
        out = out + ccf_chisq.ccf_chisq_plain(
            p['tfft'], p['t2fft'], p['sfft_conj'], p['ivfft_conj'],
            p['ecos'], p['esin'], continuum=p['continuum']).numpy()[0]
    return out


# kernel B against its plain version in ccf.fit's best chi-square
# curve, relative to max|contraction|: float64 on both sides (B_TOL in
# float64, see TOL)
CCF_CURVE_TOL = B_TOL * F64_SCALE
# the card's ccf.fit velocity against the CPU float64 run's (km/s)
CCF_VEL_TOL = 0.01


def test_single_object_ccf_fit_on_the_card(cuda_device, monkeypatch):
    """ccf.fit on the card (kernel B in float64 at one fiber row, once
    per arm) against two witnesses on the same input: the card with
    kernel B's plain version, which tells the kernel's own error from
    the rest of the card's arithmetic, and the CPU float64 run.  The same
    template in all three, the kernel run's best chi-square curve within
    CCF_CURVE_TOL of max|contraction| of the plain run's (a velocity
    shift of one grid step would break that), and its velocity within
    CCF_VEL_TOL of the CPU's.  In float32 the
    contraction's terms (up to 4e6) rounded the curve, which rises by ~1
    per 5 km/s step at its minimum, enough to move the velocity by
    1.3-7.3 km/s on this input (ROADMAP C.2, repaired by the card's
    float64)."""
    from rvspecfit_torch import convert, simulation
    bank = simulation.build_ccf_bank(3, 3, 3, 2, npix=512, every=2,
                                     step=1.0, device='cpu')
    sds, _, truth = _single_object('cpu')
    cfg = dict(max_vel=1000, vel_step0=5)
    res = {}
    for key in ('kernel', 'plain', 'cpu'):
        dev = 'cpu' if key == 'cpu' else 'cuda'
        b = convert.ccf_bank(*bank, device=dev)
        with monkeypatch.context() as m:
            if key == 'plain':
                m.setattr(ccf_chisq, 'ccf_chisq', ccf_chisq.ccf_chisq_plain)
            before = _launches('kernel_b.')
            res[key] = ccf.fit(sds, cfg, banks={sd.name: b for sd in sds})
            assert _launches('kernel_b.') == before + (
                len(sds) if key == 'kernel' else 0)
    assert res['kernel']['best_par'] == res['plain']['best_par'] \
        == res['cpu']['best_par']
    out = _ccf_contraction(sds, cfg, convert.ccf_bank(*bank, device='cpu'))
    tol = CCF_CURVE_TOL * np.abs(out).max()
    row = out[np.argmin(out.min(1))]
    curve = {k: r['best_ccf'] for k, r in res.items()}
    diff = np.abs(curve['kernel'] - curve['plain']).max()
    shift = np.abs(row[1:] - row[:-1]).max()
    dv = abs(res['kernel']['best_vel'] - res['cpu']['best_vel'])
    print(f'ccf.fit best_vel: kernel {res["kernel"]["best_vel"]!r}, plain '
          f'{res["plain"]["best_vel"]!r}, CPU float64 '
          f'{res["cpu"]["best_vel"]!r} km/s; best curve max|kernel - '
          f'plain| {diff!r}, max|plain - CPU| '
          f'{np.abs(curve["plain"] - curve["cpu"]).max()!r}, limit '
          f'{tol!r}; a one-step shift changes it by up to {shift!r}')
    assert shift > tol
    assert diff <= tol
    assert dv <= CCF_VEL_TOL
    assert abs(res['cpu']['best_vel'] - truth['vel'][0]) < 30.0


def test_process_on_the_card(cuda_device):
    """One vel_fit.process on the card with the BFGS stage: kernel A in
    both modes and its adjoint launch; the velocity within max(1 km/s,
    sigma/2) of the CPU float64 run's, and the truth recovered."""
    from rvspecfit_torch.fit import vel_fit
    cfg = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
               min_vsini=1e-2, min_vel_step=0.2, second_minimizer=True)
    start = dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5)
    res = {}
    for dev in ('cuda', 'cpu'):
        sds, templates, truth = _single_object(dev)
        before = (_launches('kernel_a.per_row.'), _launches('kernel_a.shared.'),
                  _launches('kernel_a_adjoint.'))
        res[dev] = vel_fit.process(sds, start, config=cfg,
                                   options={'npoly': 6},
                                   templates=templates)
        after = (_launches('kernel_a.per_row.'), _launches('kernel_a.shared.'),
                 _launches('kernel_a_adjoint.'))
        if dev == 'cuda':
            assert all(a > b for a, b in zip(after, before))
    got, want = res['cuda'], res['cpu']
    assert abs(got['vel'] - want['vel']) <= max(1.0, 0.5 * want['vel_err'])
    assert abs(want['vel'] - truth['vel'][0]) < max(10.0,
                                                    3 * want['vel_err'])


def test_trainer_on_the_card(cuda_device):
    """pipeline/train_nn on the card against the CPU float64 run from
    the same seed (one init_state draw, the same batches): 2 epochs'
    losses within rtol 1e-9 and the folded weights within 1e-9 of each
    array's largest entry (the same arithmetic in another BLAS's
    order); the PCA layer (cuSOLVER against LAPACK) within 1e-9."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.interp import nn
    from rvspecfit_torch.pipeline import train_nn
    _, _, _, vecs, specs, _ = simulation.make_template_grid(5, 5, 4, 3,
                                                            npix=60)
    kw = dict(width=32, nlayers=2, npc=8, batch_size=64, lr0=1e-3,
              num_epochs=2, pca_init=False, seed=5)
    runs = {dev: train_nn.train_interpolator(vecs.T, specs, device=dev, **kw)
            for dev in (cuda_device, 'cpu')}
    (card, hcard), (cpu, hcpu) = runs[cuda_device], runs['cpu']
    assert card.mean.device.type == 'cuda' and card.mean.dtype == torch.float64
    np.testing.assert_allclose(hcard['loss'], hcpu['loss'], rtol=1e-9)
    got, want = nn.state_to_dict(card), nn.state_to_dict(cpu)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert np.abs(got[k] - w).max() <= 1e-9 * np.abs(w).max(), k
    targets = torch.as_tensor((specs - specs.mean(0)) / specs.std(0))
    pcs = [train_nn.pca_init_pc_layer(targets.to(dev), 8)
           for dev in (cuda_device, 'cpu')]
    for a, b in zip(*pcs):
        assert float((a.cpu() - b).abs().max()) <= 1e-9


# -------------------------------------------------------------------
# Nelder-Mead's iteration as a CUDA graph (fit/nm_graph.py)

NM_CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
                 min_vsini=1e-2, min_vel_step=0.2, second_minimizer=False)
NM_START = dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5, vsini=10.0)
NM_FATOL = 5e-2
NM_MB = 500


@pytest.fixture(scope='module')
def nm_card():
    """{use_vsini: (fitter, mapper, state)}: chip_smoke's 500-fiber
    exposure (3 arms of 1024 px) on its 864-template grid at 4096 px,
    microbatch 500 (tile widths 500, 250, 125), each fiber's simplex set
    up around its true velocity: state = (simplex, fvals, done, xatol)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit import neldermead as nm
    from rvspecfit_torch.fit import vel_fit
    from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
    from rvspecfit_torch.pipeline.library import \
        template_model_from_artifacts
    dev = torch.device('cuda', 0)
    tm = template_model_from_artifacts(*simulation.template_artifacts(
        6, 6, 6, 4, npix=4096, lam0=4550.0, lam1=5450.0, wresol=2.0),
        device=dev)
    data, truth = simulation.make_exposure(NM_MB, npix_arm=1024, snr=50.0,
                                           seed=7)
    arms = [BatchArm(n, lam, fl, iv) for n, (lam, fl, iv) in data.items()]
    out = {}
    for use_vsini in (False, True):
        bf = BatchedFitter(arms, {a.name: tm for a in arms}, NM_CONFIG,
                           {'npoly': 10}, use_vsini=use_vsini,
                           microbatch=NM_MB)
        mapper = vel_fit.ParamMapper(tm.parnames, NM_START, [],
                                     vel_fit.VSiniMapper(500, 1e-2),
                                     use_vsini)
        x0 = np.tile(mapper.start_vector(0.0), (NM_MB, 1))
        x0[:, 0] = truth['vel'] + 3.0
        scales = mapper.scales()
        simplex = torch.as_tensor(nm.build_simplex(
            x0, scales, vel_fit.SIMPLEX_SEED), device=dev)
        xatol = torch.as_tensor(scales * 0.08, device=dev)
        fun = nm.in_working_dtype(bf._objective(
            mapper, None, torch.arange(NM_MB, device=dev)), bf.dtype)
        fvals, done = nm.nm_init(fun, simplex, NM_FATOL, xatol)
        out[use_vsini] = (bf, mapper, (simplex, fvals, done, xatol))
    return out


def _nm_graphs(nm_card, scheme, use_vsini=False):
    from rvspecfit_torch.fit import nm_graph
    bf, mapper, state = nm_card[use_vsini]
    return bf, state, bf.nm_graphs(mapper, None, nm_graph.ladder(NM_MB),
                                   scheme, NM_FATOL, state)


def _load(bf, state, g, npad=3):
    """Load the graph's tile with its width less ``npad`` unconverged
    fibers, padded."""
    from rvspecfit_torch.fit import nm_graph
    undone = torch.nonzero(~state[2])[:, 0]
    (sel, n), = nm_graph.tiles(undone[:g.width - npad], [g.width])
    assert n == g.width - npad
    g.load(bf.arms, sel, n, *state)


def _eager_step(g, scheme):
    from rvspecfit_torch.fit import neldermead as nm
    return nm._step(g.fun, *[t.clone() for t in g.state], NM_FATOL,
                    g.xatol, scheme)


@pytest.mark.parametrize('scheme', ['scan2', 'cand4'])
def test_nm_graph_replays_the_eager_iteration_bit_for_bit(nm_card, scheme):
    """At each width of the ladder, four iterations replayed equal
    neldermead._step run eagerly on the same buffers, bit for bit, with
    the shrink redone apart; before the third, seven fibers' values are
    lowered by 1e6, so that they shrink."""
    bf, state, graphs = _nm_graphs(nm_card, scheme)
    assert sorted(graphs) == [125, 250, 500]
    for w, g in graphs.items():
        _load(bf, state, g)
        for k in range(4):
            if k == 2:
                g.state[1][:7] -= 1e6
            want = _eager_step(g, scheme)
            shrink, live = g.replay()
            if k == 2:
                assert shrink
            if shrink:
                live = g.shrink()
            for got, exp in zip(g.state, want):
                assert torch.equal(got, exp), (w, k)
            assert live == int((~want[2]).sum())


def test_nm_graph_replays_count_the_eager_launches(nm_card):
    """A replay applies the counts and events of the kernel launches the
    graph holds: the same kernel A counters and events (with their
    shapes) as the eager iteration's (two per-row calls under scan2 on
    3 arms)."""
    bf, state, graphs = _nm_graphs(nm_card, 'scan2')
    g = graphs[500]
    _load(bf, state, g)

    def launches(fn):
        before = trace.counters('kernel_a')
        trace.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = fn()
            torch.cuda.synchronize()
        after = trace.counters('kernel_a')
        return ({k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)},
                [(r.name, r.attrs) for r in trace.spans()
                 if r.kind == 'event'], out)

    eager = launches(lambda: _eager_step(g, 'scan2'))
    replay = launches(g.replay)
    assert not replay[2][0]
    assert replay[:2] == eager[:2]
    assert eager[0] == {'kernel_a.per_row.float64': 6}
    assert [e[1]['rows'] for e in eager[1]] == [500] * 6


def test_nm_graph_captures_beside_a_busy_thread(nm_card):
    """A capture (capture_error_mode='thread_local') while another
    thread runs matrix products and allocations on its own stream (no
    draws from the card's random generator), and its replay equals the
    eager iteration."""
    import threading
    from rvspecfit_torch.fit import nm_graph
    stop = threading.Event()
    ran = []

    def busy():
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            x = torch.ones(1024, 1024, dtype=torch.float64,
                           device='cuda') / 1024
            while not stop.is_set():
                x = (x @ x).clamp_(max=1.0)
                torch.empty(1 << 22, device='cuda')
                ran.append(float(x[0, 0]))
    th = threading.Thread(target=busy)
    th.start()
    try:
        while not ran:
            pass
        captures = trace.counters('fit.nm.graph_captures').get(
            'fit.nm.graph_captures', 0)
        nm_graph._ladders.clear()
        bf, state, graphs = _nm_graphs(nm_card, 'scan2')
        assert trace.counters('fit.nm.graph_captures')[
            'fit.nm.graph_captures'] == captures + 3
    finally:
        stop.set()
        th.join()
    n = len(ran)
    g = graphs[250]
    _load(bf, state, g)
    want = _eager_step(g, 'scan2')
    if g.replay()[0]:
        g.shrink()
    assert all(torch.equal(a, b) for a, b in zip(g.state, want))
    assert n > 1


def test_nm_graph_captures_the_vsini_and_fast_interp_objectives(nm_card):
    """With rotation (the vsini kernel and its broadening) an iteration
    replays as it runs eagerly; the likelihood with ``fast_interp`` (the
    nearest-pixel gather) captures too and replays its eager values."""
    from rvspecfit_torch.fit.likelihood import chisq_trials_core
    bf, state, graphs = _nm_graphs(nm_card, 'scan2', use_vsini=True)
    g = graphs[125]
    _load(bf, state, g)
    want = _eager_step(g, 'scan2')
    if g.replay()[0]:
        g.shrink()
    assert all(torch.equal(a, b) for a, b in zip(g.state, want))

    bf = nm_card[False][0]
    vel = torch.linspace(-300, 300, NM_MB, dtype=torch.float64,
                         device='cuda')[:, None]
    params = torch.tensor([6000.0, 3.0, -1.0, 0.5], dtype=torch.float64,
                          device='cuda').expand(NM_MB, 1, 4).contiguous()

    def call():
        return chisq_trials_core(bf.arms, bf.templates, vel, params,
                                 torch.zeros_like(vel), badchi=bf.badchi,
                                 use_vsini=False, half_widths={},
                                 fast_interp=True)
    want = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='thread_local'):
        got = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_nm_graph_iteration_is_one_replay_and_one_read(nm_card):
    """Five iterations at width 500 without a shrink: the host launches
    one graph each, at most 10 kernels each beside it (none, as
    written) and one device-to-host copy each; the profiler records the
    replayed kernels by name (kernel A's per-row kernel on the device).
    The eager iteration's launches are printed beside them."""
    bf, state, graphs = _nm_graphs(nm_card, 'scan2')
    g = graphs[500]
    _load(bf, state, g)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def counts(fn):
        with torch.profiler.profile(activities=acts) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        dev = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        return dict(
            graphs=sum(n.startswith('cudaGraphLaunch') for n in names),
            kernels=sum(n.startswith(('cudaLaunchKernel', 'cuLaunchKernel'))
                        for n in names),
            d2h=sum('DtoH' in n or 'Device -> Pageable' in n
                    or 'Device -> Pinned' in n for n in dev),
            rows_kernel=sum('spline_rows_kernel' in n for n in dev)), out

    got, flags = counts(lambda: [g.replay() for _ in range(5)])
    assert not any(f[0] for f in flags)
    eager, _ = counts(lambda: _eager_step(g, 'scan2'))
    print(f'\nper iteration: replayed {got}, eager {eager}')
    assert got['graphs'] == 5
    assert got['kernels'] <= 10 * 5
    assert got['d2h'] == 5
    assert got['rows_kernel'] == 5 * 6
    assert eager['kernels'] > 300


def test_nm_groups_of_any_size_replay_one_ladder(nm_card):
    """Without a microbatch, groups of 300 and of 450 fibers both tile
    NM at the widest width 500 (and 250, 125): the first group captures
    the three graphs, the second replays them and captures none."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit import nm_graph
    from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
    bf0, mapper, _ = nm_card[False]
    data, truth = simulation.make_exposure(NM_MB, npix_arm=1024, snr=50.0,
                                           seed=7)
    nm_graph._ladders.clear()
    name = 'fit.nm.graph_captures'
    captures = []
    for nfib in (300, 450):
        arms = [BatchArm(n, lam, fl[:nfib], iv[:nfib])
                for n, (lam, fl, iv) in data.items()]
        bf = BatchedFitter(arms, bf0.templates, NM_CONFIG, {'npoly': 10})
        assert bf.microbatch is None
        before = trace.counters(name).get(name, 0)
        res = bf.run_neldermead(mapper, truth['vel'][:nfib] + 3.0,
                                maxiter=8, maxrestart=1, nm_chunk=4)
        assert res['replayed'] and res['x'].shape[0] == nfib
        captures.append(trace.counters(name).get(name, 0) - before)
    assert captures == [3, 0]


def test_nm_graph_two_threads_capture_on_one_card(nm_card):
    """Two threads (as two shards of a mesh on one card) build their
    ladders at once: the process captures one graph at a time, so
    neither capture meets the other's device synchronization, and each
    thread's graphs replay the eager iteration."""
    import threading
    from rvspecfit_torch.fit import nm_graph
    nm_graph._ladders.clear()
    out, errs = {}, []

    def build(scheme):
        try:
            torch.cuda.set_device(0)
            out[scheme] = _nm_graphs(nm_card, scheme)
        except BaseException as exc:
            errs.append(exc)
    threads = [threading.Thread(target=build, args=(s,))
               for s in ('scan2', 'cand4')]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, errs
    for scheme, (bf, state, graphs) in out.items():
        g = graphs[125]
        _load(bf, state, g)
        want = _eager_step(g, scheme)
        if g.replay()[0]:
            g.shrink()
        assert all(torch.equal(a, b) for a, b in zip(g.state, want))
