"""Parity of the port's post-NM tail with the JAX reference (float64,
CPU): the Hessian-to-errors rule, AD gradients and Hessians of the
likelihood, the gradient polish, the AD Hessian errors, the group fit,
and the autograd pair of kernel A with its adjoint.

The reference's polish, Hessian and group-fit programs compile for
30-140 s each on the CPU, so the tests that run them are marked slow;
tier 1 checks the same quantities against finite differences of the
reference's (cheaply compiled) chi-square."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import DESI_ARMS
from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.fit import batch as rbatch
from rvspecfit_tpu.fit import vel_fit as rvf
from rvspecfit_tpu.fit.likelihood import chisq_trials_core as r_chisq_core
from rvspecfit_tpu.ops import vsini as rvsini
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert
from rvspecfit_torch.fit import batch, vel_fit
from rvspecfit_torch.ops import clip as clip_mod
from rvspecfit_torch.ops import spline, spline_eval
from rvspecfit_torch.ops import vsini as pvsini
from rvspecfit_torch.pipeline import library
from rvspecfit_torch.survey import desi

CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2)
START = dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5)
NFIB = 3


# ------------------------------------------------------------------
# the Hessian -> errors rule

def _hessians():
    rng = np.random.RandomState(0)
    a = rng.normal(size=(4, 4))
    pd = a @ a.T + 4 * np.eye(4)
    indefinite = pd - 6 * np.eye(4)
    singular = np.outer(a[0], a[0])
    zero_diag = pd.copy()
    zero_diag[2, :] = zero_diag[:, 2] = 0.0
    negative_diag = np.diag([2.0, -1.0, 3.0, 0.5])
    return dict(pd=pd, indefinite=indefinite, singular=singular,
                zero_diag=zero_diag, negative_diag=negative_diag)


@pytest.mark.parametrize('case', sorted(_hessians()))
def test_uncertainties_from_hessian_match_reference(case):
    h = _hessians()[case]
    want = rvf._uncertainties_from_hessian(h.copy(), quiet=True)
    got = vel_fit.uncertainties_from_hessian(h.copy())
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


# ------------------------------------------------------------------
# clamps and the rotation kernel: the reference's NaN pattern

def test_clip_gradient_is_the_references():
    xs = [-2.0, -1.0, 0.0, 1.0, 2.0]
    want = [float(jax.grad(lambda x: jnp.clip(x, -1.0, 1.0))(x))
            for x in xs]
    x = torch.tensor(xs, dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(clip_mod.clip(x, -1.0, 1.0).sum(), x)
    np.testing.assert_array_equal(g, want)
    # an inf upstream gradient gives NaN outside the range, as jnp.clip
    y = torch.sqrt(clip_mod.clip(x, 0.0))
    g, = torch.autograd.grad(y.sum(), x)
    want = jax.grad(lambda v: jnp.sqrt(jnp.maximum(v, 0.0)).sum())(
        jnp.asarray(xs))
    np.testing.assert_array_equal(torch.isnan(g).numpy(), np.isnan(want))


@pytest.mark.parametrize('vsini', [0.0, 0.01, 30.0, 499.0])
def test_rotation_kernel_derivatives_match_reference(vsini):
    """d/dvsini and d2/dvsini2 of a weighted kernel sum: values where
    the reference's are finite, NaN where they are NaN."""
    log_step, hw = 1.2e-4, rvsini.kernel_half_width(500.0, 1.2e-4)
    wts = np.linspace(-1.0, 2.0, 2 * hw + 1)
    f = lambda v: (rvsini.rotation_kernel(v, log_step, hw) * wts).sum()
    want = [float(jax.grad(f)(vsini)), float(jax.grad(jax.grad(f))(vsini))]
    v = torch.tensor([vsini], dtype=torch.float64, requires_grad=True)
    val = (pvsini.rotation_kernel(v, log_step, hw)[0]
           * torch.as_tensor(wts)).sum()
    g, = torch.autograd.grad(val, v, create_graph=True)
    h, = torch.autograd.grad(g.sum(), v)
    np.testing.assert_allclose([float(g.detach()), float(h)], want,
                               rtol=1e-9)


# ------------------------------------------------------------------
# kernel A's autograd pair, plain route

@pytest.mark.parametrize('log_step', [True, False])
def test_autograd_pair_with_plain_versions(log_step):
    """gradcheck / gradgradcheck of SplineEval and SplineEvalAdjoint
    wired with the plain forward and plain adjoint, and the plain
    adjoint equal to autograd of the plain forward (NaN and
    out-of-range queries included)."""
    xs = np.exp(np.linspace(np.log(4550.0), np.log(4650.0), 40)) \
        if log_step else np.linspace(4550.0, 4650.0, 40)
    geom = spline.SplineGeometry.from_knots(xs, log_step, device='cpu')
    rng = np.random.RandomState(1)
    c = torch.tensor(rng.normal(size=(3, 4, 39)), requires_grad=True)
    u = torch.tensor(np.sort(rng.uniform(-2.0, 41.0, (3, 25)), 1))
    u[1] = u[1].flip(0)
    g = torch.tensor(rng.normal(size=(3, 25)), requires_grad=True)
    plain = spline_eval.PLAIN
    fwd = lambda c: spline_eval.SplineEval.apply(c, u, geom, plain)
    adj = lambda g: spline_eval.SplineEvalAdjoint.apply(u, g, geom, plain,
                                                        39)
    assert torch.autograd.gradcheck(fwd, (c,))
    assert torch.autograd.gradgradcheck(fwd, (c,))
    assert torch.autograd.gradcheck(adj, (g,))
    assert torch.autograd.gradgradcheck(adj, (g,))
    u[2, 4] = float('nan')
    out = spline_eval.spline_eval_index_plain(geom, c, u)
    want, = torch.autograd.grad(out, c, g.detach())
    got = spline_eval.spline_eval_index_vjp_plain(geom, u, g.detach(), 39)
    assert torch.isnan(got[2, :, 0]).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_band_correlation_pair():
    """The spline solve's correlation: its backward is the correlation
    with the flipped taps, and it equals conv1d."""
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.normal(size=(3, 20)), requires_grad=True)
    k = torch.tensor(rng.normal(size=7))
    f = lambda x: spline.BandCorrelation.apply(x, k)
    assert torch.autograd.gradcheck(f, (x,))
    assert torch.autograd.gradgradcheck(f, (x,))
    want = torch.nn.functional.conv1d(x[:, None], k[None, None],
                                      padding=3)[:, 0]
    torch.testing.assert_close(f(x), want, rtol=0, atol=0)


# ------------------------------------------------------------------
# gradients, Hessians and the polish on a small exposure

@pytest.fixture(scope='module')
def small():
    """3 fibers x 3 arms x 100 px on a 3x3x3x2 grid, npoly 5: the
    reference and port fitters, a shared start inside the grid (the
    true parameters, two fibers moved off them) and the port's NM
    optima from near the truth."""
    rtm = rsim.build_template_model(3, 3, 3, 2, npix=512)
    arms_data, truth = rsim.make_exposure(NFIB, npix_arm=100, seed=3)
    tm = convert.template_model(rtm, device='cpu')
    opts = {'npoly': 5}
    rbf = rbatch.BatchedFitter(
        [rbatch.BatchArm(n, *a) for n, a in arms_data.items()],
        {n: rtm for n in arms_data},
        freeze(dict(CONFIG, second_minimizer=True, template_lib='')),
        options=opts)
    pbf = batch.BatchedFitter(
        [batch.BatchArm(n, *a) for n, a in arms_data.items()],
        {n: tm for n in arms_data}, CONFIG, options=opts)
    pmap = vel_fit.ParamMapper(tm.parnames, START, [], None, False)
    x = np.stack([truth[k] for k in ('vel', 'teff', 'logg', 'feh',
                                     'alpha')], axis=1)
    x[0, 1:] += [150.0, 0.2, -0.1, 0.05]
    x[2, 1:] += [-80.0, -0.1, 0.1, -0.05]
    x0 = np.tile(pmap.start_vector(0.0), (NFIB, 1))
    x0[:, 0] = truth['vel'] + 3.0
    return dict(rbf=rbf, pbf=pbf, pmap=pmap, tm=tm, x=x,
                nm=pbf.run_neldermead(pmap, x0=x0),
                rmap=rvf.ParamMapper(rtm.parnames, START, [], None, False))


def _half_chisq_fd(rbf, vel, params, h):
    """Central finite differences of the reference's 0.5 chisq in the
    parameters with steps h (B, n): (gradient (B, n), Hessian (B, n, n))
    from one batched call of BatchedFitter.chisq over all stencil
    points."""
    b, n = params.shape
    e = np.eye(n)
    offs = [np.zeros(n)]
    for i in range(n):
        offs += [e[i], -e[i]]
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    for i, j in pairs:
        offs += [si * e[i] + sj * e[j]
                 for si, sj in ((1, 1), (1, -1), (-1, 1), (-1, -1))]
    offs = np.array(offs)
    pts = params[:, None, :] + offs[None] * h[:, None, :]
    f = 0.5 * np.asarray(rbf.chisq(
        jnp.asarray(np.repeat(vel[:, None], len(offs), 1)),
        jnp.asarray(pts)))
    grad = np.zeros((b, n))
    hess = np.zeros((b, n, n))
    for i in range(n):
        fp, fm = f[:, 1 + 2 * i], f[:, 2 + 2 * i]
        grad[:, i] = (fp - fm) / (2 * h[:, i])
        hess[:, i, i] = (fp - 2 * f[:, 0] + fm) / h[:, i]**2
    base = 1 + 2 * n
    for k, (i, j) in enumerate(pairs):
        fpp, fpm, fmp, fmm = (f[:, base + 4 * k + m] for m in range(4))
        hess[:, i, j] = hess[:, j, i] = \
            (fpp - fpm - fmp + fmm) / (4 * h[:, i] * h[:, j])
    return grad, hess


def test_hessian_matches_finite_differences_of_reference(small):
    """The port's AD gradient and Hessian of 0.5 chisq against central
    differences of the reference's chisq.  In units of each parameter's
    curvature scale (D H D, D g with D = diag(|H_ii|^-1/2)) they agree
    within 1e-4: the steps are 1% of that scale, so truncation and
    rounding are both far below it."""
    pbf, pmap = small['pbf'], small['pmap']
    vel, params, _ = pmap.unpack_host(small['x'])
    zeros = torch.zeros(NFIB, dtype=torch.float64)
    g, h = batch.grad_hessian(
        lambda p: 0.5 * pbf._chisq_at(torch.as_tensor(vel), p, zeros),
        torch.as_tensor(params))
    g, h = g.numpy(), h.numpy()
    scale = np.abs(np.diagonal(h, axis1=1, axis2=2))**-0.5
    g_fd, h_fd = _half_chisq_fd(small['rbf'], vel, params, 0.01 * scale)
    d = scale[:, :, None] * scale[:, None, :]
    np.testing.assert_allclose(h * d, h_fd * d, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g * scale, g_fd * scale, rtol=0, atol=1e-4)


@pytest.mark.slow
def test_grad_and_hessian_match_reference_ad(small):
    """The port's AD gradient and Hessian of chisq_trials_core against
    the reference's jax.grad / jax.hessian of the same single-fiber
    chisq (rtol 1e-9: the same arithmetic in float64)."""
    rbf, pbf, pmap = small['rbf'], small['pbf'], small['pmap']
    vel, params, _ = pmap.unpack_host(small['x'])

    def one(arms, templates, v, p):
        return r_chisq_core(arms, templates, v[None], p[None, :],
                            jnp.zeros(1), badchi=rbf.badchi,
                            use_vsini=False, half_widths={},
                            outside_penalty=True,
                            solve_dtype=rbf.solve_dtype)[0]

    axes = (rbf.arm_axes_ad, None, 0, 0)
    args = (rbf.arms_ad, rbf.templates, jnp.asarray(vel),
            jnp.asarray(params))
    g_ref = np.asarray(jax.vmap(jax.grad(one, argnums=3),
                                in_axes=axes)(*args))
    h_ref = np.asarray(jax.vmap(jax.hessian(one, argnums=3),
                                in_axes=axes)(*args))
    zeros = torch.zeros(NFIB, dtype=torch.float64)
    g, h = batch.grad_hessian(
        lambda p: pbf._chisq_at(torch.as_tensor(vel), p, zeros),
        torch.as_tensor(params))
    np.testing.assert_allclose(g, g_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(g_ref).max())
    np.testing.assert_allclose(h, h_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(h_ref).max())


def test_polish_moves_only_downhill_on_reference_objective(small):
    """Tier-1 check of the polish: every fiber's value is the
    reference's objective at its polished point, no fiber gets worse,
    a fiber that moved is strictly better, and the velocity stays."""
    pbf, pmap, x = small['pbf'], small['pmap'], small['x']
    fun0 = pbf._objective(pmap, None, torch.arange(NFIB))(
        torch.as_tensor(x)[:, None, :])[:, 0].numpy()
    pol = pbf.run_polish(pmap, x, fun0=fun0)
    vel, params, _ = pmap.unpack_host(pol['x'])
    ref_f = np.asarray(small['rbf'].chisq(jnp.asarray(vel[:, None]),
                                          jnp.asarray(params[:, None])))
    np.testing.assert_allclose(pol['fun'], ref_f[:, 0], rtol=1e-10)
    assert (pol['fun'] <= fun0).all()
    assert pol['moved'].any()
    assert (pol['fun'][pol['moved']] < fun0[pol['moved']]).all()
    np.testing.assert_array_equal(pol['x'][:, 0], x[:, 0])


@pytest.mark.slow
def test_polish_and_hessian_errors_match_reference(small):
    """run_polish (steps 2) and hessian_errors against the reference's
    from the same NM optima: same moved and bad_hess flags, x and fun
    within rtol 1e-7, errors within rtol 1e-7."""
    rbf, pbf, nm = small['rbf'], small['pbf'], small['nm']
    rp = rbf.run_polish(small['rmap'], nm['x'], fun0=nm['fun'], steps=2)
    pp = pbf.run_polish(small['pmap'], nm['x'], fun0=nm['fun'], steps=2)
    assert rp['moved'].any()
    np.testing.assert_array_equal(pp['moved'], rp['moved'])
    np.testing.assert_allclose(pp['x'], rp['x'], rtol=1e-7)
    np.testing.assert_allclose(pp['fun'], rp['fun'], rtol=1e-7)
    vel, params, _ = small['pmap'].unpack_host(rp['x'])
    re, rc, rb = rbf.hessian_errors(vel, params,
                                    parnames=small['tm'].parnames)
    pe, pc, pb = pbf.hessian_errors(vel, params,
                                    parnames=small['tm'].parnames)
    np.testing.assert_array_equal(pb, rb)
    np.testing.assert_allclose(pe, re, rtol=1e-7)
    np.testing.assert_allclose(pc, rc, rtol=1e-7,
                               atol=1e-7 * np.abs(rc).max())


# ------------------------------------------------------------------
# the group fit on the desi_library fixture

def _desi_group(nfib=NFIB, npix=100):
    """A small 3-arm DESI-like exposure: ({setup: (lam, flux, ivar)},
    truth)."""
    rng = np.random.RandomState(11)
    truth = dict(vel=rng.uniform(-300, 300, nfib),
                 teff=rng.uniform(4500, 9500, nfib),
                 logg=rng.uniform(1.0, 4.5, nfib),
                 feh=rng.uniform(-1.8, -0.2, nfib),
                 alpha=rng.uniform(0.1, 0.9, nfib))
    data = {}
    for s, (l0, l1) in DESI_ARMS.items():
        wave = np.linspace(l0, l1, npix)
        flux = np.zeros((nfib, npix))
        ivar = np.zeros((nfib, npix))
        for i in range(nfib):
            sp = rsim.fake_spectrum(
                wave / (1 + truth['vel'][i] / 299792.458),
                truth['teff'][i], truth['logg'][i], truth['feh'][i],
                truth['alpha'][i], wresol=5000.0 / 2000.0 / 2.35)
            flux[i] = sp + rng.normal(size=npix) * sp / 80.0
            ivar[i] = (80.0 / sp)**2
        data[f'desi_{s}'] = (wave, flux, ivar)
    return data, truth


def _port_group_fit(desi_library):
    cfg = dict(CONFIG, second_minimizer=True, template_lib=desi_library)
    data, truth = _desi_group()
    templates = {s: library.load_template_model(s, cfg, device='cpu')
                 for s in data}
    arms = [batch.BatchArm(s, *d, setup=s) for s, d in data.items()]
    return desi._run_group_fit(arms, templates, cfg, {'npoly': 5}), truth


def test_group_fit_recovers_and_reports_errors(desi_library):
    """Tier-1 check of the group fit: every stage ran, velocities are
    recovered, errors are finite where the Hessian is good, and the
    polish did not raise any fiber's value."""
    out, truth = _port_group_fit(desi_library)
    assert set(out['phases']) == {'ccf', 'nm', 'polish', 'refine',
                                  'hessian', 'models'}
    dv = out['ref']['best_vel'] - truth['vel']
    assert (np.abs(dv) < np.maximum(10.0, 5 * out['ref']['vel_err'])).all()
    assert (out['fun'] <= out['nm']['fun']).all()
    assert out['errs'].shape == out['params'].shape == (NFIB, 4)
    assert np.isfinite(out['errs'][~out['bad_hess']]).all()
    assert set(out['ccf_cols']) == {'CHISQ_CCF', 'VSINI_CCF', 'TEFF_CCF',
                                    'LOGG_CCF', 'FEH_CCF', 'ALPHAFE_CCF'}
    for name, m in out['mods']['models'].items():
        assert m.shape == (NFIB, 100) and np.isfinite(m).all()


@pytest.mark.slow
def test_group_fit_matches_reference(desi_library, monkeypatch):
    """_run_group_fit against the reference's synchronous branch
    (RVST_DEFER_TAIL=0) on 3 fibers: same CCF picks and BAD_HESSIAN
    flags; CCF chi-squares within rtol 1e-7 (a difference of large
    sums, whose rounding differs at ~1e-8 relative); velocities within
    1e-6 km/s, parameters and errors within rtol 1e-6."""
    from rvspecfit_tpu.pipeline import library as rlib
    from rvspecfit_tpu.survey import desi as rdesi
    monkeypatch.setenv('RVST_DEFER_TAIL', '0')
    cfg = dict(CONFIG, second_minimizer=True, template_lib=desi_library)
    data, _ = _desi_group()
    rt = {s: rlib.load_template_model(s, cfg) for s in data}
    want = rdesi._run_group_fit(
        [rbatch.BatchArm(s, *d, setup=s) for s, d in data.items()], rt,
        freeze(cfg), {'npoly': 5})
    got, _ = _port_group_fit(desi_library)
    np.testing.assert_array_equal(got['bad_hess'], want['bad_hess'])
    np.testing.assert_array_equal(got['converged'], want['converged'])
    for k, v in want['ccf_cols'].items():
        np.testing.assert_allclose(got['ccf_cols'][k], v, rtol=1e-7)
    np.testing.assert_allclose(got['ref']['best_vel'],
                               want['ref']['best_vel'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got['params'], want['params'], rtol=1e-6)
    np.testing.assert_allclose(got['errs'], want['errs'], rtol=1e-6)
