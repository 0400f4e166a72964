"""Synthetic template grids, exposures and CCF banks for the port.

The generators (``fake_spectrum``, ``make_template_grid``,
``make_exposure``) are the reference's (rvspecfit_tpu/simulation.py),
kept here so that building a workload imports nothing of the JAX
package; tests/test_torch_ccf.py checks they produce identical arrays.
``build_template_model`` and ``build_ccf_bank`` are the counterparts
of the reference functions of the same names.

The exposures drawn from a template model itself
(:func:`model_exposure`) and the CCF bank of a template model at the
grid's nodes (:func:`model_ccf_bank`) let a trained NN library
(pipeline/train_nn.py) be fitted on spectra it can reproduce exactly.
"""
import itertools

import numpy as np

from rvspecfit_torch.device import resolve_device

LINE_CENTERS = np.array([4980.3, 5035.8, 5061.2, 5108.9])
LINE_AMP = np.array([0.85, 0.55, 0.35, 0.65])
LINE_FEH_SENS = np.array([0.9, 1.7, 0.4, 1.1])
LINE_TEFF_SENS = np.array([0.4, -0.5, -0.8, 0.2])
LINE_ALPHA_SENS = np.array([0.1, 0.0, 0.6, -0.3])
LINE_WIDTH0 = np.array([0.12, 0.10, 0.15, 0.11])

TEFF_MIN, TEFF_MAX = 3000.0, 12000.0

# DESI-like three-arm wavelength layout (angstrom ranges per arm)
THREE_ARM_LAYOUT = {
    'B': (4600.0, 4900.0),
    'R': (4900.0, 5150.0),
    'Z': (5150.0, 5400.0),
}


def fake_spectrum(lam, teff, logg, feh, alpha, wresol=0.0):
    """Synthetic flux (energy units) on wavelength grid ``lam``: four
    Gaussian lines whose depths respond to the parameters, on a
    T^4-scaled continuum."""
    wline = np.sqrt((0.05 + 1.8 * logg / 5.0)**2 + LINE_WIDTH0**2)
    weff = np.sqrt(wline**2 + wresol**2)
    tnorm = (teff - TEFF_MIN) / (TEFF_MAX - TEFF_MIN)
    depth = (LINE_AMP * np.exp(LINE_FEH_SENS * feh)
             * (1.0 + LINE_TEFF_SENS * tnorm)
             * (1.0 + LINE_ALPHA_SENS * alpha))
    depth = np.clip(depth, 0.0, 0.95) * wline / weff
    prof = 1.0 - depth[None, :] * np.exp(
        -0.5 * (lam[:, None] - LINE_CENTERS[None, :])**2 / weff[None, :]**2)
    cont = (teff / 5000.0)**4 * (5000.0 / lam)
    return np.prod(prof, axis=1) * cont


def observed_spectrum(v0, teff, logg, feh, alpha, npix=800, lam0=4600.0,
                      lam1=5400.0, wresol=2.0, snr=100.0, seed=0):
    """One noisy observed spectrum with the radial velocity ``v0``
    injected (reference: rvspecfit_tpu/simulation.py:71): (lam, spec,
    espec) host arrays."""
    lam = np.linspace(lam0, lam1, npix)
    spec0 = fake_spectrum(lam / (1 + v0 / 299792.458), teff, logg, feh,
                          alpha, wresol=wresol)
    espec = spec0 / snr
    rng = np.random.RandomState(seed)
    return lam, spec0 + rng.normal(size=npix) * espec, espec


def make_template_grid(nt=6, nl=6, nf=6, na=4, npix=4096,
                       lam0=4550.0, lam1=5450.0, wresol=2.0):
    """Regular 4-d template grid on a log-uniform wavelength grid.

    Returns (lam, uvecs, idgrid, vecs, log_specs, parnames): spectra
    median-normalized and logged, params in mapped space (log10 teff).
    """
    lam = np.exp(np.linspace(np.log(lam0), np.log(lam1), npix))
    teffs = np.linspace(4000.0, 10000.0, nt)
    loggs = np.linspace(0.5, 5.0, nl)
    fehs = np.linspace(-2.0, 0.0, nf)
    alphas = np.linspace(0.0, 1.0, na)
    uvecs = [np.log10(teffs), loggs, fehs, alphas]
    combos = list(itertools.product(range(nt), range(nl), range(nf),
                                    range(na)))
    vecs = np.zeros((4, len(combos)))
    specs = np.zeros((len(combos), npix))
    idgrid = np.zeros((nt, nl, nf, na), dtype=int)
    for sid, (i, j, k, m) in enumerate(combos):
        t, g, f, a = teffs[i], loggs[j], fehs[k], alphas[m]
        sp = fake_spectrum(lam, t, g, f, a, wresol=wresol)
        specs[sid] = np.log(sp / np.median(sp))
        vecs[:, sid] = [np.log10(t), g, f, a]
        idgrid[i, j, k, m] = sid
    return lam, uvecs, idgrid, vecs, specs, ('teff', 'logg', 'feh', 'alpha')


def make_exposure(nfibers, npix_arm=1024, snr=50.0, seed=0,
                  layout=THREE_ARM_LAYOUT):
    """Multi-arm exposure of ``nfibers`` random stars with injected
    velocities.  Returns (arms {name: (lam, flux (B, npix), ivar)},
    truth {vel, teff, logg, feh, alpha: (B,)})."""
    rng = np.random.RandomState(seed)
    truth = dict(
        vel=rng.uniform(-500, 500, nfibers),
        teff=rng.uniform(4500, 9500, nfibers),
        logg=rng.uniform(1.0, 4.8, nfibers),
        feh=rng.uniform(-1.9, -0.1, nfibers),
        alpha=rng.uniform(0.05, 0.95, nfibers),
    )
    c = 299792.458
    arms = {}
    for name, (l0, l1) in layout.items():
        lam = np.linspace(l0, l1, npix_arm)
        flux = np.zeros((nfibers, npix_arm))
        ivar = np.zeros((nfibers, npix_arm))
        for i in range(nfibers):
            lam_rest = lam / (1 + truth['vel'][i] / c)
            sp = fake_spectrum(lam_rest, truth['teff'][i], truth['logg'][i],
                               truth['feh'][i], truth['alpha'][i],
                               wresol=2.0)
            esp = sp / snr
            flux[i] = sp + rng.normal(size=npix_arm) * esp
            ivar[i] = 1.0 / esp**2
        arms[name] = (lam, flux, ivar)
    return arms, truth


def template_artifacts(nt=6, nl=6, nf=6, na=4, npix=4096, lam0=4550.0,
                       lam1=5450.0, wresol=2.0):
    """The synthetic grid as a regular-grid library's host arrays: (the
    interp dict, as make_nd writes it, and the (nspec, npix) stored
    log-spectra); pipeline/library.template_model_from_artifacts builds
    the model from them."""
    lam, uvecs, idgrid, vecs, specs, parnames = make_template_grid(
        nt, nl, nf, na, npix=npix, lam0=lam0, lam1=lam1, wresol=wresol)
    fd = dict(interpolation_type='regulargrid', lam=lam, log_step=True,
              log_spec=True, log_ids=[0], parnames=list(parnames),
              uvecs={f'dim{i}': u for i, u in enumerate(uvecs)},
              idgrid=idgrid, vec=vecs)
    return fd, specs


def build_template_model(nt=6, nl=6, nf=6, na=4, npix=4096, lam0=4550.0,
                         lam1=5450.0, wresol=2.0, device=None):
    """Ready-to-fit TemplateModel of the synthetic grid on ``device``
    (None: the CUDA card, see device.resolve_device)."""
    from rvspecfit_torch.pipeline.library import \
        template_model_from_artifacts
    return template_model_from_artifacts(
        *template_artifacts(nt, nl, nf, na, npix=npix, lam0=lam0,
                            lam1=lam1, wresol=wresol), device=device)


def build_ccf_bank(nt=6, nl=6, nf=6, na=4, npix=4096, lam0=4550.0,
                   lam1=5450.0, every=4, ccf_lam0=4600.0, ccf_lam1=5400.0,
                   step=0.25, vsinis=None, continuum=True, device=None):
    """In-memory CCF template bank of the synthetic grid.  The template
    continua are fitted on ``device`` (None: the CUDA card) in its
    working dtype (float64); the rest is host float64.  ``continuum=False``
    builds a bank without continuum normalization.  Returns (tfft, t2fft,
    info) as numpy, shaped like the reference's; convert.ccf_bank moves
    it to a device."""
    lam, uvecs, idgrid, vecs, log_specs, parnames = make_template_grid(
        nt, nl, nf, na, npix=npix, lam0=lam0, lam1=lam1)
    return _ccf_bank_of(lam, np.exp(log_specs), vecs, parnames, every,
                        ccf_lam0, ccf_lam1, step, vsinis, continuum, device)


def _ccf_bank_of(lam, specs, vecs, parnames, every, ccf_lam0, ccf_lam1,
                 step, vsinis, continuum, device):
    """The bank of (nspec, npix) template spectra on ``lam`` at the
    (ndim, nspec) mapped parameters ``vecs`` (log10 teff first), through
    pipeline/make_ccf.build_bank."""
    from rvspecfit_torch.pipeline import make_ccf
    raw = vecs.copy()
    raw[0] = 10.0**raw[0]                # mapped log10(teff) -> teff
    npoints = make_ccf.to_power_two(int((ccf_lam1 - ccf_lam0) / step))
    ccfconf = make_ccf.get_ccf_config(
        logl0=np.log(ccf_lam0), logl1=np.log(ccf_lam1), npoints=npoints,
        splinestep=1000 if continuum else None)
    _, ffts, fft2s, info = make_ccf.build_bank(
        dict(vec=raw, specs=specs, lam=lam, parnames=parnames,
             log_spec=False), ccfconf, every=every, vsinis=vsinis,
        device=resolve_device(device))
    return ffts, fft2s, info


def _lam_of(tm):
    return tm.geom.xs.double().cpu().numpy()


def model_exposure(tm, nfibers, npix_arm=1024, snr=50.0, seed=0,
                   layout=THREE_ARM_LAYOUT):
    """A multi-arm exposure of ``nfibers`` stars drawn from the template
    model ``tm`` itself (on the CPU): truths drawn as in
    :func:`make_exposure`, the model's spectrum at each star's
    parameters, Doppler shifted through its natural cubic spline in
    wavelength, with Gaussian noise at S/N ``snr``.  Returns (arms
    {name: (lam, flux (B, npix), ivar)}, truth)."""
    import scipy.interpolate
    import torch
    rng = np.random.RandomState(seed)
    truth = dict(
        vel=rng.uniform(-500, 500, nfibers),
        teff=rng.uniform(4500, 9500, nfibers),
        logg=rng.uniform(1.0, 4.8, nfibers),
        feh=rng.uniform(-1.9, -0.1, nfibers),
        alpha=rng.uniform(0.05, 0.95, nfibers),
    )
    params = np.stack([truth[k] for k in ('teff', 'logg', 'feh', 'alpha')],
                      1)
    with torch.no_grad():
        rest = tm.eval_batch(torch.as_tensor(params, dtype=torch.float64))[0]
    rest = rest.double().cpu().numpy()
    spl = [scipy.interpolate.CubicSpline(_lam_of(tm), sp, bc_type='natural')
           for sp in rest]
    c = 299792.458
    arms = {}
    for name, (l0, l1) in layout.items():
        lam = np.linspace(l0, l1, npix_arm)
        flux = np.zeros((nfibers, npix_arm))
        ivar = np.zeros((nfibers, npix_arm))
        for i in range(nfibers):
            sp = spl[i](lam / (1 + truth['vel'][i] / c))
            esp = sp / snr
            flux[i] = sp + rng.normal(size=npix_arm) * esp
            ivar[i] = 1.0 / esp**2
        arms[name] = (lam, flux, ivar)
    return arms, truth


def model_ccf_bank(tm, nt=6, nl=6, nf=6, na=4, every=8, ccf_lam0=4600.0,
                   ccf_lam1=5400.0, step=0.25, vsinis=None, continuum=True,
                   device=None):
    """The CCF bank of the template model ``tm`` (on the CPU) evaluated
    at the synthetic grid's nodes, through pipeline/make_ccf's core, as
    numpy (tfft, t2fft, info) like :func:`build_ccf_bank`."""
    import torch
    _, uvecs, _, vecs, _, parnames = make_template_grid(nt, nl, nf, na,
                                                        npix=8)
    raw = vecs.T.copy()
    raw[:, 0] = 10.0**raw[:, 0]
    with torch.no_grad():
        specs = tm.eval_batch(torch.as_tensor(raw, dtype=torch.float64))[0]
    return _ccf_bank_of(_lam_of(tm), specs.double().cpu().numpy(), vecs,
                        parnames, every, ccf_lam0, ccf_lam1, step, vsinis,
                        continuum, device)
