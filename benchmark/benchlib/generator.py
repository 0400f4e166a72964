"""Seeded synthetic stellar spectra over a configuration's whole
wavelength range: the template grid (from the configuration's own fixed
seed) and the observed spectra with their truths (from ``--seed``).

Every line list is drawn once per configuration.  A spectrum is a
Planck continuum times exp(-sum_l tau_l phi_l), with Gaussian lines
phi_l whose optical depths tau_l respond to all four parameters (Teff,
log g, [Fe/H], [alpha/Fe]) and whose widths respond to log g, the
instrument's resolution and rotation, so that each fit is well posed.
Strong lines named by the configuration (the Ca II triplet for Gaia
RVS, the Balmer series for DESI) are added to the random ones.
Templates and spectra are computed on the device in float64, in a few
large calls.  The truths (velocities, rotation, S/N, parameters) are
drawn from the run's seed, stratified so that every seed gives the same
spread of values."""
import math

import numpy as np
import torch

C_KMS = 299792.458
HC_OVER_K = 1.438777e8          # hc/k in angstrom kelvin
PARNAMES = ('teff', 'logg', 'feh', 'alpha')


def template_lam(lam0, lam1, step, deltav=1000.0):
    """The log-uniform template wavelength grid that the upstream
    make_interpol writes for --lambda0/--lambda1/--step (padded by
    ``deltav`` km/s at each end)."""
    fac = 1 + deltav / C_KMS
    lstep = np.log(1 + step / (0.5 * (lam0 + lam1)))
    return np.exp(np.arange(np.log(lam0 / fac), np.log(lam1 * fac), lstep))


def arm_lam(arm):
    """An observed arm's linear wavelength grid: lam0..lam1 at step."""
    n = int(round((arm['lam1'] - arm['lam0']) / arm['step'])) + 1
    return arm['lam0'] + arm['step'] * np.arange(n)


def resolution_sigma(setup, lam):
    """Gaussian sigma (angstrom) of the templates' resolution: a fixed
    FWHM (``fwhm``, make_interpol's --resol_func x/FWHM) or a resolving
    power (``resol``)."""
    if 'fwhm' in setup:
        fwhm = np.full_like(lam, setup['fwhm'])
    else:
        fwhm = lam / setup['resol']
    return fwhm / (2 * math.sqrt(2 * math.log(2)))


def line_list(gen, lam0, lam1):
    """The configuration's lines on [lam0, lam1] (numpy dict of (L,)):
    random ones at ``gen['lines_per_100A']`` from ``gen['seed']``, then
    the named strong lines."""
    rng = np.random.default_rng(gen['seed'])
    n = int(round((lam1 - lam0) * gen['lines_per_100A'] / 100))
    out = dict(
        center=rng.uniform(lam0, lam1, n),
        tau0=np.exp(rng.uniform(np.log(0.02), np.log(2.5), n)),
        k_feh=rng.uniform(0.6, 1.4, n),
        k_teff=rng.normal(0.0, 2.5, n),
        k_alpha=np.where(rng.uniform(size=n) < 0.3,
                         rng.uniform(0.5, 1.2, n), rng.uniform(-0.2, 0.2, n)),
        k_logg=rng.normal(0.0, 0.3, n),
        width0=rng.uniform(0.05, 0.3, n))
    strong = gen.get('strong_lines') or []
    for c, tau, w in strong:
        for k, v in (('center', c), ('tau0', tau), ('k_feh', 0.5),
                     ('k_teff', 0.0), ('k_alpha', 0.1), ('k_logg', 0.2),
                     ('width0', w)):
            out[k] = np.append(out[k], v)
    return out


def _tau(lines, params):
    """(N, L) optical depths of the lines at (N, 4) parameters."""
    teff, logg, feh, alpha = params.unbind(-1)
    theta = (5040.0 / teff - 0.9)[:, None]
    return lines['tau0'] * torch.exp(
        lines['k_feh'] * feh[:, None] + lines['k_teff'] * theta
        + lines['k_alpha'] * alpha[:, None]
        + lines['k_logg'] * ((logg[:, None] - 3.0) / 2.0))


def _width(lines, logg):
    """(N, L) intrinsic line widths (angstrom) at (N,) log g."""
    return lines['width0'] * (1.0 + 0.12 * (logg[:, None] - 3.0)).clamp(
        min=0.2)


def _log_continuum(teff, lam):
    """(N, P) log Planck continua at (N,) Teff on (N, P) or (P,) lam."""
    return -5.0 * torch.log(lam) - torch.log(torch.expm1(
        HC_OVER_K / (lam * teff[:, None])))


def _lines_near(lines, lam0, lam1, device, pad=15.0):
    sel = (lines['center'] > lam0 - pad) & (lines['center'] < lam1 + pad)
    return {k: torch.as_tensor(v[sel], dtype=torch.float64, device=device)
            for k, v in lines.items()}


def grid_nodes(cfg):
    """The template grid's node values, in PARNAMES order."""
    return [np.asarray(cfg['templates']['nodes'][p], np.float64)
            for p in PARNAMES]


def template_grid(cfg, setup, device):
    """(lam (P,), log-spectra (nspec, P) float64 on ``device``) of one
    template setup: every node of the grid (row-major over PARNAMES),
    median-normalized and logged as the library stores them."""
    tcfg = cfg['templates']
    st = tcfg['setups'][setup]
    lam = template_lam(st['lam0'], st['lam1'], tcfg['step'],
                       tcfg.get('deltav', 1000.0))
    lines = _lines_near(line_list(cfg['generator'], *cfg_range(cfg)),
                        lam[0], lam[-1], device)
    nodes = grid_nodes(cfg)
    lam_t = torch.as_tensor(lam, dtype=torch.float64, device=device)
    sig_res = torch.as_tensor(resolution_sigma(st, lam), device=device)
    lens = [len(u) for u in nodes]
    nspec = int(np.prod(lens))
    out = torch.empty((nspec, len(lam)), dtype=torch.float64, device=device)
    view = out.view(lens[0], lens[1], lens[2] * lens[3], len(lam))
    t, f, a = np.meshgrid(nodes[0], nodes[2], nodes[3], indexing='ij')
    for ig, g in enumerate(nodes[1]):
        params = torch.as_tensor(np.stack(
            [t.ravel(), np.full(t.size, g), f.ravel(), a.ravel()], 1),
            device=device)
        w = _width(lines, params[:1, 1])[0]
        sig2 = w[:, None]**2 + sig_res[None, :]**2          # (L, P)
        phi = torch.exp(-0.5 * (lam_t[None, :] - lines['center'][:, None])**2
                        / sig2)
        logf = _log_continuum(params[:, 0], lam_t) - _tau(lines, params) @ phi
        logf = logf - logf.median(dim=1, keepdim=True).values
        view[:, ig] = logf.view(lens[0], lens[2] * lens[3], len(lam))
    return lam, out


def cfg_range(cfg):
    """The whole wavelength range of a configuration's templates."""
    st = cfg['templates']['setups'].values()
    return (min(s['lam0'] for s in st) - 50.0,
            max(s['lam1'] for s in st) + 50.0)


def _lhs(rng, n, lo, hi, log=False):
    """n stratified draws on [lo, hi] (uniform or log-uniform): one in
    each of n equal strata, in the order of a seeded permutation, so
    that every seed gives the same spread of values."""
    u = (rng.permutation(n) + rng.uniform(size=n)) / n
    if log:
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return lo + u * (hi - lo)


def draw_truths(traffic, n, rng):
    """Truths of ``n`` stars (numpy dict: vel, vsini, snr, the four
    parameters, flux scale and continuum distortion) from ``rng``,
    stratified over each consecutive ``traffic['block']`` stars (all
    ``n`` by default), so that a window that takes the first stars of a
    stream sees the same spread whatever the seed."""
    block = int(traffic.get('block') or n)
    if block < n:
        parts = [draw_truths(dict(traffic, block=None), min(block, n - lo),
                             rng) for lo in range(0, n, block)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    pr = traffic['params']
    truth = {p: _lhs(rng, n, *pr[p]) for p in PARNAMES}
    truth['vel'] = _lhs(rng, n, *traffic['vel'])
    snr = traffic['snr']
    truth['snr'] = _lhs(rng, n, snr[0], snr[1], log=True)
    nrot = int(round(traffic.get('rotating_share', 0.0) * n))
    vsini = np.zeros(n)
    if nrot:
        vsini[rng.permutation(n)[:nrot]] = _lhs(rng, nrot,
                                                *traffic['vsini'])
    truth['vsini'] = vsini
    truth['scale'] = np.exp(rng.uniform(np.log(3.0), np.log(30.0), n))
    truth['tilt'] = rng.uniform(-0.1, 0.1, (n, 2))
    return truth


def observe(cfg, setup, arm, truth, noise_gen, device, chunk=32):
    """Observed spectra of ``truth``'s stars in one arm: (flux, ivar),
    each (N, P) float32 host arrays as a coadd stores them.  The star's
    spectrum at its own parameters is evaluated at the Doppler-shifted
    rest wavelengths, broadened by the template setup's resolution and
    its rotation, tilted by a smooth throughput, and given Gaussian
    noise of constant sigma = median flux / snr from ``noise_gen``
    (a torch.Generator on ``device``)."""
    st = cfg['templates']['setups'][setup]
    lam = arm_lam(arm)
    lines = _lines_near(line_list(cfg['generator'], *cfg_range(cfg)),
                        lam[0] * 0.99, lam[-1] * 1.01, device)
    lam_t = torch.as_tensor(lam, dtype=torch.float64, device=device)
    sig_res2 = torch.as_tensor(resolution_sigma(st, lam), device=device)**2
    x = (lam_t - lam_t[0]) / (lam_t[-1] - lam_t[0]) * 2 - 1
    n = len(truth['vel'])
    flux = torch.empty((n, len(lam)), dtype=torch.float64, device=device)
    ivar = torch.empty_like(flux)
    tt = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
          for k, v in truth.items()}
    for lo in range(0, n, chunk):
        sl = slice(lo, min(n, lo + chunk))
        beta = tt['vel'][sl] / C_KMS
        rest = lam_t[None, :] * torch.sqrt((1 - beta) / (1 + beta))[:, None]
        params = torch.stack([tt[p][sl] for p in PARNAMES], 1)
        w2 = _width(lines, params[:, 1])**2                    # (b, L)
        rot2 = (0.45 * tt['vsini'][sl, None] / C_KMS
                * lines['center'][None, :])**2
        sig2 = (w2 + rot2)[:, :, None] + sig_res2[None, None, :]
        phi = torch.exp(-0.5 * (rest[:, None, :]
                                - lines['center'][None, :, None])**2 / sig2)
        phi = phi * torch.sqrt(w2[:, :, None] + sig_res2[None, None, :]
                               ) / torch.sqrt(sig2)
        logf = _log_continuum(params[:, 0], rest) \
            - torch.einsum('bl,blp->bp', _tau(lines, params), phi)
        f = torch.exp(logf - logf.median(dim=1, keepdim=True).values)
        f = f * tt['scale'][sl, None] * (1 + tt['tilt'][sl, :1] * x
                                         + tt['tilt'][sl, 1:] * x * x)
        sig = f.median(dim=1, keepdim=True).values / tt['snr'][sl, None]
        noise = torch.randn(f.shape, generator=noise_gen, device=device,
                            dtype=torch.float64)
        flux[sl] = f + sig * noise
        ivar[sl] = (1.0 / sig**2).expand_as(f)
    return (flux.float().cpu().numpy(), ivar.float().cpu().numpy())


def device_generator(seed, device, stream=0):
    """A torch.Generator on ``device`` seeded from (seed, stream)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, stream])
                      .generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g
