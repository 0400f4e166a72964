"""Batched robust continuum fitting and CCF spectrum preprocessing.

Counterpart of rvspecfit_tpu/ops/continuum.py:

* :func:`fit_continuum` — soft-L1 robust fit of a quadratic
  log-flux spline (nodes every ``splinestep`` km/s) for a stack of
  spectra, as batched IRLS Gauss-Newton with step halving;
* :func:`preprocess_fft_batch` — mask, infill, continuum-normalize,
  resample onto the CCF log-lambda grid and rFFT a whole stacked arm
  on the tensors' device;
* :func:`masked_median`.

The spline design matrix, bin layout and resampling gather are host
float64 precomputes of the shared wavelength grid.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.interpolate
import torch

from rvspecfit_torch.device import dtype_for, resolve_device


def spline_nodes(lam, splinestep):
    """Continuum node positions + bin edges (log-spaced every
    ``splinestep`` km/s)."""
    lammin = float(np.min(lam))
    logstep = np.log(1 + splinestep / 3e5)
    n = int(np.ceil(np.log(np.max(lam) / lammin) / logstep))
    nodes = lammin * np.exp(np.arange(n) * logstep)
    edges = lammin * np.exp((-0.5 + np.arange(n + 1)) * logstep)
    return nodes, edges


@functools.lru_cache(maxsize=32)
def _design_matrix_cached(lam_key, nodes_key):
    lam = np.frombuffer(lam_key, dtype=np.float64)
    nodes = np.frombuffer(nodes_key, dtype=np.float64)
    n = len(nodes)
    phi = np.empty((len(lam), n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        phi[:, j] = scipy.interpolate.UnivariateSpline(nodes, e, s=0,
                                                       k=2)(lam)
    return phi


def spline_design_matrix(lam, nodes):
    """(npix, nnodes) matrix of the k=2 interpolating spline through
    the nodes: ``phi @ p`` is the spline of node values p at lam."""
    lam = np.ascontiguousarray(lam, np.float64)
    nodes = np.ascontiguousarray(nodes, np.float64)
    return _design_matrix_cached(lam.tobytes(), nodes.tobytes())


def _median(x):
    """Row medians of (B, n) with numpy semantics (mean of the two
    middle values; NaN if the row holds a NaN)."""
    s = torch.sort(x, dim=1).values
    n = x.shape[1]
    med = 0.5 * (s[:, (n - 1) // 2] + s[:, n // 2])
    return torch.where(torch.isnan(x).any(1), torch.nan, med)


def _nanmedian(x):
    """Row medians of (B, n) ignoring NaNs (np.nanmedian semantics)."""
    s = torch.sort(x, dim=1).values          # NaNs sort last
    cnt = (~torch.isnan(x)).sum(1, keepdim=True)
    c = torch.clamp(cnt, min=1)
    med = 0.5 * (s.gather(1, (c - 1) // 2) + s.gather(1, c // 2))[:, 0]
    return torch.where(cnt[:, 0] > 0, med, torch.nan)


def masked_median(x, good):
    """Per-row median of ``x`` over pixels where ``good`` is True.

    Non-finite values are dropped like masked pixels — +inf and -inf
    included, as in the reference (rvspecfit_tpu/ops/continuum.py:176),
    where np.nanmedian would rank them.  Rows with no good finite
    pixel give NaN.  x, good : (B, npix) tensors -> (B,).
    """
    keep = good & torch.isfinite(x)
    s = torch.sort(torch.where(keep, x, torch.inf), dim=1).values
    cnt = keep.sum(1, keepdim=True)
    c = torch.clamp(cnt, min=1)
    med = 0.5 * (s.gather(1, (c - 1) // 2) + s.gather(1, c // 2))[:, 0]
    return torch.where(cnt[:, 0] > 0, med, torch.nan)


def _irls(phi, specs, especs, p0, niter):
    """Batched soft-L1 Gauss-Newton in log-flux space.

    phi : (npix, n); specs, especs : (B, npix); p0 : (B, n).
    Minimizes sum 2(sqrt(1+r^2)-1), r = (exp(clip(phi p)) - spec)/espec,
    with IRLS weights 1/sqrt(1+r^2), a tiny Levenberg ridge and per-row
    halving over the steps (1, 1/2, 1/4).
    """
    n = phi.shape[1]
    eye = torch.eye(n, dtype=p0.dtype, device=p0.device)
    fracs = torch.tensor([1.0, 0.5, 0.25], dtype=p0.dtype,
                         device=p0.device)

    def cost_and_model(p):
        model = torch.exp(torch.clamp(p @ phi.T, -100.0, 100.0))
        r = (model - specs) / especs
        z = r * r
        return 2.0 * (torch.sqrt(1.0 + z) - 1.0).sum(-1), model, r, z

    p = p0
    cost = cost_and_model(p)[0]
    for _ in range(niter):
        _, model, r, z = cost_and_model(p)
        w = 1.0 / torch.sqrt(1.0 + z)
        a = model / especs
        nmat = (phi.T[None] * (w * a * a)[:, None, :]) @ phi
        rhs = -(w * a * r) @ phi
        ridge = 1e-10 * torch.diagonal(nmat, dim1=1, dim2=2).sum(1) / n \
            + 1e-30
        nmat = nmat + ridge[:, None, None] * eye
        step, info = torch.linalg.solve_ex(nmat, rhs)
        step = torch.where(torch.isfinite(step) & (info == 0)[:, None],
                           step, 0.0)
        costs = torch.stack([cost_and_model(p + f * step)[0]
                             for f in fracs])          # (3, B)
        ibest = torch.argmin(torch.cat([costs, cost[None]]), dim=0)
        frac = torch.where(ibest < 3, fracs[torch.clamp(ibest, max=2)],
                           0.0)
        p = p + frac[:, None] * step
        cost = torch.minimum(cost, costs.min(0).values)
    return p


def _bin_aux(lam, edges):
    """Static bin layout: (nb, maxw) pixel indices (-1 padded), the
    positions of the two middle sorted values, and empty flags."""
    which = np.searchsorted(edges, lam, side='right') - 1
    nb = len(edges) - 1
    counts = np.array([(which == b).sum() for b in range(nb)])
    binidx = np.full((nb, max(int(counts.max()), 1)), -1, np.int64)
    for b in range(nb):
        sel = np.nonzero(which == b)[0]
        binidx[b, :len(sel)] = sel
    return (binidx, np.maximum((counts - 1) // 2, 0),
            np.maximum(counts // 2, 0), counts == 0)


def _continuum(lam, cspec, cesp, ccfconf, niter):
    """Robust continuum of (B, npix) tensors on the shared host grid
    ``lam``: log binned medians as the start, then :func:`_irls`."""
    dev, dt = cspec.device, cspec.dtype
    to = lambda a, dtype=dt: torch.as_tensor(a, dtype=dtype, device=dev)
    nodes, edges = spline_nodes(lam, ccfconf['splinestep'])
    phi = to(spline_design_matrix(lam, nodes))
    binidx, bin_lo, bin_hi, bin_empty = _bin_aux(lam, edges)
    medspec = _median(cspec)
    medspec = torch.where(medspec <= 0, medspec.abs() + (medspec == 0),
                          medspec)
    binidx = to(binidx, torch.long)
    gathered = torch.where(binidx < 0, torch.inf,
                           cspec[:, torch.clamp(binidx, 0, len(lam) - 1)])
    srt = torch.sort(gathered, dim=-1).values           # (B, nb, maxw)
    take = lambda pos: srt[:, torch.arange(len(pos), device=dev),
                           to(pos, torch.long)]
    binned = torch.where(to(bin_empty, torch.bool), torch.nan,
                         0.5 * (take(bin_lo) + take(bin_hi)))
    p0 = torch.log(torch.maximum(binned, 1e-3 * medspec[:, None]))
    p0 = torch.where(torch.isfinite(p0), p0, torch.log(medspec)[:, None])
    p = _irls(phi, cspec, cesp, p0, niter)
    return torch.exp(torch.clamp(p @ phi.T, -100.0, 100.0))


def fit_continuum(lam, specs, especs, ccfconf, niter=40, device=None):
    """Robust smooth continuum of (B, npix) host spectra on one grid.

    Returns a (B, npix) float64 numpy array (the fit runs on ``device``
    in its working dtype)."""
    device = resolve_device(device)
    to = lambda a: torch.as_tensor(np.atleast_2d(np.asarray(a)),
                                   dtype=dtype_for(device), device=device)
    cont = _continuum(np.asarray(lam, np.float64), to(specs), to(especs),
                      ccfconf, niter)
    return cont.double().cpu().numpy()


def _medfilt11(specs):
    """scipy.signal.medfilt(row, 11) of every row (zero padded)."""
    pad = torch.nn.functional.pad(specs, (5, 5))
    return torch.sort(pad.unfold(1, 11, 1), dim=-1).values[..., 5]


def _infill(lam, specs, badmask):
    """Replace masked pixels by linear interpolation between the
    nearest good neighbours (edge runs take the nearest good value;
    fully masked rows keep their values, non-finite set to 1)."""
    npix = specs.shape[1]
    good = ~badmask
    cols = torch.arange(npix, device=specs.device).expand_as(specs)
    li = torch.cummax(torch.where(good, cols, -1), dim=1).values
    ri = -torch.cummax(torch.where(good, -cols, -npix).flip(1),
                       dim=1).values.flip(1)
    li_c = torch.clamp(li, 0, npix - 1)
    ri_c = torch.clamp(ri, 0, npix - 1)
    sl = specs.gather(1, li_c)
    sr = specs.gather(1, ri_c)
    ll = lam[li_c]
    lr = lam[ri_c]
    denom = lr - ll
    interp = (sl * (lr - lam) + sr * (lam - ll)) \
        / torch.where(denom == 0, 1.0, denom)
    filled = torch.where((li >= 0) & (ri <= npix - 1),
                         torch.where(denom == 0, sl, interp),
                         torch.where(li >= 0, sl, sr))
    out = torch.where(badmask, filled, specs)
    allbad = ~good.any(1, keepdim=True)
    fallback = torch.where(torch.isfinite(specs), specs, 1.0)
    return torch.where(allbad, fallback, out)


def _resample_aux(lam, ccfconf):
    """Linear resampling gather onto the CCF log-lambda grid: left
    index, right weight and in-range mask per CCF point."""
    ccf_lam = np.exp(np.linspace(ccfconf['logl0'], ccfconf['logl1'],
                                 ccfconf['npoints']))
    xind = np.searchsorted(lam, ccf_lam) - 1
    insub = (xind >= 0) & (xind <= len(lam) - 2)
    lic = np.clip(xind, 0, len(lam) - 2)
    rw = np.where(insub,
                  (ccf_lam - lam[lic]) / (lam[lic + 1] - lam[lic]), 0.0)
    return xind, rw, insub


def preprocess_batch(lam, specs, especs, badmask=None, ccfconf=None,
                     maxerr=10, niter=40, device=None):
    """Mask, infill and continuum-normalize one stacked arm on
    ``device`` and resample it onto the CCF log-lambda grid with its
    inverse variance.

    lam : (npix,); specs, especs, badmask : (B, npix) host arrays.
    Returns (proc (B, npoints), pivar (B, npoints)) tensors.
    """
    device = resolve_device(device)
    dtype = dtype_for(device)
    lam = np.asarray(lam, np.float64)
    to = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                             device=device)
    specs_t = to(np.atleast_2d(specs))
    especs_t = to(np.atleast_2d(especs))
    badmask_t = torch.zeros(specs_t.shape, dtype=torch.bool,
                            device=device) if badmask is None \
        else to(np.atleast_2d(badmask), torch.bool)
    lam_t = to(lam)
    continuum = bool(ccfconf['continuum'])
    npix = specs_t.shape[1]

    mederr = _nanmedian(especs_t)
    if continuum:
        badmask_t = badmask_t | (especs_t > maxerr * mederr[:, None]) \
            | (_medfilt11(specs_t) <= 0)
    cesp = torch.where(badmask_t, 1e9 * mederr[:, None], especs_t)
    cspec = _infill(lam_t, specs_t, badmask_t)
    if continuum:
        cont = _continuum(lam, cspec, cesp, ccfconf, niter)
    else:
        cont = torch.ones_like(cspec)
    civar = torch.where(badmask_t, 0.0, 1.0 / cesp**2)
    medv = _median(cspec)[:, None]
    cont = torch.where(medv > 0, torch.maximum(1e-2 * medv, cont),
                       torch.clamp(cont, min=1.0))
    nspec = torch.where(badmask_t, 0.0, specs_t / cont)
    civar = cont**2 * civar

    xind, rw, insub = _resample_aux(lam, ccfconf)
    lic = to(np.clip(xind, 0, npix - 1), torch.long)
    ric = to(np.clip(xind + 1, 0, npix - 1), torch.long)
    rw = to(rw)
    lw = 1.0 - rw
    insub = to(insub)
    proc = insub * (lw * nspec[:, lic] + rw * nspec[:, ric])
    liv, riv = civar[:, lic], civar[:, ric]
    pivar = insub * (liv * riv / (lw**2 * riv + rw**2 * liv
                                  + ((liv * riv) == 0)))
    return proc, pivar


def preprocess_fft_batch(lam, specs, especs, badmask=None, ccfconf=None,
                         maxerr=10, niter=40, device=None):
    """Preprocess (:func:`preprocess_batch`) and rFFT one stacked arm on
    ``device``.  Returns (sfft_conj (B, F) complex, ivfft_conj (B, F)
    complex, sse (B,), proc (B, npoints)): the conjugated rFFTs of spec*ivar
    and ivar on the CCF grid, sum(spec^2 ivar) and the preprocessed
    spectra."""
    proc, pivar = preprocess_batch(lam, specs, especs, badmask=badmask,
                                   ccfconf=ccfconf, maxerr=maxerr,
                                   niter=niter, device=device)
    sse = (proc * proc * pivar).sum(1)
    sfft = torch.fft.rfft(proc * pivar, dim=1)
    ivfft = torch.fft.rfft(pivar, dim=1)
    return (torch.conj_physical(sfft), torch.conj_physical(ivfft), sse,
            proc)
