"""Batched FFT cross-correlation first guess.

Counterpart of the batched path of rvspecfit_tpu/fit/ccf.py.  Per arm,
the exposure is preprocessed and rFFT'd on the device
(ops/continuum.preprocess_fft_batch) and every (fiber, template,
velocity) chi-square

    continuum:     -2 C0 + C1        no continuum:  -C0^2 / C1

is computed by kernel B (ops/ccf_chisq.py), with C0/C1 the circular
cross-correlations of the bank rFFTs with the spectrum/ivar rFFTs
evaluated directly at the velocity grid's fractional lags through two
(F, V) DFT matrices.  Arm contributions are summed; each fiber's best
template and parabola-refined velocity come back to the host.  A
kernel failure raises: there is no fallback path.  The banks come from
the caller or, through :func:`get_ccf_info`, from make_ccf's files.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from rvspecfit_torch import serializer
from rvspecfit_torch.device import complex_dtype_for, resolve_device
from rvspecfit_torch.ops import ccf_chisq
from rvspecfit_torch.ops import continuum as continuum_mod
from rvspecfit_torch.pipeline import make_ccf


def get_ccf_info(spec_setup, config, device=None):
    """One setup's CCF bank from make_ccf's files in
    ``config['template_lib']``: (tfft, t2fft, models, info) with complex
    (T, F) rFFT tensors on ``device`` (None: the CUDA card), the host
    (T, npoints) template models (memory-mapped) and the info dict."""
    lib = config['template_lib']
    continuum = config.get('ccf_continuum_normalize')
    if continuum is None:
        continuum = True
    device = resolve_device(device)
    info = serializer.load_dict_from_hdf5(os.path.join(
        lib, make_ccf.get_ccf_info_name(spec_setup, continuum)))
    mods = np.load(os.path.join(
        lib, make_ccf.get_ccf_mod_name(spec_setup, continuum)),
        mmap_mode='r')
    to = lambda c: torch.as_tensor(c, dtype=complex_dtype_for(device),
                                   device=device)
    with np.load(os.path.join(
            lib, make_ccf.get_ccf_dat_name(spec_setup, continuum))) as dat:
        return to(dat['fft']), to(dat['fft2']), mods, info


@functools.lru_cache(maxsize=32)
def _dft_mats_host(npoints, logl0, logl1, vel_key):
    vel_grid = np.asarray(vel_key, np.float64)
    step = (np.exp((logl1 - logl0) / npoints) - 1) * 3e5
    lags = -vel_grid / step
    k = np.arange(npoints // 2 + 1, dtype=np.float64)
    ang = (2.0 * np.pi / npoints) * np.outer(k, lags)
    wk = np.full(len(k), 2.0)
    wk[0] = 1.0
    if npoints % 2 == 0:
        wk[-1] = 1.0
    return wk[:, None] * np.cos(ang) / npoints, \
        wk[:, None] * np.sin(ang) / npoints


def dft_mats(ccfconf, vel_grid, device, dtype):
    """(F, V) cos/sin matrices evaluating the circular correlation at
    the fractional lags of ``vel_grid`` (velocity v <-> lag -v/step;
    irfft normalization and Hermitian doubling folded in)."""
    ecos, esin = _dft_mats_host(
        int(ccfconf['npoints']), float(ccfconf['logl0']),
        float(ccfconf['logl1']),
        tuple(np.asarray(vel_grid, np.float64).tolist()))
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return to(ecos), to(esin)


def vel_axis(ccfconf, npoints_spec, maxvel):
    """Velocity bookkeeping of the circular CCF: indices into the irfft
    axis ordered from negative to positive velocity, their velocities,
    and the velocity step."""
    logl0, logl1 = ccfconf['logl0'], ccfconf['logl1']
    step = (np.exp((logl1 - logl0) / ccfconf['npoints']) - 1) * 3e5
    off = npoints_spec // 2
    vels = -((np.arange(npoints_spec) + off) % npoints_spec - off) * step
    ind = np.abs(vels) < (maxvel + step)
    if ind.sum() % 2 != 1:
        raise RuntimeError('CCF velocity window must be odd')
    ind = np.roll(np.nonzero(ind)[0], ind.sum() // 2)[::-1]
    sub = vels[ind]
    if not np.all(np.diff(sub) > 0):
        raise RuntimeError('Invalid CCF velocity grid')
    return ind, sub, step


def ccf_reduce(chis, vel_grid):
    """Per-fiber best template and parabola-refined velocity.

    chis : (B, T, V) summed arm contributions on a uniform vel_grid (V,).
    Returns (best_id, best_vel, best_chi, best_row (B, V)).
    """
    nvel = chis.shape[2]
    tid = torch.argmin(chis.amin(2), dim=1)
    row = chis[torch.arange(chis.shape[0], device=chis.device), tid]
    pix = torch.argmin(row, dim=1)
    pixc = torch.clamp(pix, 1, nvel - 2)
    take = lambda i: row.gather(1, i[:, None])[:, 0]
    y0, y1, y2 = take(pixc - 1), take(pixc), take(pixc + 1)
    a2 = y0 - 2 * y1 + y2
    dv = vel_grid[1] - vel_grid[0]
    refined = vel_grid[pixc] + torch.where(
        a2 > 0, 0.5 * (y0 - y2) / a2 * dv, 0.0)
    interior = (pix > 0) & (pix < nvel - 1)
    best_vel = torch.where(interior, refined, vel_grid[pix])
    return tid, best_vel, take(pix), row


def prepare_arm_batch(setup, lam, fluxes, especs, badmask, config, bank):
    """Preprocess + rFFT one stacked arm on the bank's device and build
    its DFT matrices.  ``bank`` is (tfft, t2fft, info) with complex
    (T, F) tensors (see convert.ccf_bank)."""
    tfft, t2fft, info = bank
    device = tfft.device
    ccfconf = info['ccfconf']
    maxvel = config.get('max_vel') or 1000
    sfft_conj, ivfft_conj, sse = continuum_mod.preprocess_fft_batch(
        lam, np.atleast_2d(fluxes), np.atleast_2d(especs), badmask=badmask,
        ccfconf=ccfconf, device=device)
    nvelgrid = 2 * int(maxvel / (config.get('vel_step0') or 2)) + 1
    vel_grid = np.linspace(-maxvel, maxvel, nvelgrid)
    ecos, esin = dft_mats(ccfconf, vel_grid, device, sse.dtype)
    return dict(setup=setup, info=info, tfft=tfft, t2fft=t2fft,
                sfft_conj=sfft_conj, ivfft_conj=ivfft_conj, sse=sse,
                vel_grid=vel_grid, ecos=ecos, esin=esin,
                continuum=bool(ccfconf['continuum']))


def fit_batch(arm_batches, config, banks=None, device=None):
    """Fiber-batched CCF of a stacked exposure.

    arm_batches : list of (setup, lam (npix,), fluxes (B, npix),
        especs (B, npix), badmask (B, npix) bool or None)
    banks : {setup: (tfft, t2fft, info)} device-resident template
        banks, or None to load them from ``config['template_lib']``
        onto ``device`` (None: the CUDA card)
    Returns dict with parnames, best_params (B, ndim), best_vel (B,),
    best_vsini (B,; NaN where the template had no rotation), best_id
    (B,), best_chi (B,), vel_grid — host arrays.
    """
    if banks is None:
        banks = {}
        for s, *_ in arm_batches:
            tfft, t2fft, _, info = get_ccf_info(s, config, device)
            banks[s] = (tfft, t2fft, info)
    prep = [prepare_arm_batch(s, lam, fl, er, bm, config, banks[s])
            for s, lam, fl, er, bm in arm_batches]
    info0 = prep[0]['info']
    for p in prep[1:]:
        cur = p['info']
        if (list(info0['parnames']) != list(cur['parnames'])
                or not np.array_equal(info0['params'], cur['params'])
                or not np.array_equal(info0['vsinis'], cur['vsinis'])):
            raise RuntimeError('CCF template parameters differ between '
                               'setups')
    total = None
    total_sse = None
    for p in prep:
        cur = ccf_chisq.ccf_chisq(p['tfft'], p['t2fft'], p['sfft_conj'],
                                  p['ivfft_conj'], p['ecos'], p['esin'],
                                  continuum=p['continuum'])
        total = cur if total is None else total + cur
        total_sse = p['sse'] if total_sse is None else total_sse + p['sse']
    vel_grid = prep[0]['vel_grid']
    tid, bvel, bchi, _ = ccf_reduce(
        total, torch.as_tensor(vel_grid, dtype=total.dtype,
                               device=total.device))
    best_id = tid.cpu().numpy()
    best_chi = (bchi + total_sse).double().cpu().numpy()
    params = np.asarray(info0['params'])[best_id]
    vsinis = np.asarray(info0['vsinis'], np.float64)[best_id]
    if info0.get('vsini_is_none') is not None:
        vsinis = np.where(np.asarray(info0['vsini_is_none'],
                                     bool)[best_id], np.nan, vsinis)
    return dict(parnames=[str(p) for p in info0['parnames']],
                best_params=params,
                best_vel=bvel.double().cpu().numpy(),
                best_vsini=vsinis, best_id=best_id, best_chi=best_chi,
                vel_grid=vel_grid)
