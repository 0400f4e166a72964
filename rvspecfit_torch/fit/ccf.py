"""FFT cross-correlation first guess, batched and single-object.

Counterpart of rvspecfit_tpu/fit/ccf.py (``fit_batch`` and ``fit``).  Per arm,
the exposure is preprocessed and rFFT'd on the device
(ops/continuum.preprocess_fft_batch) and every (fiber, template,
velocity) chi-square

    continuum:     -2 C0 + C1        no continuum:  -C0^2 / C1

is computed by kernel B (ops/ccf_chisq.py), with C0/C1 the circular
cross-correlations of the bank rFFTs with the spectrum/ivar rFFTs
evaluated directly at the velocity grid's fractional lags through two
(F, V) DFT matrices.  Arm contributions are summed; each fiber's best
template and parabola-refined velocity come back to the host.  The
DFT matrices on the device are built once per velocity grid, and
kernel B keeps its layouts of them and of the bank while the bank
lives.  A kernel failure raises: there is no fallback path.  The banks
come from the caller or, through :func:`get_ccf_info`, from make_ccf's
files.
:func:`fit_batch_async` dispatches the batched CCF on the calling
thread's stream and returns a ``collect`` closure (:func:`fit_batch`
calls it at once).
:func:`fit` is the single-object form: the same chi-squares and
reduction at one fiber row (kernel B at B = 1).
"""
from __future__ import annotations

import contextlib
import functools
import logging
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
    (T, npoints) template models (memory-mapped) and the info dict.
    Loaded once per library, setup, mode and device."""
    continuum = config.get('ccf_continuum_normalize')
    if continuum is None:
        continuum = True
    return _load_ccf_info(os.path.abspath(config['template_lib']),
                          spec_setup, bool(continuum),
                          str(resolve_device(device)))


@functools.lru_cache(maxsize=16)
def _load_ccf_info(lib, spec_setup, continuum, device):
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


def _dft_key(ccfconf, vel_grid):
    return (int(ccfconf['npoints']), float(ccfconf['logl0']),
            float(ccfconf['logl1']),
            tuple(np.asarray(vel_grid, np.float64).tolist()))


def dft_mats(ccfconf, vel_grid, device, dtype):
    """(F, V) cos/sin matrices evaluating the circular correlation at
    the fractional lags of ``vel_grid`` (velocity v <-> lag -v/step;
    irfft normalization and Hermitian doubling folded in).  Made once
    per grid, device and dtype: callers share the tensors and do not
    write to them."""
    return _dft_mats_device(*_dft_key(ccfconf, vel_grid),
                            str(torch.device(device)), dtype)


@functools.lru_cache(maxsize=16)
def _dft_mats_device(npoints, logl0, logl1, vel_key, device, dtype):
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return tuple(map(to, _dft_mats_host(npoints, logl0, logl1, vel_key)))


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


def check_same_templates(ref, info):
    """Raise unless two setups' banks hold the same templates."""
    if (list(ref['parnames']) != list(info['parnames'])
            or not np.array_equal(ref['params'], info['params'])
            or not np.array_equal(ref['vsinis'], info['vsinis'])):
        raise RuntimeError('CCF template parameters differ between '
                           'setups')


def prepare_arm_batch(setup, lam, fluxes, especs, badmask, config, bank):
    """Preprocess + rFFT one stacked arm on the bank's device, in the
    bank's precision, and take its DFT matrices (made once per grid).
    ``bank`` is (tfft, t2fft, info) with complex (T, F) tensors (see
    convert.ccf_bank)."""
    tfft, t2fft, info = bank
    device = tfft.device
    ccfconf = info['ccfconf']
    maxvel = config.get('max_vel') or 1000
    sfft_conj, ivfft_conj, sse, proc = continuum_mod.preprocess_fft_batch(
        lam, np.atleast_2d(fluxes), np.atleast_2d(especs), badmask=badmask,
        ccfconf=ccfconf, device=device, dtype=tfft.real.dtype)
    nvelgrid = 2 * int(maxvel / (config.get('vel_step0') or 2)) + 1
    vel_grid = np.linspace(-maxvel, maxvel, nvelgrid)
    ecos, esin = dft_mats(ccfconf, vel_grid, device, sse.dtype)
    if device.type == 'cuda' and not torch.cuda.is_current_stream_capturing():
        # the matrices are shared by every thread's stream: keep their
        # memory from being reused while this stream may read them
        stream = torch.cuda.current_stream(device)
        ecos.record_stream(stream)
        esin.record_stream(stream)
    return dict(setup=setup, info=info, tfft=tfft, t2fft=t2fft,
                sfft_conj=sfft_conj, ivfft_conj=ivfft_conj, sse=sse,
                proc=proc, vel_grid=vel_grid, ecos=ecos, esin=esin,
                continuum=bool(ccfconf['continuum']))


def _load_banks(setups, config, device):
    """{setup: (tfft, t2fft, info)} and {setup: host template models}
    from ``config['template_lib']``."""
    banks, mods = {}, {}
    for s in setups:
        tfft, t2fft, mods[s], info = get_ccf_info(s, config, device)
        banks[s] = (tfft, t2fft, info)
    return banks, mods


def _reduce_arms(prep):
    """Sum the prepared arms' kernel-B chi-squares and reduce them
    (:func:`ccf_reduce`): (best_id, best_vel, best_chi, best_row (B, V),
    sse (B,)), best_chi and best_row without sse."""
    for p in prep[1:]:
        check_same_templates(prep[0]['info'], p['info'])
    total = total_sse = None
    for p in prep:
        cur = ccf_chisq.ccf_chisq(p['tfft'], p['t2fft'], p['sfft_conj'],
                                  p['ivfft_conj'], p['ecos'], p['esin'],
                                  continuum=p['continuum'])
        total = cur if total is None else total + cur
        total_sse = p['sse'] if total_sse is None else total_sse + p['sse']
    return ccf_reduce(total, torch.as_tensor(
        prep[0]['vel_grid'], dtype=total.dtype, device=total.device)) + (
            total_sse,)


def fit_batch_async(arm_batches, config, banks=None, device=None):
    """:func:`fit_batch` without waiting for the card: the host prep
    and every kernel B launch are enqueued on the calling thread's
    current stream, and ``collect()`` returns fit_batch's dict.

    ``collect`` waits for an event recorded after the reduction and
    fetches the results on the same stream, so a thread may dispatch
    the CCF of the next group on a stream of its own while another
    fits (survey/desi.proc_many's prep pipeline).  A failure of the
    host prep or of a launch raises here; ``collect`` raises what the
    fetch raises.  Nothing is swallowed: there is no fallback start.
    """
    if banks is None:
        banks, _ = _load_banks([a[0] for a in arm_batches], config, device)
    prep = [prepare_arm_batch(s, lam, fl, er, bm, config, banks[s])
            for s, lam, fl, er, bm in arm_batches]
    tid, bvel, bchi, _, sse = _reduce_arms(prep)
    bchi = bchi + sse
    info0, vel_grid = prep[0]['info'], prep[0]['vel_grid']
    stream = event = None
    if tid.device.type == 'cuda':
        stream = torch.cuda.current_stream(tid.device)
        event = torch.cuda.Event()
        event.record(stream)

    def collect():
        if event is not None:
            event.synchronize()
        with contextlib.nullcontext() if stream is None \
                else torch.cuda.stream(stream):
            best_id = tid.cpu().numpy()
            best_vel = bvel.double().cpu().numpy()
            best_chi = bchi.double().cpu().numpy()
        vsinis = np.asarray(info0['vsinis'], np.float64)[best_id]
        if info0.get('vsini_is_none') is not None:
            vsinis = np.where(np.asarray(info0['vsini_is_none'],
                                         bool)[best_id], np.nan, vsinis)
        return dict(parnames=[str(p) for p in info0['parnames']],
                    best_params=np.asarray(info0['params'])[best_id],
                    best_vel=best_vel, best_vsini=vsinis, best_id=best_id,
                    best_chi=best_chi, vel_grid=vel_grid)

    return collect


def fit_batch(arm_batches, config, banks=None, device=None):
    """Fiber-batched CCF of a stacked exposure
    (``fit_batch_async(...)()``).

    arm_batches : list of (setup, lam (npix,), fluxes (B, npix),
        especs (B, npix), badmask (B, npix) bool or None)
    banks : {setup: (tfft, t2fft, info)} device-resident template
        banks, or None to load them from ``config['template_lib']``
        onto ``device`` (None: the CUDA card)
    Returns dict with parnames, best_params (B, ndim), best_vel (B,),
    best_vsini (B,; NaN where the template had no rotation), best_id
    (B,), best_chi (B,), vel_grid — host arrays.
    """
    return fit_batch_async(arm_batches, config, banks=banks,
                           device=device)()


def fit(specdata, config, banks=None, device=None):
    """Cross-correlate one object's datasets against the template bank:
    :func:`fit_batch`'s chi-squares and reduction at one fiber row
    (kernel B at B = 1).

    specdata : SpecData or list of them (name = setup); banks : optional
    {setup: (tfft, t2fft, info)} in-memory banks, whose template models
    are the inverse rFFTs of tfft, else loaded with their models from
    the library onto ``device`` (None: the CUDA card).

    Returns dict of best_par, best_vel, best_ccf (V,), best_vsini (None
    for a template without rotation), best_model {setup: (npoints,)},
    proc_spec {setup: (npoints,)} and vel_grid.  Raises where the best
    chi-square is not finite or the setups' banks differ.
    """
    if not isinstance(specdata, (list, tuple)):
        specdata = [specdata]
    mods = {}
    if banks is None:
        banks, mods = _load_banks([sd.name for sd in specdata], config,
                                  device)
    prep = [prepare_arm_batch(sd.name, sd.lam, sd.spec, sd.espec,
                              sd.badmask[None], config, banks[sd.name])
            for sd in specdata]
    tid, bvel, bchi, row, sse = _reduce_arms(prep)
    if not np.isfinite(float(bchi[0] + sse[0])):
        logging.error('Cross-correlation failed')
        raise RuntimeError('Cross-correlation step failed')
    best_id, best_vel = int(tid[0]), float(bvel[0])
    best_model = {}
    for p in prep:
        ccfconf = p['info']['ccfconf']
        npoints = int(ccfconf['npoints'])
        model = np.asarray(mods[p['setup']][best_id]) if mods else \
            np.fft.irfft(p['tfft'][best_id].cpu().numpy(), n=npoints)
        velstep = (np.exp((ccfconf['logl1'] - ccfconf['logl0'])
                          / npoints) - 1) * 3e5
        best_model[p['setup']] = np.roll(model, int(best_vel / velstep))
    info0 = prep[0]['info']
    vsini = float(np.asarray(info0['vsinis'])[best_id])
    if info0.get('vsini_is_none') is not None and \
            bool(np.asarray(info0['vsini_is_none'])[best_id]):
        vsini = None
    return dict(best_par=dict(zip([str(p) for p in info0['parnames']],
                                  np.asarray(info0['params'])[best_id])),
                best_vel=best_vel,
                best_ccf=(row[0].double() + sse[0].double()).cpu().numpy(),
                best_vsini=vsini,
                best_model=best_model,
                proc_spec={p['setup']: p['proc'][0].double().cpu().numpy()
                           for p in prep},
                vel_grid=prep[0]['vel_grid'])
