"""CCF template-bank core (offline, host).

Counterpart of the bank-building core of
rvspecfit_tpu/pipeline/make_ccf.py: Morton-curve subsampling of the
template set, continuum normalization (ops/continuum.fit_continuum)
and resampling onto the power-of-two log-lambda CCF grid.  Reading and
writing the on-disk artifacts is not ported yet.
"""
from __future__ import annotations

import numpy as np
import scipy.signal
import scipy.stats
import torch

from rvspecfit_torch.ops import continuum as continuum_mod
from rvspecfit_torch.ops import vsini as vsini_mod


def interleave_bits(x):
    """(nsamp, ndim) values in [0, 1] -> Morton (Z-order) integers."""
    x = np.asarray(x)
    if x.min() < 0 or x.max() > 1:
        raise ValueError('values must be within [0, 1]')
    nsamp, ndim = x.shape
    max_bits = 64 // ndim
    maxv = 2**max_bits
    xi = np.minimum((x * maxv).astype(np.int64), maxv - 1)
    out = np.zeros(nsamp, dtype=np.int64)
    for bit in range(max_bits):
        for i in range(ndim):
            out += ((xi[:, i] >> bit) & 1) << (bit * ndim + i)
    return out


def get_mortoncurve_id(x):
    """Rank-normalize each parameter column, then Morton-encode (sorted
    ids subsample the parameter space uniformly)."""
    xr = np.array([scipy.stats.rankdata(col, method='dense') - 1
                   for col in np.asarray(x).T]).T
    return interleave_bits(xr / np.maximum(xr.max(axis=0), 1))


def get_ccf_config(logl0=None, logl1=None, npoints=None, splinestep=1000,
                   maxcontpts=20):
    """CCF configuration dict; ``splinestep=None`` disables the
    continuum normalization."""
    ret = dict(logl0=logl0, logl1=logl1, npoints=npoints, continuum=True,
               maxcontpts=maxcontpts)
    if splinestep is None:
        ret['continuum'] = False
    else:
        ret['splinestep'] = max(
            splinestep, 3e5 * (np.exp((logl1 - logl0) / maxcontpts) - 1))
    return ret


def to_power_two(i):
    return 2**int(np.ceil(np.log2(i)))


def preprocess_model_list(lammodels, models, params, ccfconf, vsinis=None,
                          chunk=256, device=None):
    """Continuum-normalize (and optionally rotation-broaden) every
    template and resample it onto the CCF log-lambda grid.

    lammodels (npixt,) log-uniform; models (M, npixt); params (M, ndim).
    Returns (resampled (M * nvsini, npoints), params, vsinis list).
    """
    logl = np.linspace(ccfconf['logl0'], ccfconf['logl1'],
                       ccfconf['npoints'])
    lammodels = np.asarray(lammodels, np.float64)
    models = np.asarray(models, np.float64)
    if vsinis is None:
        vsinis = [None]
    blocks, retparams, retvsinis = [], [], []
    lnstep = np.log(lammodels[1] / lammodels[0])
    for vsini in vsinis:
        if vsini is not None and vsini != 0:
            hw = vsini_mod.kernel_half_width(float(vsini), lnstep)
            kern = vsini_mod.rotation_kernel(
                torch.tensor([float(vsini)], dtype=torch.float64),
                lnstep, hw).numpy()
            blk = scipy.signal.fftconvolve(models, kern, mode='same',
                                           axes=1)
        else:
            blk = models
        blocks.append(blk)
        retparams.extend(list(params))
        retvsinis.extend([vsini] * len(models))
    big = np.concatenate(blocks, axis=0)

    if ccfconf['continuum']:
        med = np.median(big, axis=1)
        espec = np.maximum(big * 1e-5, 1e-2 * med[:, None])
        cont = np.concatenate([
            continuum_mod.fit_continuum(lammodels, big[i0:i0 + chunk],
                                        espec[i0:i0 + chunk], ccfconf,
                                        device=device)
            for i0 in range(0, len(big), chunk)], axis=0)
        cont = np.maximum(cont, 1e-2 * np.median(cont, axis=1)[:, None])
        big = big / cont

    loglam = np.log(lammodels)
    pos = np.searchsorted(loglam, logl) - 1
    ins = (pos >= 0) & (pos <= len(loglam) - 2)
    out = np.ones((len(big), len(logl)))
    li = pos[ins]
    w = (logl[ins] - loglam[li]) / (loglam[li + 1] - loglam[li])
    out[:, ins] = big[:, li] * (1 - w)[None, :] + big[:, li + 1] * w[None, :]
    return out, np.array(retparams), retvsinis
