"""CCF template bank: the bank's core, its files and the per-spectrum
preprocessing.

Counterpart of rvspecfit_tpu/pipeline/make_ccf.py.  :func:`build_bank`
makes the bank of a specs dict (as make_interpol writes it): Morton-
curve subsampling of the template set, continuum normalization on a
device (ops/continuum.fit_continuum) and resampling onto the
power-of-two log-lambda CCF grid (:func:`preprocess_model_list`), then
rfft(model) and rfft(model^2) on the host.  :func:`ccf_executor` and
:func:`main` write it as ``ccf_*.h5``, ``ccfdat_*.npz`` and
``ccfmod_*.npy`` (the names fit/ccf.get_ccf_info reads; writing needs
``h5py``).  The single-spectrum functions :func:`get_continuum`,
:func:`interp_masker` and :func:`preprocess_data` are thin wrappers
over the batched device versions in ops/continuum.py.
"""
from __future__ import annotations

import argparse
import logging
import os
import shlex
import sys

import numpy as np
import scipy.signal
import scipy.stats
import torch

from rvspecfit_torch import __version__ as git_rev
from rvspecfit_torch import serializer
from rvspecfit_torch.ops import continuum as continuum_mod
from rvspecfit_torch.ops import vsini as vsini_mod
from rvspecfit_torch.pipeline.make_interpol import SPECS_H5_NAME


def get_continuum_prefix(continuum):
    return '' if continuum else 'nocont_'


def get_ccf_info_name(setup, continuum=True):
    return 'ccf_' + get_continuum_prefix(continuum) + '%s.h5' % setup


def get_ccf_dat_name(setup, continuum=True):
    return 'ccfdat_' + get_continuum_prefix(continuum) + '%s.npz' % setup


def get_ccf_mod_name(setup, continuum=True):
    return 'ccfmod_' + get_continuum_prefix(continuum) + '%s.npy' % setup


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


def get_continuum(lam0, spec0, espec0, ccfconf=None, device=None):
    """Robust smooth continuum of one spectrum (host array): a quadratic
    spline in log-flux with nodes every ``ccfconf['splinestep']`` km/s,
    fitted with a soft-L1 loss on ``device`` (None: the CUDA card)."""
    return continuum_mod.fit_continuum(lam0, spec0, espec0, ccfconf,
                                       device=device)[0]


def interp_masker(lam, spec, badmask):
    """``spec`` with its masked pixels filled by linear interpolation
    between the nearest good neighbours (edge runs take the nearest good
    value), on the host in float64."""
    to = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a),
                                                     dtype=dt)
    return continuum_mod._infill(
        to(lam), to(np.atleast_2d(spec)),
        to(np.atleast_2d(badmask), torch.bool))[0].numpy()


def preprocess_data(lam, spec0, espec, ccfconf=None, badmask=None,
                    maxerr=10, device=None):
    """One observed spectrum masked, infilled, continuum-normalized and
    resampled onto the CCF log-lambda grid with its inverse variance,
    on ``device`` (None: the CUDA card): host (proc_spec, proc_ivar)."""
    proc, pivar = continuum_mod.preprocess_batch(
        lam, np.asarray(spec0)[None], np.asarray(espec)[None],
        badmask=None if badmask is None else np.asarray(badmask)[None],
        ccfconf=ccfconf, maxerr=maxerr, device=device)
    return proc[0].double().cpu().numpy(), pivar[0].double().cpu().numpy()


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


def build_bank(d, ccfconf, every=10, vsinis=None, device=None):
    """The CCF bank of the specs dict ``d`` (vec (ndim, nspec) raw
    parameters, specs (nspec, npix) logged where ``log_spec``, lam,
    parnames): every ``every``-th template in Morton order of its
    parameters, times each of ``vsinis``, with the continua fitted on
    ``device`` (None: the CUDA card).  Returns (models (T, npoints),
    ffts, fft2s (T, npoints // 2 + 1) complex, info), host arrays."""
    vec, specs = np.asarray(d['vec']), np.asarray(d['specs'])
    if d.get('log_spec', True):
        specs = np.exp(specs)
    inds = np.argsort(get_mortoncurve_id(vec.T))[::every]
    models, params, vsinis_list = preprocess_model_list(
        d['lam'], specs[inds], vec.T[inds], ccfconf, vsinis=vsinis,
        device=device)
    info = dict(params=params, ccfconf=ccfconf,
                vsinis=[-1.0 if v is None else float(v)
                        for v in vsinis_list],
                vsini_is_none=[v is None for v in vsinis_list],
                parnames=[str(p) for p in d['parnames']])
    return (models, np.fft.rfft(models, axis=1),
            np.fft.rfft(models**2, axis=1), info)


def ccf_executor(spec_setup, ccfconf, prefix=None, oprefix=None, every=10,
                 vsinis=None, revision='', cmdline='', device=None):
    """Build (:func:`build_bank`, continua on ``device``, None: the CUDA
    card) and write the CCF files of one setup from
    ``prefix/specs_{setup}.h5`` into ``oprefix``."""
    d = serializer.load_dict_from_hdf5(
        os.path.join(prefix, SPECS_H5_NAME % spec_setup))
    models, ffts, fft2s, info = build_bank(d, ccfconf, every=every,
                                           vsinis=vsinis, device=device)
    info.update(revision=revision, cmdline=cmdline, git_rev=git_rev)
    cont = ccfconf['continuum']
    os.makedirs(oprefix, exist_ok=True)
    serializer.save_dict_to_hdf5(
        os.path.join(oprefix, get_ccf_info_name(spec_setup, cont)), info)
    np.savez(os.path.join(oprefix, get_ccf_dat_name(spec_setup, cont)),
             fft=ffts, fft2=fft2s)
    np.save(os.path.join(oprefix, get_ccf_mod_name(spec_setup, cont)),
            models)
    logging.info('wrote %d CCF templates for %s', len(models), spec_setup)


def main(args=None):
    if args is None:
        args = sys.argv[1:]
    cmdline = shlex.join(['rvstorch_make_ccf'] + list(args))
    parser = argparse.ArgumentParser(
        description='Create Fourier-transformed CCF templates')
    parser.add_argument('--prefix', type=str, required=True)
    parser.add_argument('--oprefix', type=str, default='templ_data/')
    parser.add_argument('--setup', type=str, required=True)
    parser.add_argument('--lambda0', type=float, required=True)
    parser.add_argument('--lambda1', type=float, required=True)
    parser.add_argument('--step', type=float, required=True)
    parser.add_argument('--nocontinuum', action='store_true',
                        default=False)
    parser.add_argument('--revision', type=str, default='')
    parser.add_argument('--vsinis', type=str, default=None,
                        help='comma-separated vsini values')
    parser.add_argument('--every', type=int, default=30)
    parser.add_argument('--cpu', action='store_true', default=False,
                        help='fit the continua on the CPU (default: the '
                        'CUDA card)')
    args = parser.parse_args(args)

    npoints = to_power_two(int((args.lambda1 - args.lambda0) / args.step))
    ccfconf = get_ccf_config(
        logl0=np.log(args.lambda0), logl1=np.log(args.lambda1),
        npoints=npoints,
        splinestep=None if args.nocontinuum else 1000)
    vsinis = None
    if args.vsinis is not None:
        vsinis = [float(x) for x in args.vsinis.split(',')]
    ccf_executor(args.setup, ccfconf, args.prefix, args.oprefix,
                 args.every, vsinis, revision=args.revision,
                 cmdline=cmdline, device='cpu' if args.cpu else None)


if __name__ == '__main__':
    main()
