"""Template grid processing: convolve + rebin + normalize + log
(offline, host).

The port's own copy of rvspecfit_tpu/pipeline/make_interpol.py: for
every good template in the database, convert to photon units, apply
the LSF rebinner matrix (pipeline/read_grid.py) onto the target
(linear or log) wavelength grid, normalize, take the log, and store
everything in ``specs_{setup}.h5``.  :func:`build_specs` returns the
dict that :func:`process_all` writes (writing needs ``h5py``).

``nthreads > 1`` processes the templates in a ``spawn`` process pool
whose initializer hands each worker the shared sparse rebinner; the
per-template work is host-side sparse algebra.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import logging
import multiprocessing as mp
import os
import shlex
import sqlite3
import sys

import numpy as np
import scipy.constants

from rvspecfit_torch import __version__ as git_rev
from rvspecfit_torch import serializer
from rvspecfit_torch.pipeline import read_grid

SPECS_H5_NAME = 'specs_%s.h5'

_worker_cache = {}


def _init_worker(mat, lamgrid):
    _worker_cache['mat'] = mat
    _worker_cache['lamgrid'] = lamgrid


def get_line_continuum(lam, spec):
    """Two-point log-linear continuum through per-half medians."""
    npix = len(lam)
    half = npix // 2
    lam1, lam2 = np.median(lam[:half]), np.median(lam[half:])
    sp1, sp2 = np.median(spec[:half]), np.median(spec[half:])
    sp1 = max(sp1, 1e-300)
    sp2 = max(sp2, 1e-300)
    slope = (np.log(sp2) - np.log(sp1)) / (lam2 - lam1)
    return np.exp(np.log(sp1) + slope * (lam - lam1))


def extract_spectrum(param, dbfile, prefix, wavefile,
                     normalize='linear_continuum', log_spec=True):
    """Load one template, LSF-convolve and rebin it (in photon units)
    with the worker's rebinner, normalize and log it: (spectrum,
    log of the normalization)."""
    valid = ('none', 'median', 'linear_continuum')
    if normalize not in valid:
        raise ValueError(f'normalize must be one of {valid}')
    mat = _worker_cache['mat']
    lamgrid = _worker_cache['lamgrid']
    lam, spec0 = read_grid.get_spec(param, dbfile=dbfile, prefix=prefix,
                                    wavefile=wavefile)
    # energy -> photon units before convolution, back after
    spec1 = read_grid.apply_rebinner(mat, spec0 * lam) / lamgrid
    if normalize == 'linear_continuum':
        spec2 = spec1 / get_line_continuum(lamgrid, spec1)
        lognorm = 0.0
    elif normalize == 'median':
        norm = np.median(spec1)
        spec2 = spec1 / norm
        lognorm = np.log(norm)
    else:
        spec2 = spec1
        lognorm = 0.0
    if log_spec:
        spec2 = np.log(spec2)
    if not np.isfinite(spec2).all():
        raise RuntimeError(f'Non-finite prepared spectrum at {param}')
    return spec2, lognorm


class Resolution:
    """Constant resolution, or a string expression of wavelength ``x``
    (numpy as ``np``), e.g. ``x/1.55``."""

    def __init__(self, resol=None, resol_func=None):
        if (resol is None) == (resol_func is None):
            raise ValueError('specify exactly one of resol/resol_func')
        self.resol = resol
        self.resol_func = resol_func

    def __call__(self, x):
        if self.resol is not None:
            return self.resol + 0.0 * np.asarray(x)
        return eval(self.resol_func, dict(x=x, np=np))  # noqa: S307


def fetch_all_parameters(dbfile, parnames):
    """(params (ndim, n), ids (n,)) of every good template, ordered by
    the parameters; the database's ``grid_parameters`` table must name
    as many parameters (an old database without it only warns)."""
    if not os.path.exists(dbfile):
        raise RuntimeError(f'Template database {dbfile} does not exist')
    parstr = ','.join(parnames)
    with sqlite3.connect(dbfile) as conn:
        has_meta = conn.execute(
            "select count(*) from sqlite_schema where type='table' and "
            "name='grid_parameters'").fetchone()[0] == 1
        if has_meta:
            nparam = conn.execute(
                'select count(*) from grid_parameters').fetchone()[0]
            if nparam != len(parnames):
                raise RuntimeError(
                    f'Database has {nparam} grid parameters, you '
                    f'specified {len(parnames)}')
        else:
            logging.warning('Old-format database without grid_parameters')
        rows = conn.execute(
            f'select id, {parstr} from files where not bad '
            f'order by {parstr}').fetchall()
    arr = np.array(rows, dtype=np.float64)
    return arr[:, 1:].T, arr[:, 0].astype(int)


def make_output_grid(lamleft, lamright, step, log_step, deltav=1000.0):
    """Target wavelength grid, padded by ``deltav`` km/s at each end."""
    fac1 = 1 + deltav / (scipy.constants.speed_of_light / 1e3)
    if not log_step:
        return np.arange(lamleft / fac1, (lamright + step) * fac1, step)
    log_step_val = np.log(1 + step / (0.5 * (lamleft + lamright)))
    return np.exp(np.arange(np.log(lamleft / fac1),
                            np.log(lamright * fac1), log_step_val))


def build_specs(setupInfo, parnames=('teff', 'logg', 'feh', 'alpha'),
                dbfile='files.db', prefix=None, wavefile=None, air=False,
                resolution0=None, normalize='linear_continuum',
                float_bits=32, revision='', cmdline='', nthreads=1,
                log_parameters=(0,)):
    """The whole library processed: the dict :func:`process_all` writes
    to ``specs_{setup}.h5`` (specs (nspec, npix) in float32 or float64
    by ``float_bits``, vec (ndim, nspec), lam, ...).

    setupInfo : (setup, lamleft, lamright, resolution function of
    wavelength, step, log_step)."""
    setup, lamleft, lamright, resol_func, step, log_step = setupInfo
    vec, file_ids = fetch_all_parameters(dbfile, parnames)
    nspec = vec.shape[1]

    par0 = dict(zip(parnames, vec.T[0]))
    templ_lam, _ = read_grid.get_spec(par0, dbfile=dbfile, prefix=prefix,
                                      wavefile=wavefile)
    if templ_lam.min() > lamleft or templ_lam.max() < lamright:
        raise RuntimeError(
            f'Input library wavelengths [{templ_lam.min()}, '
            f'{templ_lam.max()}] do not cover [{lamleft}, {lamright}]')

    lamgrid = make_output_grid(lamleft, lamright, step, log_step)
    if len(lamgrid) <= 1:
        raise RuntimeError('Bad wavelength range or step')
    mat = read_grid.make_rebinner(templ_lam, lamgrid, resol_func,
                                  toair=air, resolution0=resolution0)

    specs = np.zeros((nspec, len(lamgrid)),
                     dtype=np.float32 if float_bits == 32 else np.float64)
    lognorms = np.zeros(nspec)
    params = [dict(zip(parnames, v)) for v in vec.T]
    if nthreads > 1:
        ctx = mp.get_context('spawn')
        with cf.ProcessPoolExecutor(
                nthreads, mp_context=ctx, initializer=_init_worker,
                initargs=(mat, lamgrid)) as pool:
            futs = [pool.submit(extract_spectrum, p, dbfile, prefix,
                                wavefile, normalize=normalize)
                    for p in params]
            for i, fut in enumerate(futs):
                specs[i], lognorms[i] = fut.result()
                if i % max(1, nspec // 20) == 0:
                    logging.info('processed %d/%d templates', i, nspec)
    else:
        _init_worker(mat, lamgrid)
        for i, p in enumerate(params):
            specs[i], lognorms[i] = extract_spectrum(
                p, dbfile, prefix, wavefile, normalize=normalize)
            if i % max(1, nspec // 20) == 0:
                logging.info('processed %d/%d templates', i, nspec)

    return dict(specs=specs, vec=vec, lam=lamgrid, parnames=list(parnames),
                git_rev=git_rev, mapper_class='LogMapper',
                log_ids=list(log_parameters or ()), revision=revision,
                cmdline=cmdline, lognorms=lognorms, log_step=bool(log_step),
                log_spec=True, file_ids=file_ids, dbfile=dbfile)


def process_all(setupInfo, parnames=('teff', 'logg', 'feh', 'alpha'),
                dbfile='files.db', oprefix='templ_data/', prefix=None,
                wavefile=None, air=False, resolution0=None,
                normalize='linear_continuum', float_bits=32, revision='',
                cmdline='', nthreads=1, log_parameters=(0,)):
    """Process the whole library (:func:`build_specs`) into
    ``oprefix/specs_{setup}.h5``; returns the dict written."""
    out = build_specs(setupInfo, parnames=parnames, dbfile=dbfile,
                      prefix=prefix, wavefile=wavefile, air=air,
                      resolution0=resolution0, normalize=normalize,
                      float_bits=float_bits, revision=revision,
                      cmdline=cmdline, nthreads=nthreads,
                      log_parameters=log_parameters)
    os.makedirs(oprefix, exist_ok=True)
    serializer.save_dict_to_hdf5(
        os.path.join(oprefix, SPECS_H5_NAME % setupInfo[0]), out)
    return out


def add_bool_arg(parser, name, default=False, help=None):
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument('--' + name, dest=name, action='store_true',
                       help=help)
    group.add_argument('--no-' + name, dest=name, action='store_false',
                       help='Invert ' + name)
    parser.set_defaults(**{name: default})


def main(args=None):
    if args is None:
        args = sys.argv[1:]
    cmdline = shlex.join(['rvstorch_make_interpol'] + list(args))
    parser = argparse.ArgumentParser(
        description='Create convolved/rebinned template spectra')
    parser.add_argument('--setup', type=str, required=True)
    parser.add_argument('--lambda0', type=float, required=True)
    parser.add_argument('--lambda1', type=float, required=True)
    parser.add_argument('--resol', type=float)
    parser.add_argument('--resol_func', type=str)
    parser.add_argument('--step', type=float, required=True)
    parser.add_argument('--float_bits', type=int, default=32,
                        choices=[32, 64])
    parser.add_argument('--revision', type=str, default='')
    parser.add_argument('--parameter_names', type=str,
                        default='teff,logg,feh,alpha')
    parser.add_argument('--log_parameters', type=str, default='0')
    add_bool_arg(parser, 'log', default=True,
                 help='log-spaced wavelength grid')
    parser.add_argument('--normalize', type=str,
                        default='linear_continuum',
                        choices=['none', 'median', 'linear_continuum'])
    parser.add_argument('--templdb', type=str, default='files.db')
    parser.add_argument('--templprefix', type=str, required=True)
    parser.add_argument('--air', action='store_true', default=False)
    parser.add_argument('--oprefix', type=str, default='templ_data/')
    parser.add_argument('--wavefile', type=str, required=True)
    parser.add_argument('--resolution0', type=float, default=100000)
    parser.add_argument('--nthreads', type=int, default=1)
    parser.add_argument('--fixed_fwhm', action='store_true', default=False)
    args = parser.parse_args(args)

    if (args.resol is None) == (args.resol_func is None):
        parser.error('specify exactly one of --resol / --resol_func')
    if args.resol_func is not None and args.fixed_fwhm:
        parser.error('--resol_func is incompatible with --fixed_fwhm')
    if args.resol is not None:
        if args.fixed_fwhm:
            lam_mid = 0.5 * (args.lambda0 + args.lambda1)
            resol_func = Resolution(
                resol_func=f'x/{lam_mid}*{args.resol}')
        else:
            resol_func = Resolution(resol=args.resol)
    else:
        resol_func = Resolution(resol_func=args.resol_func)

    process_all((args.setup, args.lambda0, args.lambda1, resol_func,
                 args.step, args.log),
                parnames=tuple(args.parameter_names.split(',')),
                log_parameters=[int(x) for x in
                                args.log_parameters.split(',')],
                dbfile=args.templdb, oprefix=args.oprefix,
                prefix=args.templprefix, wavefile=args.wavefile,
                air=args.air, resolution0=args.resolution0,
                normalize=args.normalize, revision=args.revision,
                float_bits=args.float_bits, cmdline=cmdline,
                nthreads=args.nthreads)


if __name__ == '__main__':
    main()
