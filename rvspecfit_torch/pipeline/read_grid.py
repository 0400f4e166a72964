"""Template-grid database and LSF rebinner (offline, host).

The port's own copy of rvspecfit_tpu/pipeline/read_grid.py, through
the port's FITS module and ``sqlite3``: catalogue a directory of FITS
template spectra into an sqlite database (``--update`` appends only
the files not yet catalogued, by relative name), fetch individual
spectra, and build the sparse matrix that convolves to the target
resolution and integrates onto new pixels in one product
(``spec_new = spec_old @ mat``, float64 on the host).

The database connection and the wavelength array are cached per path
for the life of the process, as in the reference: a database rebuilt
at the same path is read through its first connection until
``_get_dbconn.cache_clear()``.

The rebinner's flux in an output pixel [l1, l2] of a piecewise-linear
input spectrum through a Gaussian LSF of width s is a closed form in
the Gaussian cdf moments

    J0(a) = int_-inf^a Phi(t) dt = a Phi(a) + phi(a)
    J1(a) = int_-inf^a t Phi(t) dt = ((a^2-1)/2) Phi(a) + (a/2) phi(a)

evaluated at scaled distances between pixel edges and node positions.
"""
from __future__ import annotations

import argparse
import functools
import glob
import itertools
import logging
import os
import sqlite3
import warnings

import numpy as np
import scipy.sparse
import scipy.special

from rvspecfit_torch.io import fitsio

DEFAULT_KEYWORDS = dict(teff='PHXTEFF', logg='PHXLOGG')


def makedb(prefix='', dbfile='files.db', keywords=None, mask='*/*fits',
           extra_params=None, update=False, name_metallicity='feh',
           name_alpha='alpha'):
    """Catalogue the FITS templates matching ``mask`` under ``prefix``
    into the sqlite database ``dbfile`` (overwritten unless ``update``,
    which appends the files not catalogued yet, by relative name)."""
    if keywords is None:
        keywords = dict(DEFAULT_KEYWORDS)
        keywords[name_metallicity] = 'PHXM_H'
        keywords[name_alpha] = 'PHXALPHA'
    extra_params = extra_params or {}

    db_exists = os.path.exists(dbfile)
    if db_exists and not update:
        logging.info('Overwriting template database %s', dbfile)
        os.unlink(dbfile)
        db_exists = False
    db = sqlite3.connect(dbfile)

    created_new = not db_exists
    file_id = 0
    if created_new:
        db.execute('CREATE TABLE grid_parameters '
                   '(id int, name varchar, explanation varchar)')
        for counter, k in enumerate(itertools.chain(keywords, extra_params)):
            db.execute('INSERT INTO grid_parameters (id, name) '
                       'VALUES (?, ?)', (counter, k))
        cols = ','.join(f'{k} real' for k in
                        itertools.chain(keywords, extra_params))
        db.execute(f'CREATE TABLE files (filename varchar, {cols}, '
                   'id int, bad bool)')
    else:
        tabinfo = db.execute('pragma table_info(files)').fetchall()
        existing = {row[1] for row in tabinfo}
        required = {'filename', 'id', 'bad'} | set(keywords) \
            | set(extra_params)
        missing = required - existing
        if missing:
            raise RuntimeError(
                f'Cannot update database; missing columns {sorted(missing)}')
        file_id = db.execute(
            'select coalesce(max(id), -1) from files').fetchone()[0] + 1

    fs = sorted(glob.glob(os.path.join(prefix, mask)))
    if not fs:
        raise RuntimeError(f'No FITS templates match {mask} in {prefix}')
    existing_files = set()
    if db_exists and update:
        existing_files = {r[0] for r in
                          db.execute('select filename from files')}

    ninserted = nskipped = 0
    allkeys = dict(itertools.chain(keywords.items(), extra_params.items()))
    for f in fs:
        rel = os.path.relpath(f, prefix)
        if rel in existing_files:
            nskipped += 1
            continue
        hdr = fitsio.getheader(f)
        vals = {}
        for pname, key in allkeys.items():
            if key not in hdr:
                raise RuntimeError(f'Keyword {key} for {pname} missing '
                                   f'in {f}')
            vals[pname] = hdr[key]
        q = ('insert into files (filename, id, bad, '
             + ','.join(vals) + ') values (?,?,?' + ',?' * len(vals) + ')')
        db.execute(q, (rel, file_id, False) + tuple(vals.values()))
        existing_files.add(rel)
        file_id += 1
        ninserted += 1
    db.commit()
    if created_new:
        for idx_col in ('logg', 'teff', name_metallicity, 'id'):
            db.execute(f'create index idx_{idx_col} on files({idx_col})')
        db.commit()
    if update and nskipped:
        logging.info('update: inserted %d, skipped %d existing',
                     ninserted, nskipped)
    db.close()


@functools.lru_cache(None)
def _get_dbconn(dbfile):
    return sqlite3.connect(dbfile)


@functools.lru_cache(None)
def _get_wave(wavefile):
    arr = fitsio.getdata(wavefile)
    return np.asarray(arr, dtype=np.float64)


def get_spec(params, dbfile=None, prefix=None, wavefile=None, pad=0.01):
    """(wavelengths, spectrum) of the template at ``params`` (a box
    query of +-pad around each value), both float64."""
    clauses = [f'{k} between {v - pad} and {v + pad}'
               for k, v in params.items()]
    q = 'select filename from files where ' + ' and '.join(clauses)
    cur = _get_dbconn(dbfile).cursor()
    cur.execute(q)
    rows = cur.fetchall()
    if len(rows) > 1:
        logging.warning('More than one template matches %s', params)
    if not rows:
        raise RuntimeError(f'No templates match {params}')
    dat = fitsio.getdata(os.path.join(prefix, rows[0][0]))
    return _get_wave(wavefile), np.asarray(dat, dtype=np.float64)


def vacuum_to_air(lam_vac):
    """Vacuum->air wavelength conversion (angstroms), IAU/Morton
    refractive-index polynomial."""
    n = 1.0 + 2.735182e-4 + 131.4182 / lam_vac**2 + 2.76249e8 / lam_vac**4
    return lam_vac / n


def _j0(a):
    """int_-inf^a Phi(t) dt."""
    return a * scipy.special.ndtr(a) + _phi(a)


def _j1(a):
    """int_-inf^a t Phi(t) dt (constant dropped)."""
    return 0.5 * (a * a - 1.0) * scipy.special.ndtr(a) + 0.5 * a * _phi(a)


def _phi(a):
    return np.exp(-0.5 * a * a) / np.sqrt(2 * np.pi)


def _lin_gauss_pixel_integral(c_at_l, slope, t_hi, t_lo, s):
    """int over the segment of (linear weight) * Phi((l - x)/s) dx
    expressed in node-scaled variables; see module docstring.

    c_at_l : weight value at x = l (precomputed stably)
    slope : d(weight)/dx
    t_hi, t_lo : (l - x1)/s, (l - x2)/s
    """
    return s * (c_at_l * (_j0(t_hi) - _j0(t_lo))
                - slope * s * (_j1(t_hi) - _j1(t_lo)))


def make_rebinner(lam00, lam, resolution_function, resolution0=None,
                  toair=False):
    """Sparse matrix: Gaussian LSF convolution + pixel-integrated
    rebinning of piecewise-linear input spectra.

    Applied as ``spec_new = spec_old @ mat`` (a CSC matrix of shape
    (len(lam00), len(lam))); ``toair`` takes the input wavelengths from
    vacuum to air first.
    Target LSF sigma^2 = fwhm_target^2 - fwhm_input^2 (the input grid
    resolution0 is deconvolved).
    """
    lam00 = np.asarray(lam00, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64)
    lam0 = vacuum_to_air(lam00) if toair else lam00

    res_arr = np.asarray(resolution_function(lam), dtype=np.float64) \
        + 0.0 * lam
    if resolution0 is None:
        raise ValueError('resolution0 (input grid resolution) is required')
    if res_arr.max() >= resolution0:
        raise ValueError('target resolution exceeds the input resolution')
    fwhm_to_sig = 2 * np.sqrt(2 * np.log(2))
    sigs = np.sqrt((lam / res_arr)**2 - (lam / resolution0)**2) / fwhm_to_sig

    thresh = 5.0
    rows, cols, vals = [], [], []
    size_warning = False
    n_in = len(lam0)
    for i in range(len(lam)):
        curlam = lam[i]
        leftstep = 0.5 * (lam[i] - lam[i - 1]) if i > 0 else \
            0.5 * (lam[i + 1] - lam[i])
        rightstep = 0.5 * (lam[i + 1] - lam[i]) if i < len(lam) - 1 else \
            leftstep
        s = sigs[i]
        left = np.searchsorted(lam0, curlam - thresh * s) - 1
        right = np.searchsorted(lam0, curlam + thresh * s)
        if left < 0:
            size_warning = True
            left = 0
        if right > n_in - 2:
            size_warning = True
            right = n_in - 2
        seg = np.arange(left, right + 1)
        x1 = lam0[seg]
        x2 = lam0[seg + 1]
        dx = x2 - x1
        l1 = curlam - leftstep
        l2 = curlam + rightstep

        def contrib(l_edge):
            t_hi = (l_edge - x1) / s
            t_lo = (l_edge - x2) / s
            # weight of left node f1: w(x) = (x2 - x)/dx
            c1 = (x2 - l_edge) / dx
            w1 = _lin_gauss_pixel_integral(c1, -1.0 / dx, t_hi, t_lo, s)
            # weight of right node f2: w(x) = (x - x1)/dx
            c2 = (l_edge - x1) / dx
            w2 = _lin_gauss_pixel_integral(c2, 1.0 / dx, t_hi, t_lo, s)
            return w1, w2

        hi1, hi2 = contrib(l2)
        lo1, lo2 = contrib(l1)
        step = leftstep + rightstep
        rows.append(seg)
        cols.append(np.full(len(seg), i))
        vals.append((hi1 - lo1) / step)
        rows.append(seg + 1)
        cols.append(np.full(len(seg), i))
        vals.append((hi2 - lo2) / step)

    if size_warning:
        warnings.warn('Input spectrum not wide enough for full LSF '
                      'convolution; spectrum edges will be corrupted')
    mat = scipy.sparse.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_in, len(lam)))
    return mat.tocsc()


def apply_rebinner(mat, spec0):
    return np.asarray(spec0 @ mat)


def rebin(lam0, spec0, newlam, resolution, resolution0=100000):
    """One-shot convenience rebinning."""
    mat = make_rebinner(lam0, newlam, lambda x: resolution + 0 * x,
                        resolution0=resolution0)
    return apply_rebinner(mat, spec0)


def main(args=None):
    parser = argparse.ArgumentParser(
        description='Create the sqlite database describing the template '
        'grid')
    parser.add_argument('--prefix', type=str, default='./')
    parser.add_argument('--keyword_teff', type=str, default='PHXTEFF')
    parser.add_argument('--keyword_logg', type=str, default='PHXLOGG')
    parser.add_argument('--keyword_alpha', type=str, default='PHXALPHA')
    parser.add_argument('--keyword_metallicity', type=str,
                        default='PHXM_H')
    parser.add_argument('--name_metallicity', type=str, default='feh')
    parser.add_argument('--name_alpha', type=str, default='alpha')
    parser.add_argument('--extra_params', type=str, default=None,
                        help='comma separated name:KEY pairs')
    parser.add_argument('--glob_mask', type=str, default='*/*fits')
    parser.add_argument('--templdb', type=str, default='files.db')
    parser.add_argument('--update', action='store_true', default=False)
    args = parser.parse_args(args)

    keywords = dict(teff=args.keyword_teff, logg=args.keyword_logg)
    keywords[args.name_metallicity] = args.keyword_metallicity
    keywords[args.name_alpha] = args.keyword_alpha
    extra = None
    if args.extra_params:
        extra = dict(kv.split(':') for kv in args.extra_params.split(','))
    makedb(args.prefix, dbfile=args.templdb, keywords=keywords,
           mask=args.glob_mask, extra_params=extra, update=args.update,
           name_metallicity=args.name_metallicity,
           name_alpha=args.name_alpha)


if __name__ == '__main__':
    main()
