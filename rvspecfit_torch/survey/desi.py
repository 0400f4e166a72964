"""DESI batch-fitting driver (``rvstorch_desi_fit``).

Counterpart of rvspecfit_tpu/survey/desi.py.  Per group of
``--coalesce`` consecutive files:

 1. read each coadd/spectra file (io/fitsio), check its extensions;
 2. per-fiber S/N (SCORES, or the median of the data); select fibers
    (fiberstatus, OBJTYPE, target bits, min S/N, targetid list, expid
    range, optional redrock star selection);
 3. build the stacked arms on the host: bad-pixel and dichroic masks,
    linear infill, large-error masking, error clamping and optional
    per-fiber banded resolution matrices with the template LSF
    deconvolved;
 4. fit the group's fibers as one batch (:func:`_run_group_fit`): CCF
    first guess (kernel B) -> Nelder-Mead -> gradient polish ->
    velocity refinement -> AD Hessian errors -> best-fit models (kernel
    A and its adjoint);
 5. RVS_WARN bits, RVTAB + RVMOD written atomically, status lines,
    skipexisting, per-file crash isolation (a failed group fit is
    retried file by file), optional per-fiber plots (``--doplot``).

:func:`proc_many` overlaps these stages as the reference does, each
under the reference's switch (on unless set to ``0``):
- a lookahead reader: while one file or group fits, a daemon thread
  reads the next one's FITS files (static lists only: a queue's item is
  never claimed early);
- ``RVST_PIPELINE_PREP`` (coalesce > 1): the next group's host stage
  and its CCF (fit/ccf.fit_batch_async, kernel B) run on a background
  thread and a CUDA stream of their own while this group fits;
- ``RVST_DEFER_TAIL``: :func:`_run_group_fit` returns after Nelder-Mead
  a :class:`_LazyFit` over BatchedFitter.run_tail_async, whose tail
  (polish, refinement, Hessians, models) runs on a worker thread and
  stream while the next group fits;
- ``RVST_ASYNC_WRITE``: one writer thread runs each file's or group's
  finish (collect the tail, rows, RVTAB/RVMOD, plots), at most one
  outstanding, in submission order; the status lines keep that order
  and are stamped when a write completes.
Every worker thread enters the card first (device.enter_device).  A
tail that fails gives the group's per-file retry, as a failure of the
group's CCF or Nelder-Mead does.  On a host with several cards the
fitter is sharded over them (parallel/mesh.auto_shard;
``RVST_NO_MESH=1`` opts out).  Each stage is a span of
:mod:`rvspecfit_torch.trace` on the thread that runs it, recorded while
a torch profiler records: ``driver.group`` (and in it ``driver.prep`` or
``driver.prep_wait``, ``fit.group``, ``driver.write_wait``) on the
calling thread, ``driver.prep`` (``driver.read_wait``, ``ccf.dispatch``)
on ``rvst-prep``, ``driver.read`` on ``rvst-reader``, ``fit.tail`` on
``rvst-tail``, ``driver.finish`` (``fit.tail_collect``,
``driver.write``) on ``rvst-writer``.

Many processes fit one list of files (:func:`fleet`): static
``--rank/--world`` sharding, a lock-file queue on a shared filesystem
(``--queue_file``) or a queue claimed through the world's key-value
store (``--dynamic_queue``, parallel/distributed).  A queue item is
claimed only when the process is ready to fit it.

Differences from the reference, by design:
- a deferred tail owns a snapshot of its group's arms, and a tail that
  fails is retried file by file (the reference's tail reads the next
  group's arms, and skips the retry);
- ``config['pipeline_warm']`` only builds the kernel libraries (the
  reference's warm-up overlaps remote XLA compiles);
- a template-loading failure raises, and so does a CCF failure: under
  crash isolation that file gets a FAILURE status line (the reference
  starts every fiber at default parameters);
- ``config['fit_microbatch']`` unset fits a group whole (the reference
  rounds it up to a tile width of 64/128/256/500 fibers, which exists
  to share compiled XLA programs).

``--param_init bruteforce`` replaces the CCF by the brute-force start
of the first fiber (fit/vel_fit.firstguess), which seeds every fiber
of the group, as in the reference.
"""
from __future__ import annotations

import argparse
import collections
import collections.abc
import concurrent.futures
import contextlib
import functools
import hashlib
import importlib.metadata
import logging
import os
import re
import sys
import threading
import time
import traceback
import warnings

import numpy as np

from rvspecfit_torch import __version__, trace, utils
from rvspecfit_torch.device import Background, enter_device, resolve_device
from rvspecfit_torch.fit import ccf as ccf_mod
from rvspecfit_torch.fit import vel_fit
from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
from rvspecfit_torch.fit.spec_data import SpecData
from rvspecfit_torch.io import fitsio
from rvspecfit_torch.parallel import distributed
from rvspecfit_torch.parallel import mesh as pmesh
from rvspecfit_torch.pipeline import library

TABLE_PREFIX = 'rvtab'
MODEL_PREFIX = 'rvmod'

bitmasks = dict(CHISQ_WARN=1, RV_WARN=2, RVERR_WARN=4, PARAM_WARN=8,
                VSINI_WARN=16, BAD_SPECTRUM=32, BAD_HESSIAN=64)

PROC_STATUS_SUCCESS = 'SUCCESS'
PROC_STATUS_FAILURE = 'FAILURE'
PROC_STATUS_EXISTING = 'EXISTING'

# start parameters of a fiber whose CCF chi-square is not finite
DEFAULT_START = (5000.0, 3.0, -1.0, 0.2)
# RVTAB column names of the template parameters (reference schema)
PARAM_NAMES = dict(teff='TEFF', logg='LOGG', feh='FEH', alpha='ALPHAFE')


def update_process_status_file(status_fname, processed_file, status,
                               nobjects, time_sec, start=False,
                               finished_at=None):
    """Append one line per file, so that a restart knows what is done:
    ``file status nobjects seconds finished_at`` (reference:
    desi_fit.py:61-74, plus the unix time the file's outputs were
    completed, whose differences give the steady period per file).
    ``start=True`` truncates the file first."""
    if start:
        with open(status_fname, 'w'):
            pass
        if processed_file is None:
            return
    if finished_at is None:
        finished_at = time.time()
    with open(status_fname, 'a') as fp:
        print(f'{processed_file} {status} {nobjects} {time_sec:.2f} '
              f'{finished_at:.3f}', file=fp)


# ------------------- resolution matrix handling -------------------
# Every function takes stacked (B, width, npix) bands, so an exposure's
# resolution matrices are prepared with a handful of array ops (one
# batched linear solve) instead of a per-fiber loop.

def _band_torows(mats):
    """dia-convention bands (offsets +w2..-w2, column-indexed) ->
    row-indexed bands.  (..., w, npix) -> (..., w, npix); row k of the
    output multiplies input pixel i + (k - w2) for output pixel i."""
    mats = np.asarray(mats)
    w = mats.shape[-2]
    w2 = w // 2
    out = np.empty_like(mats)
    for k in range(w):
        out[..., w - 1 - k, :] = np.roll(mats[..., k, :], k - w2,
                                         axis=-1)
    return out


def _band_tocolumns(rows):
    """Inverse of :func:`_band_torows`."""
    rows = np.asarray(rows)
    w = rows.shape[-2]
    w2 = w // 2
    out = np.empty_like(rows)
    for k in range(w):
        out[..., k, :] = np.roll(rows[..., w - 1 - k, :], w2 - k,
                                 axis=-1)
    return out


def deconvolve_resolution_matrix(mats, sigma0_angstrom=0.5,
                                 pix_size_angstrom=0.8):
    """Deconvolve the template LSF (sigma0) out of DESI banded
    resolution matrices by solving the band-width-domain Gaussian
    system, for the whole stack in one broadcast ``np.linalg.solve``
    (reference math: desi_fit.py:694-720).

    mats : (w, npix) or (B, w, npix) dia-convention bands."""
    mats = np.asarray(mats, np.float64)
    single = mats.ndim == 2
    if single:
        mats = mats[None]
    width, npix = mats.shape[-2:]
    sig_pix = sigma0_angstrom / pix_size_angstrom
    xs = np.arange(width)
    gau = np.exp(-0.5 * ((xs[None, :] - xs[:, None]) / sig_pix)**2) \
        / np.sqrt(2 * np.pi) / sig_pix
    w2 = width // 2
    rows = _band_torows(mats)
    # zero the band entries that would reach out of the spectrum
    for i in range(w2):
        rows[:, :w2 - i - 1, i] = 0
        rows[:, w2 + 1 + i:, npix - 1 - i] = 0
    rows1 = np.linalg.solve(np.broadcast_to(gau, (len(mats),) + gau.shape),
                            rows)
    out = _band_tocolumns(rows1)
    return out[0] if single else out


def prepare_resolution_band(mats, pix_size_angstrom=None,
                            sigma0_angstrom=None):
    """Deconvolve + edge-renormalize banded resolutions; returns
    row-indexed band data for fit/batch.BatchArm's ``resolution``
    (reference edge handling: desi_fit.py:723-748), vectorized over
    the fiber axis.

    mats : (w, npix) or (B, w, npix); returns the same leading shape.
    rows[..., k, i] = M[i, i + (k - w2)]."""
    mats = np.asarray(mats, np.float64)
    single = mats.ndim == 2
    if single:
        mats = mats[None]
    dec = deconvolve_resolution_matrix(
        mats, sigma0_angstrom=sigma0_angstrom,
        pix_size_angstrom=pix_size_angstrom)
    width, npix = dec.shape[-2:]
    w2 = width // 2
    rows = _band_torows(dec)
    mult = np.median(rows.sum(axis=1), axis=-1)           # (B,)
    mult = np.where(mult == 0, 1.0, mult)
    for i in range(w2):
        n1 = rows[:, w2 - i:, i].sum(axis=1)
        rows[:, :, i] *= (mult / (n1 + (n1 == 0)))[:, None]
        j = npix - 1 - i
        n2 = rows[:, :w2 + 1 + i, j].sum(axis=1)
        rows[:, :, j] *= (mult / (n2 + (n2 == 0)))[:, None]
    return rows[0] if single else rows


# ------------------- host statistics of the arms ------------------
# numpy copies of rvspecfit_tpu/ops/continuum.py's masked_median and
# infill_bad_pixels: the driver's prep runs on the host in float64,
# before any of the group's data is on a device.

def masked_median(x, good):
    """Per-row median of ``x`` over pixels where ``good`` is True and
    ``x`` is finite (±inf dropped, unlike np.nanmedian); NaN for rows
    with no such pixel.  x, good : (B, npix) -> (B,)."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    good = np.atleast_2d(np.asarray(good, bool))
    filled = np.where(good, x, np.inf)
    filled[~np.isfinite(filled)] = np.inf
    s = np.sort(filled, axis=1)
    n = (s < np.inf).sum(axis=1)
    rows = np.arange(s.shape[0])
    n_c = np.maximum(n, 1)
    med = 0.5 * (s[rows, (n_c - 1) // 2] + s[rows, n_c // 2])
    return np.where(n > 0, med, np.nan)


def infill_bad_pixels(lam, specs, badmask):
    """Replace masked pixels by linear interpolation between the
    nearest good neighbours; edge runs take the nearest good value.
    Fully masked rows keep their values with non-finite ones set to 1.
    lam : (npix,); specs, badmask : (B, npix) -> (B, npix)."""
    specs = np.atleast_2d(np.asarray(specs, np.float64))
    badmask = np.atleast_2d(np.asarray(badmask, bool))
    bad_rows = badmask.any(axis=1)
    if not bad_rows.all():
        out = specs.copy()
        if bad_rows.any():
            out[bad_rows] = infill_bad_pixels(
                lam, specs[bad_rows], badmask[bad_rows])
        return out

    b, npix = specs.shape
    good = ~badmask
    cols = np.arange(npix)
    # nearest good index to the left / right via cumulative scans
    li = np.maximum.accumulate(np.where(good, cols, -1), axis=1)
    ri = np.flip(np.minimum.accumulate(
        np.flip(np.where(good, cols, npix), 1), axis=1), 1)
    li_c = np.clip(li, 0, npix - 1)
    ri_c = np.clip(ri, 0, npix - 1)
    rows = np.arange(b)[:, None]
    sl = specs[rows, li_c]
    sr = specs[rows, ri_c]
    ll = lam[li_c]
    lr = lam[ri_c]
    denom = lr - ll
    with np.errstate(invalid='ignore', divide='ignore'):
        interp = (sl * (lr - lam[None, :]) + sr * (lam[None, :] - ll)) \
            / np.where(denom == 0, 1.0, denom)
    has_l = li >= 0
    has_r = ri <= npix - 1
    filled = np.where(has_l & has_r, np.where(denom == 0, sl, interp),
                      np.where(has_l, sl, sr))
    out = np.where(badmask, filled, specs)
    allbad = ~good.any(axis=1)
    if allbad.any():
        logging.warning('All pixels masked for %d spectra',
                        int(allbad.sum()))
        orig = specs[allbad]
        out[allbad] = np.where(np.isfinite(orig), orig, 1.0)
    return out


# ------------------------- file reading ---------------------------

def valid_file(fp, setups):
    """Check the file has every needed extension
    (reference: desi_fit.py:225-245)."""
    names = {str(n).upper() for n in fp.names()}
    needed = {'FIBERMAP'}
    for s in setups:
        for kind in ('WAVELENGTH', 'FLUX', 'IVAR', 'MASK'):
            needed.add(f'{s.upper()}_{kind}')
    missing = needed - names
    if missing:
        logging.error('Missing extensions: %s', sorted(missing))
        return False
    return True


def read_data(fp, setups):
    """Per-setup flux, ivar, mask, wavelength and resolution (None
    where the file has no RESOLUTION extension) of an open file."""
    fluxes, ivars, masks, waves, resolutions = {}, {}, {}, {}, {}
    for s in setups:
        su = s.upper()
        fluxes[s] = np.atleast_2d(fp[f'{su}_FLUX'].data)
        ivars[s] = np.atleast_2d(fp[f'{su}_IVAR'].data)
        masks[s] = np.atleast_2d(fp[f'{su}_MASK'].data)
        waves[s] = np.asarray(fp[f'{su}_WAVELENGTH'].data).ravel()
        resolutions[s] = fp[f'{su}_RESOLUTION'].data \
            if f'{su}_RESOLUTION' in fp else None
    return fluxes, ivars, masks, waves, resolutions


def get_sns(data, ivars, masks):
    """Median per-fiber S/N (reference: desi_fit.py:444-456)."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        bad = (ivars <= 0) | (masks > 0)
        xsn = data * np.sqrt(np.where(bad, 0, ivars))
        sns = masked_median(xsn, ~bad)
        sns[~np.isfinite(sns)] = -1e9
    return sns


def get_sns_from_scores(scores, setups):
    """Per-arm S/N from the SCORES extension when available
    (reference: desi_fit.py:1076-1091); None -> compute from data."""
    if scores is None:
        return None
    for prefix in ('MEDIAN_CALIB_SNR_', 'MEDIAN_COADD_SNR_',
                   'MEDIAN_COADD_FLUX_SNR_'):
        if all(prefix + s.upper() in scores for s in setups):
            return {s: np.asarray(scores[prefix + s.upper()],
                                  np.float64) for s in setups}
    return None


def fiberstatus_select(fibermap):
    """Good-fiberstatus subset (reference: desi_fit.py:524-543)."""
    good_bits = np.array([3, 20], dtype=int)
    good = int(np.sum(1 << good_bits))
    if 'FIBERSTATUS' in fibermap:
        col = fibermap['FIBERSTATUS']
    elif 'COADD_FIBERSTATUS' in fibermap:
        col = fibermap['COADD_FIBERSTATUS']
    else:
        raise RuntimeError('Fiberstatus column not found')
    return (col & good) == col


# Target bit-name tables (public DESI data model / desitarget
# targetmask yamls), embedded per survey phase because the desitarget
# package is not a dependency; the selection dispatches on whichever
# target column the FIBERMAP carries (CMX_TARGET / SV{1,2,3}_DESI_TARGET
# / DESI_TARGET).  --targetmask_yaml extends a table, --objtype_mask
# gives bits directly.

# bits desitarget pins at fixed positions across all survey phases
_COMMON_TARGET_BITS = {
    'SKY': 32, 'STD_FAINT': 33, 'STD_WD': 34, 'STD_BRIGHT': 35,
    'BAD_SKY': 36, 'SUPP_SKY': 37,
    'NO_TARGET': 57, 'BRIGHT_OBJECT': 58, 'IN_BRIGHT_OBJECT': 59,
    'BGS_ANY': 60, 'MWS_ANY': 61, 'SCND_ANY': 62,
}

DESI_TARGET_BITS = dict(
    LRG=0, ELG=1, QSO=2, LRG_1PASS=3, LRG_2PASS=4,
    ELG_LOP=5, ELG_HIP=6, ELG_VLO=7, **_COMMON_TARGET_BITS)

# SV2/SV3 desi_mask science sub-bits (sv2/sv3_targetmask.yaml)
_SV23_BITS = dict(
    LRG=0, ELG=1, QSO=2, LRG_LOWDENS=3,
    ELG_LOP=5, ELG_HIP=6, ELG_VLO=7, **_COMMON_TARGET_BITS)
# SV1: the headline science bits only
_SV1_BITS = dict(LRG=0, ELG=1, QSO=2, **_COMMON_TARGET_BITS)
# commissioning: the pinned convention bits only
_CMX_BITS = dict(_COMMON_TARGET_BITS)

# dispatch priority mirrors desitarget.targets.main_cmx_or_sv:
# commissioning first, then SV, then the main survey
TARGET_COLUMN_TABLES = (
    ('CMX_TARGET', _CMX_BITS),
    ('SV1_DESI_TARGET', _SV1_BITS),
    ('SV2_DESI_TARGET', _SV23_BITS),
    ('SV3_DESI_TARGET', _SV23_BITS),
    ('DESI_TARGET', DESI_TARGET_BITS),
)


def target_column(fibermap, extra_tables=None):
    """(column_name, bit_table) for the target column this FIBERMAP
    carries, or (None, None) when it has none.  ``extra_tables``
    ({column: {NAME: bit}}, from :func:`load_targetmask_yaml`) extends
    the embedded table of the active column."""
    for col, table in TARGET_COLUMN_TABLES:
        if col in fibermap:
            if extra_tables and col in extra_tables:
                table = {**table, **extra_tables[col]}
            return col, table
    return None, None


# desitarget yaml section name -> fibermap target column
_YAML_MASK_COLUMNS = {
    'cmx_mask': 'CMX_TARGET',
    'sv1_desi_mask': 'SV1_DESI_TARGET',
    'sv2_desi_mask': 'SV2_DESI_TARGET',
    'sv3_desi_mask': 'SV3_DESI_TARGET',
    'desi_mask': 'DESI_TARGET',
}


def load_targetmask_yaml(paths):
    """{column: {NAME: bit}} tables for :func:`target_column` from
    desitarget-format targetmask yaml file(s) (``{<mask_name>: [[NAME,
    bit, comment, extra], ...]}``); only the ``*_desi_mask`` /
    ``cmx_mask`` / ``desi_mask`` sections are read."""
    import yaml
    if isinstance(paths, str):
        paths = [paths]
    out = {}
    for path in paths:
        with open(path) as fp:
            data = yaml.safe_load(fp)
        found = False
        for mask_name, rows in (data or {}).items():
            col = _YAML_MASK_COLUMNS.get(mask_name)
            if col is None or not isinstance(rows, list):
                continue
            table = out.setdefault(col, {})
            for row in rows:
                if isinstance(row, (list, tuple)) and len(row) >= 2:
                    table[str(row[0])] = int(row[1])
            found = found or bool(table)
        if not found:
            raise ValueError(
                f'{path}: no recognized targetmask sections (expected '
                f'one of {sorted(_YAML_MASK_COLUMNS)} in the desitarget '
                'yaml schema)')
    return out


def objtypes_to_mask(objtypes, bit_table=None, column='DESI_TARGET'):
    """Bitmask of the names in ``bit_table`` that match any of the
    ``objtypes`` regexes (reference: desi_fit.py:495-522).  Raises if
    none matches: a typo would otherwise select nothing."""
    if bit_table is None:
        bit_table = DESI_TARGET_BITS
    res = [re.compile(o) for o in objtypes]
    mask = 0
    matched = []
    for name, bit in bit_table.items():
        if any(r.match(name) for r in res):
            mask |= (1 << bit)
            matched.append(name)
    if not mask:
        raise ValueError(
            f'no {column} names match objtypes {objtypes}; '
            f'known names: {sorted(bit_table)}. For survey-phase bits '
            'not embedded here (SV1 experimental sub-bits, CMX '
            'SV0_*/MINI_SV_*), pass the public desitarget yaml via '
            '--targetmask_yaml, or give an explicit --objtype_mask.')
    logging.info('objtypes %s -> %s names %s (mask 0x%x)',
                 objtypes, column, matched, mask)
    return mask


def select_fibers_to_fit(fibermap, sns, minsn=None, fit_targetid=None,
                         expid_range=None, zbest_path=None,
                         zbest_select=False, objtype_mask=None,
                         objtypes=None, target_tables=None):
    """Fiber selection (reference: desi_fit.py:546-679, with the
    embedded target tables in place of desitarget).  Returns (the
    (nfibers,) selection, the redrock columns RR_Z / RR_SPECTYPE /
    RR_SUBTYPE when ``zbest_path`` exists, else {})."""
    n = len(fibermap['TARGETID'])
    sel = np.ones(n, dtype=bool)
    sel &= fiberstatus_select(fibermap)
    if 'OBJTYPE' in fibermap:
        sel &= np.char.strip(fibermap['OBJTYPE'].astype(str)) == 'TGT'
    tcol, ttable = target_column(fibermap, target_tables)
    if objtypes is not None:
        if tcol is None:
            raise RuntimeError(
                'objtypes selection requested but the FIBERMAP carries '
                'no target column (DESI_TARGET / SV*_DESI_TARGET / '
                'CMX_TARGET)')
        objtype_mask = (objtype_mask or 0) | objtypes_to_mask(
            objtypes, ttable, tcol)
    if objtype_mask is not None and tcol is not None:
        sel &= (fibermap[tcol] & objtype_mask) > 0
    if minsn is not None:
        sel &= sns > minsn
    if fit_targetid is not None:
        sel &= np.isin(fibermap['TARGETID'], fit_targetid)
    if expid_range is not None and 'EXPID' in fibermap:
        lo, hi = expid_range
        sel &= (fibermap['EXPID'] >= lo) & (fibermap['EXPID'] <= hi)
    rr = {}
    if zbest_path is not None and os.path.exists(zbest_path):
        zb = fitsio.read(zbest_path)
        ztab = zb['REDSHIFTS'].data if 'REDSHIFTS' in zb else \
            zb['ZBEST'].data
        order = {tid: i for i, tid in enumerate(ztab['TARGETID'])}
        idx = np.array([order.get(t, -1) for t in fibermap['TARGETID']])
        has = idx >= 0
        at = np.maximum(idx, 0)
        z = np.where(has, ztab['Z'][at], np.nan)
        spectype = np.where(
            has, np.char.strip(ztab['SPECTYPE'].astype(str))[at], '')
        subtype = np.where(
            has, np.char.strip(ztab['SUBTYPE'].astype(str))[at], '') \
            if 'SUBTYPE' in ztab else np.full(n, '')
        rr = dict(RR_Z=z, RR_SPECTYPE=spectype, RR_SUBTYPE=subtype)
        if zbest_select:
            c_kms = 299792.458
            is_star = (spectype == 'STAR') | (np.abs(z * c_kms) < 1500.0)
            sel &= has & is_star
    return sel, rr


# --------------------- per-fiber data assembly --------------------

def interpolate_bad_regions(specs, masks):
    """Linear infill of masked regions from the nearest good
    neighbours, vectorized over fibers (the reference's per-region
    interpolation, desi_fit.py:751-778); fully masked rows pass
    through unchanged.  specs, masks : (npix,) or (B, npix)."""
    specs = np.asarray(specs, np.float64)
    single = specs.ndim == 1
    s2 = np.atleast_2d(specs)
    m2 = np.atleast_2d(np.asarray(masks, bool))
    pix = np.arange(s2.shape[1], dtype=np.float64)
    out = infill_bad_pixels(pix, s2, m2)
    allbad = m2.all(axis=1)
    out[allbad] = s2[allbad]
    return out[0] if single else out


def build_batch_arms(waves, fluxes, ivars, masks, resolutions, subset,
                     setups, use_resolution_matrix=False,
                     mask_dicroic=True, lsf_sigma0_angstrom=None):
    """Stacked per-arm data of the selected fibers (the reference's
    per-fiber logic, desi_fit.py:781-886, vectorized over fibers):
    bad-pixel identification, dichroic mask, linear infill,
    large-error masking, error clamping, optional per-fiber resolution
    bands with the 5 edge pixels masked.  Returns (arms, the (nsel,)
    mask of fibers with any good pixel)."""
    large_error = 1000.0
    minerr_frac = 0.3
    idx = np.nonzero(subset)[0]
    arms = []
    anygood = np.zeros(len(idx), dtype=bool)
    for s in setups:
        wave = waves[s]
        flux = np.array(fluxes[s][idx], dtype=np.float64)
        ivar = np.array(ivars[s][idx], dtype=np.float64)
        mask = masks[s][idx] > 0
        baddat = ~np.isfinite(flux + ivar)
        baderr = ivar <= 0
        dicroic = ((wave > 4300) & (wave < 4450))[None, :] if mask_dicroic \
            else np.zeros((1, len(wave)), bool)
        edge_mask = np.zeros(len(wave), bool)
        res_band = None
        if use_resolution_matrix and resolutions[s] is not None:
            sig0 = (lsf_sigma0_angstrom or {}).get(s, 0.5)
            res_band = prepare_resolution_band(
                np.asarray(resolutions[s])[idx],
                pix_size_angstrom=wave[1] - wave[0], sigma0_angstrom=sig0)
            edge_mask[:5] = True
            edge_mask[-5:] = True
        badall = baddat | mask | baderr | dicroic | edge_mask[None, :]
        badall_interp = baddat | mask | baderr

        flux = np.where(np.isfinite(flux), flux, 0.0)
        medspec = masked_median(flux, ~badall)
        fallback = np.median(np.abs(flux), axis=1)
        medspec = np.where(np.isfinite(medspec) & (medspec != 0),
                           medspec, fallback)
        medspec = np.where(np.isfinite(medspec) & (medspec != 0),
                           medspec, 1.0)
        ivar = np.where(badall,
                        1.0 / medspec[:, None]**2 / large_error**2, ivar)
        flux = interpolate_bad_regions(flux, badall_interp)
        with np.errstate(divide='ignore'):
            espec = 1.0 / np.sqrt(ivar)
        good = ~badall
        anygood |= good.any(axis=1)
        # clamp too-small errors (reference: desi_fit.py:866-874)
        gmed = masked_median(espec, good)
        gmed = np.where(np.isfinite(gmed), gmed, 1.0)
        thresh = gmed * minerr_frac
        clamp = (espec < thresh[:, None]) & good
        espec = np.where(clamp, thresh[:, None], espec)
        ivar = 1.0 / espec**2

        arms.append(BatchArm(f'desi_{s}', wave, flux, ivar,
                             badmask=badall, resolution=res_band,
                             setup=f'desi_{s}'))
    return arms, anygood


# -------------------------- warnings ------------------------------

def get_rvs_warn_batch(results, config):
    """Quality bitmask per fiber (reference: desi_fit.py:381-430)."""
    nf = len(results['VRAD'])
    warn = np.zeros(nf, dtype=np.int64)
    dchisq = results['CHISQ_C_TOT'] - results['CHISQ_TOT']
    warn |= np.where(dchisq < 50, bitmasks['CHISQ_WARN'], 0)
    rvedge = 5.0
    warn |= np.where(
        (results['VRAD'] < config['min_vel'] + rvedge)
        | (results['VRAD'] > config['max_vel'] - rvedge),
        bitmasks['RV_WARN'], 0)
    warn |= np.where(results['VSINI'] > 100.0, bitmasks['VSINI_WARN'], 0)
    warn |= np.where(results['VRAD_ERR'] > 100.0,
                     bitmasks['RVERR_WARN'], 0)
    warn |= np.where(results['BAD_HESSIAN'], bitmasks['BAD_HESSIAN'], 0)
    for name, edges, thr in (('TEFF', (2300, 15000), 10),
                             ('FEH', (-4, 1), 0.01),
                             ('LOGG', (-0.5, 6.5), 0.01)):
        v = results[name]
        warn |= np.where((v < edges[0] + thr) | (v > edges[1] - thr),
                         bitmasks['PARAM_WARN'], 0)
    return warn


def get_column_desc(setups):
    """RVTAB column (dtype, description, unit) registry
    (reference: desi_fit.py:910-959)."""
    kms = 'km/s'
    desc = {
        'VRAD': (np.float32, 'Radial velocity', kms),
        'VRAD_ERR': (np.float32, 'Radial velocity error', kms),
        'VRAD_SKEW': (np.float32, 'Radial velocity posterior skewness',
                      ''),
        'VRAD_KURT': (np.float32, 'Radial velocity posterior kurtosis',
                      ''),
        'VSINI': (np.float32, 'Stellar rotation velocity', kms),
        'LOGG': (np.float32, 'Log of surface gravity', ''),
        'TEFF': (np.float32, 'Effective temperature', 'K'),
        'FEH': (np.float32, '[Fe/H] from template fitting', ''),
        'ALPHAFE': (np.float32, '[alpha/Fe] from template fitting', ''),
        'LOGG_ERR': (np.float32, 'Log of surface gravity uncertainty',
                     ''),
        'TEFF_ERR': (np.float32, 'Effective temperature uncertainty',
                     'K'),
        'FEH_ERR': (np.float32,
                    '[Fe/H] uncertainty from template fitting', ''),
        'ALPHAFE_ERR': (np.float32,
                        '[alpha/Fe] uncertainty from template fitting',
                        ''),
        'CHISQ_TOT': (np.float64, 'Total chi-square for all arms', ''),
        'NPIX_TOT': (np.float64,
                     'Total number of unmasked pixels fitted', ''),
        'CHISQ_C_TOT': (np.float64, 'Total chi-square for all arms for '
                        'polynomial only fit', ''),
        'CHISQ_CCF': (np.float32, 'Total chi-square from CCF fit', ''),
        'TEFF_CCF': (np.float32, 'Effective temperature from CCF fit',
                     'K'),
        'LOGG_CCF': (np.float32, 'Log of surface gravity from CCF fit',
                     ''),
        'FEH_CCF': (np.float32, '[Fe/H] from CCF fit', ''),
        'ALPHAFE_CCF': (np.float32, '[alpha/Fe] from CCF fit', ''),
        'VSINI_CCF': (np.float32, 'Vsini from CCF fit', kms),
        'VRAD_CCF': (np.float32,
                     'Initial velocity from cross-correlation', kms),
        'TARGETID': (np.int64, 'DESI targetid', ''),
        'EXPID': (np.int64, 'DESI exposure id', ''),
        'SUCCESS': (bool, 'Did we succeed or fail', ''),
        'RVS_WARN': (np.int64, 'RVSpecFit warning flag', ''),
        'RR_Z': (np.float64, 'Redrock redshift', ''),
        'RR_SPECTYPE': (str, 'Redrock spectype', ''),
        'RR_SUBTYPE': (str, 'Redrock spectroscopic subtype', ''),
    }
    for s in setups:
        su = s.upper()
        desc[f'SN_{su}'] = (np.float32, f'Median S/N in the {su} arm',
                            '')
        desc[f'CHISQ_{su}'] = (np.float64,
                               f'Chi-square in the {su} arm', '')
        desc[f'CHISQ_C_{su}'] = (
            np.float64, f'Chi-square in the {su} arm after fitting '
            'continuum only', '')
    return desc


# --------------------------- main fit -----------------------------

def _prepare_one(fname, config, setups=('b', 'r', 'z'), minsn=-1e9,
                 fit_targetid=None, expid_range=None,
                 use_resolution_matrix=False, zbest_path=None,
                 zbest_select=False, objtype_mask=None, objtypes=None,
                 target_tables=None, fitarm=None, prehdus=None):
    """Host stage of one file: read (or take ``prehdus``, the file as
    the lookahead reader read it), validate, select, stack arms.

    Returns a dict with what the group fit and the writers need; when
    nothing is selected (``nsel == 0``) it holds only what
    :func:`_write_empty` needs.
    """
    if fitarm is not None:
        setups = tuple(s for s in setups if s in fitarm)
        if not setups:
            raise RuntimeError('--fitarm excluded every arm')
    fp = prehdus if prehdus is not None else fitsio.read(fname)
    if not valid_file(fp, setups):
        raise RuntimeError(f'{fname}: invalid file')
    fibermap = fp['FIBERMAP'].data
    scores = fp['SCORES'].data if 'SCORES' in fp else None
    exp_fibermap = fp['EXP_FIBERMAP'].data if 'EXP_FIBERMAP' in fp \
        else None
    fluxes, ivars, masks, waves, resolutions = read_data(fp, setups)
    sns = get_sns_from_scores(scores, setups) or \
        {s: get_sns(fluxes[s], ivars[s], masks[s]) for s in setups}
    sn_max = np.max(np.array([sns[s] for s in setups]), axis=0)

    subset, rr_info = select_fibers_to_fit(
        fibermap, sn_max, minsn=minsn, fit_targetid=fit_targetid,
        expid_range=expid_range, zbest_path=zbest_path,
        zbest_select=zbest_select, objtype_mask=objtype_mask,
        objtypes=objtypes, target_tables=target_tables)
    nsel = int(subset.sum())
    logging.info('%s: selected %d/%d fibers', fname, nsel, len(subset))
    prep = dict(fname=fname, setups=setups, waves=waves,
                spectrum_header=fp[0].header, fibermap=fibermap,
                scores=scores, exp_fibermap=exp_fibermap, sns=sns,
                rr_info=rr_info, zbest_path=zbest_path, nsel=nsel)
    if nsel == 0:
        return prep
    arms, goodmask = build_batch_arms(
        waves, fluxes, ivars, masks, resolutions, subset, setups,
        use_resolution_matrix=use_resolution_matrix,
        lsf_sigma0_angstrom=config.get('lsf_sigma0_angstrom') or {})
    prep.update(arms=arms, goodmask=goodmask, idx=np.nonzero(subset)[0])
    return prep


def _ccf_args(arms):
    """Arm tuples consumed by the batched CCF fitter."""
    return [(a.setup, a.lam, a.flux,
             1.0 / np.sqrt(np.maximum(a.ivar, 1e-30)), a.badmask)
            for a in arms]


class _LazyFit(collections.abc.Mapping):
    """A group fit whose tail (BatchedFitter.run_tail_async) may still
    be running: the first access to a key (from proc_many's writer
    thread) collects the tail, once, under a lock, and merges it with
    ``base``, the CCF and Nelder-Mead results.  An error of the tail is
    kept and raised again at every access, so that every member file's
    writer sees it (and the group's per-file retry runs)."""

    def __init__(self, collect, base):
        self._collect = collect
        self._base = base
        self._value = self._exc = None
        self._lock = threading.Lock()

    def materialize(self):
        """The fit's dict, as :func:`_run_group_fit` returns it without
        deferring the tail."""
        with self._lock:
            if self._exc is not None:
                raise self._exc
            if self._value is None:
                try:
                    with trace.span('fit.tail_collect'):
                        tail = self._collect()
                    self._value = _group_result(self._base, tail)
                except BaseException as exc:
                    self._exc = exc
                    raise
            return self._value

    def __getitem__(self, key):
        return self.materialize()[key]

    def __iter__(self):
        return iter(self.materialize())

    def __len__(self):
        return len(self.materialize())


def _group_result(base, tail):
    """A group fit's dict from the CCF/NM part ``base`` and the tail's
    (BatchedFitter.run_tail) results."""
    phases = dict(base['phases'], **tail['phases'])
    logging.debug('fit phases: %s', ' '.join(
        f'{k}={v:.2f}s' for k, v in phases.items()))
    return dict(base, ref=tail['ref'], params=tail['params'],
                vsini=tail['vsini'], errs=tail['errs'],
                bad_hess=tail['bad_hess'], mods=tail['mods'], x=tail['x'],
                fun=tail['fun'], phases=phases)


def _run_group_fit(arms, templates, config, options, banks=None,
                   ccf_init=True, ccf_collect=None, defer=None,
                   before_tail=None):
    """Fit a stacked fiber batch: list of BatchArm, setup ->
    TemplateModel (all on one device), config (min_vel, max_vel,
    vel_step0, min_vel_step, max_vsini, min_vsini, second_minimizer,
    optional fit_microbatch and pipeline_warm, and template_lib where
    ``banks`` is None), fitter options.  ``config['fit_microbatch']``
    fits the fibers in tiles of at most that many (BatchedFitter's
    ``microbatch``), which bounds device memory; unset, the group is
    fitted whole.  On a host with several cards the fitter is sharded
    over them (parallel/mesh.auto_shard).  ``config['pipeline_warm']``
    builds the kernel libraries first (pipeline/prewarm.build_kernels).

    CCF starts -> Nelder-Mead -> gradient polish -> velocity refinement
    -> AD Hessian errors -> best-fit models.  A CCF failure raises (the
    reference logs it and starts every fiber at the default
    parameters); a fiber whose CCF chi-square is not finite starts at
    DEFAULT_START, as in the reference.  Without ``ccf_init`` the first
    fiber's brute-force start (vel_fit.firstguess) seeds every fiber at
    velocity 0, and no CCF columns are returned.  ``ccf_collect``: the
    group's CCF already dispatched (fit/ccf.fit_batch_async's collect,
    proc_many's prep pipeline), whose error raises here as a CCF
    failure.

    ``defer`` (None: ``RVST_DEFER_TAIL`` is not ``0``): return after
    Nelder-Mead a :class:`_LazyFit` whose tail runs on a worker thread
    (BatchedFitter.run_tail_async); else run the tail here.  A deferred
    tail starts after ``before_tail()`` returns (proc_many's: the wait
    for the group before to be written) and after an eager evaluation
    at Nelder-Mead's optima on this thread (BatchedFitter.
    check_neldermead, which holds replayed CUDA graphs to it), both
    inside the span ``fit.group`` and outside ``fit.nm``.

    ``banks`` : optional {setup: (tfft, t2fft, info)} in-memory CCF
    banks; None loads them from the library onto the templates' device.
    Returns per-fiber host arrays: ref, params, vsini, errs, bad_hess,
    mods, converged, ccf_cols, vrad_ccf, parnames, and phases (seconds
    per stage, each measured on the thread that ran it: ccf, nm,
    polish, refine, hessian, models; the seconds of the spans
    ``fit.ccf_collect`` (``fit.bruteforce`` without ``ccf_init``) and
    ``fit.nm`` inside ``fit.group``, and of the tail's,
    :mod:`rvspecfit_torch.trace`).
    """
    if defer is None:
        defer = os.environ.get('RVST_DEFER_TAIL', '1') != '0'
    nf = arms[0].nfibers
    parnames = templates[arms[0].setup].parnames
    device = next(iter(templates.values())).geom.h.device
    if config.get('pipeline_warm') and device.type == 'cuda':
        from rvspecfit_torch.pipeline import prewarm
        prewarm.build_kernels()
    with trace.span('fit.group', fibres=nf):
        with trace.span('fit.ccf_collect' if ccf_init
                        else 'fit.bruteforce') as sp_ccf:
            if ccf_init:
                start_params, start_vel, start_vsini, has_vs, ccf_cols = \
                    ccf_starts(arms, parnames, config, banks, device,
                               collect=ccf_collect)
            else:
                start_params, start_vel, start_vsini, has_vs = \
                    bruteforce_starts(arms, parnames, templates, config,
                                      options)
                ccf_cols = {}
            vrad_ccf = start_vel.copy()

        with trace.span('fit.nm') as sp_nm:
            # rotation is modeled only when the CCF bank's best templates
            # (or the brute-force start) carried vsini
            fit_vsini = bool(has_vs.any())
            bf = BatchedFitter(arms, templates, config, options=options,
                               use_vsini=fit_vsini,
                               microbatch=config.get('fit_microbatch'))
            mesh = pmesh.auto_shard(bf)
            if mesh is not None:
                logging.info('fitter sharded over %d devices', len(mesh))
            paramDict0 = dict(zip(parnames, start_params.mean(axis=0)))
            if fit_vsini:
                paramDict0['vsini'] = 0.01
            mapper = vel_fit.ParamMapper(
                parnames, paramDict0, [],
                vel_fit.VSiniMapper(config['max_vsini'],
                                    config.get('min_vsini') or 0.0)
                if fit_vsini else None, fit_vsini)
            x0 = np.zeros((nf, mapper.nvec))
            x0[:, 0] = start_vel
            if fit_vsini:
                x0[:, 1] = np.clip(start_vsini, 0, config['max_vsini'])
            x0[:, 1 + int(fit_vsini):] = start_params
            nmres = bf.run_neldermead(mapper, start_vel, x0=x0)
        if defer and before_tail is not None:
            before_tail()
        bf.check_neldermead(mapper, nmres)

    base = dict(converged=nmres['converged'], ccf_cols=ccf_cols,
                vrad_ccf=vrad_ccf, parnames=parnames, nm=nmres,
                phases=dict(ccf=sp_ccf.seconds, nm=sp_nm.seconds))
    tail_args = (mapper, nmres['x'])
    tail_kw = dict(fun=nmres['fun'], parnames=parnames,
                   polish=bool(config.get('second_minimizer')))
    if defer:
        return _LazyFit(bf.run_tail_async(*tail_args, **tail_kw), base)
    return _group_result(base, bf.run_tail(*tail_args, **tail_kw))


def ccf_starts(arms, parnames, config, banks, device, collect=None):
    """Per-fiber starts from the batched CCF (fit/ccf.fit_batch, or the
    ``collect`` of one already dispatched): (params (B, ndim), vel
    (B,), vsini (B,), has_vsini (B,), CCF columns)."""
    cres = collect() if collect is not None else ccf_mod.fit_batch(
        _ccf_args(arms), config, banks=banks, device=device)
    order = [cres['parnames'].index(p) for p in parnames]
    start_params = np.array(cres['best_params'], np.float64)[:, order]
    start_vel = np.array(cres['best_vel'], np.float64)
    vs = cres['best_vsini']
    has_vs = np.isfinite(vs)
    bad = ~np.isfinite(cres['best_chi'])
    if bad.any():
        logging.warning('CCF failed for %d fibers', bad.sum())
        start_params[bad] = DEFAULT_START[:len(parnames)]
        start_vel[bad] = 0.0
    ccf_cols = dict(CHISQ_CCF=cres['best_chi'],
                    VSINI_CCF=np.where(has_vs, vs, 0.0))
    for j, p in enumerate(parnames):
        ccf_cols[PARAM_NAMES.get(p, p.upper()) + '_CCF'] = \
            start_params[:, j]
    return start_params, start_vel, np.where(has_vs, vs, 0.0), has_vs, \
        ccf_cols


def bruteforce_starts(arms, parnames, templates, config, options):
    """Every fiber starts at the first fiber's brute-force start
    (vel_fit.firstguess over its arms) and velocity 0, as in the
    reference: (params, vel, vsini, has_vsini)."""
    nf = arms[0].nfibers
    guess = vel_fit.firstguess(
        [SpecData(a.setup, a.lam, a.flux[0], 1.0 / np.sqrt(a.ivar[0]))
         for a in arms], config=config, options=options,
        templates=templates)
    start_params = np.tile([guess[p] for p in parnames], (nf, 1)) \
        .astype(np.float64)
    has_vs = np.full(nf, guess.get('vsini') is not None)
    start_vsini = np.full(nf, float(guess.get('vsini') or 0.0))
    return start_params, np.zeros(nf), start_vsini, has_vs


def make_plot(lam_list, flux_list, model_list, title, fig_fname):
    """Diagnostic plot of the data and best-fit models of each arm
    (reference: desi_fit.py:159-222).  matplotlib is imported here, so
    only a run that plots needs it."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    plt.figure(figsize=(10, 4), dpi=100)
    for lam, fl, mo in zip(lam_list, flux_list, model_list):
        plt.plot(lam, fl, 'k-', lw=0.5)
        plt.plot(lam, mo, 'r-', lw=0.8)
    plt.title(title, fontsize=8)
    plt.xlabel('Wavelength [A]')
    plt.tight_layout()
    try:
        plt.savefig(fig_fname)
    finally:
        plt.close()


def _finish_one(prep, fit, lo, tab_ofname, mod_ofname, config, arms,
                cmdline=None, templates=None, fig_prefix=None):
    """Assemble one file's rows from its slice [lo, lo+nsel) of a
    (possibly multi-file) group fit and write RVTAB/RVMOD; with
    ``fig_prefix``, one plot per fiber, ``{fig_prefix}_{TARGETID}.png``
    (a plot that fails is logged, as in the reference)."""
    nf = prep['nsel']
    sl = slice(lo, lo + nf)
    ref = {k: np.asarray(v)[sl] for k, v in fit['ref'].items()}
    mods = {k: {an: np.asarray(v)[sl] for an, v in d.items()}
            for k, d in fit['mods'].items()}
    params_b = np.asarray(fit['params'])[sl]
    errs = np.asarray(fit['errs'])[sl]
    idx = prep['idx']
    sns = prep['sns']
    setups = prep['setups']
    fibermap = prep['fibermap']
    goodmask = prep['goodmask']

    res = {}
    res['VRAD'] = ref['best_vel']
    res['VRAD_ERR'] = ref['vel_err']
    res['VRAD_SKEW'] = ref['skewness']
    res['VRAD_KURT'] = ref['kurtosis']
    res['VSINI'] = np.asarray(fit['vsini'])[sl]
    for i, p in enumerate(fit['parnames']):
        res[PARAM_NAMES.get(p, p.upper())] = params_b[:, i]
        res[PARAM_NAMES.get(p, p.upper()) + '_ERR'] = errs[:, i]
    res['CHISQ_TOT'] = np.sum([mods['chisq'][a.name] for a in arms],
                              axis=0)
    res['CHISQ_C_TOT'] = np.sum([mods['cont_chisq'][a.name]
                                 for a in arms], axis=0)
    res['NPIX_TOT'] = np.sum([mods['npix'][a.name] for a in arms],
                             axis=0).astype(np.float64)
    for s, a in zip(setups, arms):
        res['CHISQ_%s' % s.upper()] = mods['chisq'][a.name]
        res['CHISQ_C_%s' % s.upper()] = mods['cont_chisq'][a.name]
        res['SN_%s' % s.upper()] = sns[s][idx]
    res['VRAD_CCF'] = np.asarray(fit['vrad_ccf'])[sl]
    for k, v in fit['ccf_cols'].items():
        res[k] = np.asarray(v)[sl]
    res['BAD_HESSIAN'] = np.asarray(fit['bad_hess'])[sl]
    res['SUCCESS'] = np.asarray(fit['converged'])[sl] & goodmask
    res['RVS_WARN'] = get_rvs_warn_batch(res, config)
    res['RVS_WARN'] |= np.where(~goodmask, bitmasks['BAD_SPECTRUM'], 0)
    res['TARGETID'] = fibermap['TARGETID'][idx]
    if 'EXPID' in fibermap:
        res['EXPID'] = fibermap['EXPID'][idx]
    for k, v in prep['rr_info'].items():
        res[k] = np.asarray(v)[idx]

    if fig_prefix:
        for k in range(nf):
            title = ('logg=%.1f teff=%.0f feh=%.1f alpha=%.1f '
                     'V=%.1f+/-%.1f' % (
                         res['LOGG'][k], res['TEFF'][k], res['FEH'][k],
                         res['ALPHAFE'][k], res['VRAD'][k],
                         res['VRAD_ERR'][k]))
            try:
                make_plot([a.lam for a in arms],
                          [a.flux[lo + k] for a in arms],
                          [mods['models'][a.name][k] for a in arms],
                          title, f'{fig_prefix}_{res["TARGETID"][k]}.png')
            except Exception as exc:
                logging.warning('plotting failed: %s', exc)

    _write_outputs(tab_ofname, mod_ofname, res, mods, arms,
                   prep['waves'], fibermap, idx, setups, config,
                   prep['fname'], scores=prep['scores'],
                   exp_fibermap=prep['exp_fibermap'],
                   cmdline=cmdline, templates=templates,
                   spectrum_header=prep['spectrum_header'],
                   zbest_path=prep['zbest_path'])


def _load_templates(config, setups, device):
    return library.load_template_models(
        config, {f'desi_{s}' for s in setups}, device=device)


def _write_empty_prep(prep, tab_ofname, mod_ofname, config, cmdline,
                      templates):
    _write_empty(tab_ofname, mod_ofname, prep['setups'], prep['waves'],
                 prep['fibermap'], scores=prep['scores'],
                 exp_fibermap=prep['exp_fibermap'], config=config,
                 cmdline=cmdline, templates=templates,
                 spectrum_header=prep['spectrum_header'],
                 zbest_path=prep['zbest_path'])


def proc_desi(fname, tab_ofname, mod_ofname, config, options,
              setups=('b', 'r', 'z'), minsn=-1e9, fit_targetid=None,
              expid_range=None, use_resolution_matrix=False,
              zbest_path=None, zbest_select=False, objtype_mask=None,
              objtypes=None, target_tables=None, templates=None,
              banks=None, device=None, fitarm=None, cmdline=None,
              ccf_init=True, fig_prefix=None, prehdus=None,
              defer_finish=False):
    """Fit every selected fiber of one DESI file; write RVTAB/RVMOD
    (and, with ``fig_prefix``, a plot per fiber: :func:`_finish_one`).

    ``templates`` ({setup: TemplateModel}) and ``banks`` ({setup:
    (tfft, t2fft, info)}) may come from memory; None loads them from
    ``config['template_lib']`` onto ``device`` (None: the CUDA card).
    ``ccf_init=False`` starts from the brute-force first guess
    (:func:`_run_group_fit`).  ``prehdus``: the file as the lookahead
    reader read it.  Returns the number of fitted objects (0 when
    nothing is selected); with ``defer_finish``, (that number,
    ``finish``) without writing: ``finish()`` writes the outputs (and
    collects a deferred tail), on proc_many's writer thread.
    """
    t0 = time.time()
    prep = _prepare_one(fname, config, setups=setups, minsn=minsn,
                        fit_targetid=fit_targetid,
                        expid_range=expid_range,
                        use_resolution_matrix=use_resolution_matrix,
                        zbest_path=zbest_path, zbest_select=zbest_select,
                        objtype_mask=objtype_mask, objtypes=objtypes,
                        target_tables=target_tables, fitarm=fitarm,
                        prehdus=prehdus)
    if prep['nsel'] == 0:
        def finish():
            _write_empty_prep(prep, tab_ofname, mod_ofname, config,
                              cmdline, templates)
    else:
        if templates is None:
            templates = _load_templates(config, prep['setups'], device)
        fit = _run_group_fit(prep['arms'], templates, config, options,
                             banks=banks, ccf_init=ccf_init)

        def finish():
            _finish_one(prep, fit, 0, tab_ofname, mod_ofname, config,
                        prep['arms'], cmdline=cmdline, templates=templates,
                        fig_prefix=fig_prefix)
            logging.info('%s: fitted %d fibers in %.1f s', fname,
                         prep['nsel'], time.time() - t0)
    if defer_finish:
        return prep['nsel'], finish
    finish()
    return prep['nsel']


def _log_crash(fname, info, throw):
    """Crash-isolation bookkeeping: a crash log in the working
    directory and the traceback in the log; re-raise with ``throw``
    (reference: desi_fit.py:1311).  Call it from an except block."""
    crashfile = 'crash_%d_%d.log' % (os.getpid(), int(time.time()))
    with open(crashfile, 'w') as fp:
        fp.write('File: %s\nInfo: %s\n' % (fname, info))
        fp.write(traceback.format_exc())
    logging.exception('Failed processing %s (crash log %s)', fname,
                      crashfile)
    if throw:
        raise


def _arm_group_key(prep):
    """Batch-compatibility key: files whose arms share names,
    wavelength grids and resolution band widths may be concatenated
    into one fit batch."""
    ks = []
    for a in prep['arms']:
        res = a.resolution
        h = hashlib.sha1(
            np.ascontiguousarray(a.lam).tobytes()).hexdigest()[:16]
        ks.append((a.name, a.setup, h,
                   None if res is None else int(np.asarray(res).shape[1])))
    return (tuple(prep['setups']), tuple(ks))


def _concat_arms(arm_lists):
    """Concatenate per-file BatchArm lists along the fiber axis."""
    out = []
    for parts in zip(*arm_lists):
        a0 = parts[0]
        res = None
        if a0.resolution is not None:
            res = np.concatenate(
                [np.asarray(p.resolution) for p in parts], axis=0)
        out.append(BatchArm(
            a0.name, a0.lam,
            np.concatenate([p.flux for p in parts], axis=0),
            np.concatenate([p.ivar for p in parts], axis=0),
            badmask=np.concatenate([p.badmask for p in parts], axis=0),
            resolution=res, setup=a0.setup))
    return out


def proc_desi_group(fnames, tab_ofnames, mod_ofnames, config, options,
                    templates=None, banks=None, device=None, cmdline=None,
                    throw_exceptions=False, zbest_paths=None,
                    ccf_init=True, fig_prefixes=None, **select_kw):
    """Fit several DESI files as one batch (``--coalesce``).

    The fibers of compatible files (same arm names, wavelength grids
    and band widths: :func:`_arm_group_key`) are concatenated and
    fitted together; every stage is elementwise over fibers, so each
    file's rows are those of a fit of that file alone, except that
    whether rotation is modeled is decided from the CCF result of the
    whole group (the reference decides per spectrum,
    desi_fit.py:293-299).

    Per-file crash isolation: a file that fails to read or prepare
    gets a crash log and a None count without sinking its group; if a
    group fit fails (its CCF, Nelder-Mead or tail), each member is
    retried alone.  ``select_kw`` are :func:`_prepare_one`'s selection
    arguments; ``fig_prefixes`` optional per-file plot prefixes
    (:func:`_finish_one`).  Returns per-file fitted-object counts (None
    = failure), aligned with ``fnames``.
    """
    gprep = prepare_desi_group(fnames, config, zbest_paths=zbest_paths,
                               throw_exceptions=throw_exceptions,
                               **select_kw)
    return fit_desi_group(gprep, tab_ofnames, mod_ofnames, config,
                          options, templates=templates, banks=banks,
                          device=device, cmdline=cmdline,
                          throw_exceptions=throw_exceptions,
                          ccf_init=ccf_init, fig_prefixes=fig_prefixes)


def prepare_desi_group(fnames, config, zbest_paths=None,
                       throw_exceptions=False, prehdus_list=None,
                       dispatch_ccf=False, ccf_init=True, banks=None,
                       device=None, **select_kw):
    """Host stage of a coalesced group: read (or take ``prehdus_list``,
    the lookahead reader's reads), select and stack every member file,
    and partition the live ones into arm-compatible units.  A member
    that fails to prepare gets a crash log and stays None in ``preps``.

    With ``dispatch_ccf`` (and ``ccf_init``) each unit's CCF is
    dispatched here (fit/ccf.fit_batch_async on the calling thread's
    stream, with ``banks`` or the library's on ``device``): proc_many
    runs this for the next group on a background thread while a group
    fits, so kernel B runs in the gaps the fit leaves on the card.  A
    dispatch that fails becomes a collect that raises it, so the group
    fit fails as on a synchronous CCF failure.

    Returns {fnames, preps, units: [{members, arms, ccf}]}, consumed by
    :func:`fit_desi_group`."""
    zbest_paths = zbest_paths or [None] * len(fnames)
    prehdus_list = prehdus_list or [None] * len(fnames)
    preps = [None] * len(fnames)
    for i, f in enumerate(fnames):
        try:
            preps[i] = _prepare_one(f, config, zbest_path=zbest_paths[i],
                                    prehdus=prehdus_list[i], **select_kw)
        except Exception:
            _log_crash(f, 'prepare', throw_exceptions)
    groups = {}
    for i, p in enumerate(preps):
        if p is not None and p['nsel'] > 0:
            groups.setdefault(_arm_group_key(p), []).append(i)
    units = []
    for members in groups.values():
        arms = _concat_arms([preps[i]['arms'] for i in members]) \
            if len(members) > 1 else preps[members[0]]['arms']
        ccf = None
        if dispatch_ccf and ccf_init:
            try:
                ccf = ccf_mod.fit_batch_async(_ccf_args(arms), config,
                                              banks=banks, device=device)
            except Exception as exc:
                ccf = functools.partial(_reraise, exc)
        units.append(dict(members=members, arms=arms, ccf=ccf))
    return dict(fnames=list(fnames), preps=preps, units=units)


def _reraise(exc):
    raise exc


def fit_desi_group(gprep, tab_ofnames, mod_ofnames, config, options,
                   templates=None, banks=None, device=None, cmdline=None,
                   throw_exceptions=False, ccf_init=True,
                   fig_prefixes=None, defer_finish=False, before_tail=None):
    """Fit and write stage of a group prepared by
    :func:`prepare_desi_group` (see :func:`proc_desi_group` for the
    semantics and the return value); ``before_tail``: as
    :func:`_run_group_fit`'s.

    Every write is kept in order and run by ``finish()``: at once, or
    with ``defer_finish`` on proc_many's writer thread, where this
    returns (counts, ``finish``) and ``finish()`` returns the counts.
    A unit's deferred tail is collected there; if it fails, the unit's
    per-file retry runs there too, as it does here when the unit's CCF
    or Nelder-Mead fails."""
    preps = gprep['preps']
    counts = [None] * len(preps)
    fig_prefixes = fig_prefixes or [None] * len(preps)
    pending = []

    def write(i, fit, lo, arms):
        try:
            with trace.span('driver.write', file=preps[i]['fname']):
                _finish_one(preps[i], fit, lo, tab_ofnames[i],
                            mod_ofnames[i], config, arms, cmdline=cmdline,
                            templates=templates, fig_prefix=fig_prefixes[i])
            counts[i] = preps[i]['nsel']
        except Exception:
            _log_crash(preps[i]['fname'], 'write', throw_exceptions)

    def write_empty(i, p):
        try:
            _write_empty_prep(p, tab_ofnames[i], mod_ofnames[i], config,
                              cmdline, templates)
            counts[i] = 0
        except Exception:
            _log_crash(p['fname'], 'write_empty', throw_exceptions)

    def retry(members, then):
        """The unit's fit failed (call from its except block): fit each
        member alone, its tail at once, and pass its write to
        ``then``."""
        logging.exception('group fit of %d files failed; retrying '
                          'per-file', len(members))
        if throw_exceptions:
            raise
        for i in members:
            try:
                fit = _run_group_fit(preps[i]['arms'], templates, config,
                                     options, banks=banks,
                                     ccf_init=ccf_init, defer=False)
            except Exception:
                _log_crash(preps[i]['fname'], 'per-file retry', False)
                continue
            then(functools.partial(write, i, fit, 0, preps[i]['arms']))

    def write_unit(unit, fit):
        if isinstance(fit, _LazyFit):
            try:
                fit.materialize()
            except Exception:
                retry(unit['members'], lambda job: job())
                return
        lo = 0
        for i in unit['members']:
            write(i, fit, lo, unit['arms'])
            lo += preps[i]['nsel']

    for i, p in enumerate(preps):
        if p is not None and p['nsel'] == 0:
            pending.append(functools.partial(write_empty, i, p))
    if gprep['units'] and templates is None:
        first = gprep['units'][0]['members'][0]
        templates = _load_templates(config, preps[first]['setups'], device)

    for unit in gprep['units']:
        try:
            fit = _run_group_fit(unit['arms'], templates, config, options,
                                 banks=banks, ccf_init=ccf_init,
                                 ccf_collect=unit.get('ccf'),
                                 before_tail=before_tail)
        except Exception:
            retry(unit['members'], pending.append)
            continue
        pending.append(functools.partial(write_unit, unit, fit))

    def finish():
        for job in pending:
            job()
        return counts

    if defer_finish:
        return counts, finish
    return finish()


# packages whose versions are stamped into output headers, by import
# name and distribution name (reference: desi_fit.py:45-48, 77-90)
DEPEND_PACKAGES = dict(numpy='numpy', scipy='scipy', torch='torch',
                       h5py='h5py', yaml='PyYAML')

# input header keywords copied into the output primary header
# (reference: desi_fit.py:141-149)
COPY_HEADER_KEYS = ['SPGRP', 'SPGRPVAL', 'TILEID', 'SPECTRO', 'PETAL',
                    'NIGHT', 'EXPID', 'HPXPIXEL', 'HPXNSIDE', 'HPXNEST']


@functools.lru_cache(maxsize=1)
def _dep_versions():
    ret = {'python': sys.version.split(' ')[0],
           'rvspecfit_torch': __version__}
    for name, dist in DEPEND_PACKAGES.items():
        try:
            ret[name] = importlib.metadata.version(dist)
        except importlib.metadata.PackageNotFoundError:
            pass
    return ret


def _prim_header(config=None, cmdline=None, templates=None,
                 spectrum_header=None, zbest_path=None):
    """Primary-header provenance cards: dependency versions, template
    library revisions, copied input keywords
    (reference: desi_fit.py:119-156)."""
    cards = [('RVS_VER', __version__, 'rvspecfit_torch version'),
             ('RVS_DATE', time.strftime('%Y-%m-%dT%H:%M:%S'),
              'processing time')]
    for i, (k, v) in enumerate(_dep_versions().items()):
        cards.append(('DEPNAM%02d' % i, k, 'Software'))
        cards.append(('DEPVER%02d' % i, v, 'Version'))
    if templates:
        for i, (setup, tm) in enumerate(sorted(templates.items())):
            extra = getattr(tm, 'extra', None) or {}
            cards.append(('TMPLCON%d' % i, setup, 'Spec arm config name'))
            cards.append(('TMPLREV%d' % i, extra.get('revision', ''),
                          'Spec template revision'))
            cards.append(('TMPLSVR%d' % i,
                          extra.get('creation_soft_version', ''),
                          'Spec template soft version'))
    if config is not None:
        cards.append(('RVS_CONF', str(config.get('config_file_path', '')),
                      'config path'))
    if cmdline:
        cards.append(('RVS_CMD', cmdline[:60], 'command line'))
    if zbest_path is not None:
        cards.append(('RR_FILE', str(zbest_path),
                      'Redrock redshift file'))
    if spectrum_header is not None:
        for key in COPY_HEADER_KEYS:
            if key in spectrum_header:
                cards.append((key, spectrum_header[key], ''))
    return cards


def _write_empty(tab_ofname, mod_ofname, setups, waves, fibermap,
                 scores=None, exp_fibermap=None, config=None,
                 cmdline=None, templates=None, spectrum_header=None,
                 zbest_path=None):
    """Zero-selection outputs with the full column structure, so
    downstream concatenation tools see a uniform schema
    (reference: desi_fit.py:1106-1134)."""
    col_desc = get_column_desc([s.upper() for s in setups])
    cols, units, comments = [], {}, {}
    for k, (dtype, descr, unit) in col_desc.items():
        arr = np.zeros(0, dtype=np.dtype('U8') if dtype is str else dtype)
        cols.append((k, arr))
        comments[k] = descr
        if unit:
            units[k] = unit
    idx0 = np.zeros(0, dtype=int)
    fm_cols = [(k, np.asarray(v)[idx0]) for k, v in fibermap.items()]
    hdr = _prim_header(config, cmdline, templates, spectrum_header,
                       zbest_path)
    hdus = [dict(kind='image', data=None, header=hdr),
            dict(kind='table', data=cols, name='RVTAB', units=units,
                 comments=comments),
            dict(kind='table', data=fm_cols, name='FIBERMAP')]
    if scores is not None:
        hdus.append(dict(kind='table', name='SCORES',
                         data=[(k, np.asarray(v)[idx0])
                               for k, v in scores.items()]))
    if exp_fibermap is not None:
        hdus.append(dict(kind='table', name='EXP_FIBERMAP',
                         data=[(k, np.asarray(v)[idx0])
                               for k, v in exp_fibermap.items()]))
    fitsio.write(tab_ofname, hdus)

    mhdus = [dict(kind='image', data=None, header=hdr)]
    for s in setups:
        mhdus.append(dict(kind='image', data=waves[s].astype(np.float64),
                          name=f'{s.upper()}_WAVELENGTH'))
        mhdus.append(dict(kind='image', data=None,
                          name=f'{s.upper()}_MODEL'))
    fitsio.write(mod_ofname, mhdus)


def _write_outputs(tab_ofname, mod_ofname, res, mods, arms, waves,
                   fibermap, idx, setups, config, src_fname,
                   scores=None, exp_fibermap=None, cmdline=None,
                   templates=None, spectrum_header=None,
                   zbest_path=None):
    """RVTAB (rows ``res`` with the reference's column dtypes,
    descriptions and units, a FIBERMAP subset, SCORES and EXP_FIBERMAP
    of the fitted targets) and RVMOD (per-arm wavelengths and float32
    best-fit models)."""
    col_desc = get_column_desc([s.upper() for s in setups])
    cols, units, comments = [], {}, {}
    for k, v in res.items():
        if k == 'BAD_HESSIAN':
            continue
        v = np.asarray(v)
        if v.dtype == object:
            v = v.astype(str)
        if k in col_desc:
            dtype, descr, unit = col_desc[k]
            if dtype is not str and v.dtype.kind not in 'US':
                v = v.astype(dtype)
            comments[k] = descr
            if unit:
                units[k] = unit
        elif v.dtype.kind == 'f':
            v = v.astype(np.float32)
        cols.append((k, v))
    fm_keep = ['TARGETID', 'TARGET_RA', 'TARGET_DEC', 'REF_ID',
               'REF_CAT', 'FIBER', 'DESI_TARGET', 'PMRA', 'PMDEC']
    fm_cols = [(k, np.asarray(fibermap[k])[idx]) for k in fm_keep
               if k in fibermap]
    prim_hdr = _prim_header(config, cmdline, templates, spectrum_header,
                            zbest_path)
    hdus = [dict(kind='image', data=None, header=prim_hdr),
            dict(kind='table', data=cols, name='RVTAB',
                 units=units, comments=comments),
            dict(kind='table', data=fm_cols, name='FIBERMAP')]
    if scores is not None:
        hdus.append(dict(
            kind='table', name='SCORES',
            data=[(k, np.asarray(v)[idx]) for k, v in scores.items()]))
    if exp_fibermap is not None and 'TARGETID' in exp_fibermap:
        sub = np.isin(exp_fibermap['TARGETID'],
                      np.asarray(fibermap['TARGETID'])[idx])
        hdus.append(dict(
            kind='table', name='EXP_FIBERMAP',
            data=[(k, np.asarray(v)[sub])
                  for k, v in exp_fibermap.items()]))
    fitsio.write(tab_ofname, hdus)

    mhdus = [dict(kind='image', data=None, header=prim_hdr)]
    for s, a in zip(setups, arms):
        mhdus.append(dict(kind='image', data=waves[s].astype(np.float64),
                          name=f'{s.upper()}_WAVELENGTH'))
        mhdus.append(dict(kind='image',
                          data=mods['models'][a.name].astype(np.float32),
                          name=f'{s.upper()}_MODEL'))
    fitsio.write(mod_ofname, mhdus)


def proc_desi_wrapper(*args, **kwargs):
    """Crash isolation around :func:`proc_desi`: log, write a crash
    log and return None (reference: desi_fit.py:1311)."""
    throw = kwargs.pop('throw_exceptions', False)
    try:
        return proc_desi(*args, **kwargs)
    except Exception:
        _log_crash(args[0] if args else '?',
                   'Args: %s %s' % (args, kwargs), throw)
        return None


def _base_name(fname):
    """A file's name without ``coadd-``/``spectra-`` and ``.fits``."""
    base = os.path.basename(fname)
    for pref in ('coadd-', 'spectra-'):
        if base.startswith(pref):
            base = base[len(pref):]
    return base.replace('.fits', '')


def output_paths(fname, output_dir, output_tab_prefix=TABLE_PREFIX,
                 output_mod_prefix=MODEL_PREFIX):
    """(RVTAB path, RVMOD path) of an input file: ``coadd-``/``spectra-``
    and ``.fits`` are taken off its name."""
    base = _base_name(fname)
    return (os.path.join(output_dir, f'{output_tab_prefix}-{base}.fits'),
            os.path.join(output_dir, f'{output_mod_prefix}-{base}.fits'))


def static_file_list(files):
    """The list of a statically known input (a list or tuple, a
    FileQueue over a list or a file read once, a ShardedFileQueue), or
    None for a queue (a lock-file FileQueue, a CoordinatedFileQueue, any
    other iterable), whose items are claimed as they are fitted."""
    if isinstance(files, (list, tuple)):
        return list(files)
    if isinstance(files, utils.FileQueue) and not files.queue:
        return list(files)
    if isinstance(files, utils.ShardedFileQueue):
        return list(files.files)
    return None


class _Reader:
    """proc_many's lookahead reads: :meth:`start` reads files on a
    daemon thread; :meth:`take` waits for one file's read and returns
    its FITSFile, or None where it was not started or its read failed
    (the caller then reads it itself, under its crash isolation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reads = {}

    def start(self, fnames):
        todo = []
        with self._lock:
            for f in fnames:
                if f not in self._reads:
                    self._reads[f] = concurrent.futures.Future()
                    todo.append((f, self._reads[f]))
        if todo:
            threading.Thread(target=self._read, args=(todo,), daemon=True,
                             name='rvst-reader').start()

    @staticmethod
    def _read(todo):
        for f, fut in todo:
            try:
                with trace.span('driver.read', file=f):
                    hdus = fitsio.read(f)
                fut.set_result(hdus)
            except Exception:
                fut.set_result(None)

    def take(self, fname):
        with self._lock:
            fut = self._reads.pop(fname, None)
        if fut is None:
            return None
        with trace.span('driver.read_wait', file=fname):
            return fut.result()


class _Writer:
    """proc_many's finishing stage: :meth:`submit` runs a file's or a
    group's ``finish()`` (collect the deferred tail, rows, RVTAB/RVMOD,
    plots; it returns the counts) on one writer thread, at most one
    outstanding, and then ``record(counts, t_done)`` (the status
    lines), ``t_done`` the time the write completed; :meth:`put`
    queues a record with no write.  Records are made in submission
    order.  Without ``threaded`` (``RVST_ASYNC_WRITE=0``) a finish runs
    at once on the calling thread.  A finish that raises (crash
    isolation re-raises only with ``throw_exceptions``) raises from the
    next :meth:`submit`, :meth:`put` or :meth:`close`."""

    def __init__(self, threaded):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='rvst-writer') \
            if threaded else None
        self._queue = collections.deque()

    @staticmethod
    def _timed(finish, device, files):
        if device is not None:
            enter_device(device)
        with trace.span('driver.finish', files=files):
            out = finish()
        return out, time.time()

    def submit(self, finish, record, device=None, files=None):
        """``device``: the card the writer thread enters first (a tail
        that fails is retried there); ``files``: how many files the
        finish writes (an attribute of its span).  The wait for the
        one before is the span ``driver.write_wait``."""
        if self._queue:
            with trace.span('driver.write_wait'):
                self.drain()
        if self._pool is None:
            record(*self._timed(finish, None, files))
        else:
            self._queue.append((self._pool.submit(self._timed, finish,
                                                  device, files), record))

    def wait(self):
        """Wait (the span ``driver.write_wait``) until every finish
        submitted has run, leaving their results and errors to
        :meth:`drain`."""
        futs = [fut for fut, _ in self._queue if fut is not None]
        if futs:
            with trace.span('driver.write_wait'):
                concurrent.futures.wait(futs)

    def put(self, record, value=None):
        if self._queue:
            self._queue.append((None, functools.partial(record, value)))
        else:
            record(value, time.time())

    def drain(self):
        while self._queue:
            fut, record = self._queue.popleft()
            if fut is None:
                record(time.time())
            else:
                record(*fut.result())

    def close(self):
        try:
            self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


def proc_many(files, output_dir, output_tab_prefix=TABLE_PREFIX,
              output_mod_prefix=MODEL_PREFIX, config=None, options=None,
              skipexisting=False, status_fname=None, coalesce=1,
              templates=None, banks=None, device=None,
              throw_exceptions=False, cmdline=None, zbest_select=False,
              ccf_init=True, doplot=False, figure_dir=None,
              figure_prefix='fig', **select_kw):
    """Process a sequence of files, one group after another, with the
    reference's overlaps (reference: desi_fit.py:1392-1551; the module
    docstring lists the overlaps and their switches).
    ``ccf_init=False`` starts every group from the brute-force first
    guess instead of the CCF (``--param_init bruteforce``).

    ``files``: a list, or one of utils.FileQueue,
    utils.ShardedFileQueue or parallel/distributed.CoordinatedFileQueue
    (:func:`static_file_list`).  Only a static list is read up front
    and read ahead; a queue's items are claimed one at a time, each
    when the previous one is fitted (its write may still run on the
    writer thread), and a queue runs at coalesce 1 (an early claim
    would take work from the other processes and widen the window of
    files lost to a crash).

    ``coalesce``: fit up to this many consecutive compatible files as
    one batch (:func:`prepare_desi_group`, :func:`fit_desi_group`); 1
    fits file by file through :func:`proc_desi_wrapper`.
    ``skipexisting`` skips a file whose outputs both exist (status
    EXISTING).  ``status_fname`` gets one line per file
    (:func:`update_process_status_file`), in the order of the files,
    stamped when the file's write completed; the seconds of a coalesced
    group (from the start of its fit to the end of its write) are
    shared equally by its files.  ``zbest_select`` selects star-like
    fibers with the ``redrock-`` file beside each ``coadd-`` file.
    ``doplot`` writes a plot per fiber into ``figure_dir`` (default:
    ``output_dir``), named ``{figure_prefix}-{file}_{TARGETID}.png``.
    ``templates``/``banks``: as in :func:`proc_desi`; the templates are
    loaded once, before the first file that is fitted, and a loading
    failure raises.  ``select_kw``: :func:`_prepare_one`'s selection
    arguments.  The writer is drained before this returns or raises, so
    with ``throw_exceptions`` a failed write raises here.
    """
    os.makedirs(output_dir, exist_ok=True)
    if status_fname:
        update_process_status_file(status_fname, None, None, 0, 0,
                                   start=True)
    options = options or {}
    flist = static_file_list(files)
    coalesce = max(1, int(coalesce or 1))
    if coalesce > 1 and flist is None:
        logging.info('--coalesce needs a statically-known file list; '
                     'queue inputs are fitted one file at a time')
        coalesce = 1
    async_write = os.environ.get('RVST_ASYNC_WRITE', '1') != '0'
    pipeline = os.environ.get('RVST_PIPELINE_PREP', '1') != '0'

    def status(f, nobj, seconds, code=None, finished_at=None):
        if status_fname:
            update_process_status_file(
                status_fname, f, code or (PROC_STATUS_SUCCESS if nobj
                                          is not None else
                                          PROC_STATUS_FAILURE),
                nobj or 0, seconds, finished_at=finished_at)

    def zbest_path(f):
        if not zbest_select:
            return None
        cand = os.path.join(os.path.dirname(f), os.path.basename(f)
                            .replace('coadd-', 'redrock-'))
        return cand if os.path.exists(cand) else None

    def fig_prefix(f):
        if not doplot:
            return None
        fdir = figure_dir or output_dir
        os.makedirs(fdir, exist_ok=True)
        return os.path.join(fdir, f'{figure_prefix}-{_base_name(f)}')

    def items():
        """('skip', file, seconds) for a file whose outputs exist, and
        ('group', [(file, tab, mod)...]) of up to ``coalesce`` files to
        fit, in input order; a queue's item is claimed when the loop
        asks for the next item."""
        grp = []
        for f in (files if flist is None else flist):
            t0 = time.time()
            tab, mod = output_paths(f, output_dir, output_tab_prefix,
                                    output_mod_prefix)
            if skipexisting and os.path.exists(tab) \
                    and os.path.exists(mod):
                logging.info('skipping existing %s', f)
                yield 'skip', f, time.time() - t0
                continue
            grp.append((f, tab, mod))
            if len(grp) == coalesce:
                yield 'group', grp
                grp = []
        if grp:
            yield 'group', grp

    def prepare(grp, dispatch=False):
        names = [g[0] for g in grp]
        with trace.span('driver.prep', files=len(names)) as sp:
            gprep = prepare_desi_group(
                names, config, zbest_paths=[zbest_path(f) for f in names],
                throw_exceptions=throw_exceptions,
                prehdus_list=[reader.take(f) for f in names],
                dispatch_ccf=dispatch, ccf_init=ccf_init, banks=banks,
                device=tdev, zbest_select=zbest_select, **select_kw)
            sp.set(fibres=_fibres(gprep))
        return gprep

    def recorder(grp, t0):
        def record(counts, t_done):
            dt = (t_done - t0) / len(grp)
            for (f, _, _), nobj in zip(grp, counts or [None] * len(grp)):
                status(f, nobj, dt, finished_at=t_done)
        return record

    seq = items()
    if flist is not None:
        seq = list(seq)
    later = [it[1] for it in seq if it[0] == 'group'] \
        if flist is not None else []
    reader, writer = _Reader(), _Writer(async_write)
    tdev = nxt_prep = None
    try:
        for item in seq:
            if item[0] == 'skip':
                writer.put(lambda value, t_done, f=item[1], dt=item[2]:
                           status(f, 0, dt, PROC_STATUS_EXISTING, t_done))
                continue
            grp = item[1]
            t0 = time.time()
            if templates is None:
                templates = _load_templates(
                    config, select_kw.get('setups', ('b', 'r', 'z')),
                    device)
            tdev = next(iter(templates.values())).geom.h.device
            if later:
                later.pop(0)
            nxt = later[0] if later else None
            if nxt is not None:
                # the next group's reads overlap this group's fit
                reader.start([g[0] for g in nxt])
            if coalesce == 1:
                f, tab, mod = grp[0]
                out = proc_desi_wrapper(
                    f, tab, mod, config, options, templates=templates,
                    banks=banks, cmdline=cmdline,
                    zbest_path=zbest_path(f), zbest_select=zbest_select,
                    throw_exceptions=throw_exceptions, ccf_init=ccf_init,
                    fig_prefix=fig_prefix(f), prehdus=reader.take(f),
                    defer_finish=async_write, **select_kw)
                if async_write and out is not None:
                    nsel, finish = out
                    writer.submit(functools.partial(
                        _finish_file, f, nsel, finish, throw_exceptions),
                        recorder(grp, t0), tdev, files=1)
                else:
                    writer.put(recorder(grp, t0), [out])
                continue
            with trace.span('driver.group', files=len(grp)) as sp:
                if nxt_prep is not None:
                    with trace.span('driver.prep_wait'):
                        gprep = nxt_prep.result()
                else:
                    gprep = prepare(grp)
                sp.set(fibres=_fibres(gprep))
                nxt_prep = None
                if pipeline and nxt is not None:
                    nxt_prep = Background(functools.partial(
                        prepare, nxt, dispatch=True), tdev,
                        name='rvst-prep')
                out = fit_desi_group(
                    gprep, [g[1] for g in grp], [g[2] for g in grp],
                    config, options, templates=templates, banks=banks,
                    cmdline=cmdline, throw_exceptions=throw_exceptions,
                    ccf_init=ccf_init,
                    fig_prefixes=[fig_prefix(g[0]) for g in grp],
                    defer_finish=async_write, before_tail=writer.wait)
                if async_write:
                    writer.submit(out[1], recorder(grp, t0), tdev,
                                  files=len(grp))
                else:
                    writer.put(recorder(grp, t0), out)
    finally:
        try:
            writer.close()
        finally:
            if nxt_prep is not None:
                nxt_prep.wait()


def _fibres(gprep):
    """The fibres a prepared group selected for its fit (an attribute of
    the driver's spans)."""
    return sum(p['nsel'] for p in gprep.get('preps', ()) if p is not None)


def _finish_file(fname, nsel, finish, throw):
    """A file's deferred finish under crash isolation: [nsel], or
    [None] after a crash log."""
    try:
        finish()
        return [nsel]
    except Exception:
        _log_crash(fname, 'write', throw)
        return [None]


Fleet = collections.namedtuple('Fleet', 'files rank world')


def per_rank(fname, rank):
    """``fname`` with ``%d`` replaced by ``rank`` (a per-rank log or
    status file), unchanged without a rank or a ``%``."""
    if fname is not None and rank is not None and '%' in fname:
        return fname % rank
    return fname


@contextlib.contextmanager
def fleet(input_files=(), input_file_from=None, queue_file=False,
          dynamic_queue=False, rank=None, world=None, coordinator=None,
          done_barrier='rvstorch_desi_fit_done'):
    """The input files and world of one process of a run: yields
    Fleet(files, rank, world) for :func:`proc_many`.

    With ``coordinator`` (``host:port``), or ``MASTER_ADDR`` set as
    ``torchrun`` sets it, the process joins a multi-process world
    (parallel/distributed.init_distributed): ``rank`` and ``world``
    default to the world's, and on leaving, normally or by an
    exception, the process waits at the barrier ``done_barrier`` and
    closes the world.  The files, as the reference selects them:
    ``input_files`` as a list; else the lines of ``input_file_from``,
    claimed through the world's store with ``dynamic_queue``
    (CoordinatedFileQueue, which needs a world), sharded
    ``files[rank::world]`` where a rank or world is known
    (ShardedFileQueue), or read as a lock-file queue with
    ``queue_file`` (FileQueue, on a shared filesystem) or as a list.
    """
    in_world = bool(coordinator or os.environ.get('MASTER_ADDR'))
    if in_world:
        pid, nproc = distributed.init_distributed(coordinator, world, rank)
        rank = pid if rank is None else rank
        world = nproc if world is None else world
    try:
        if input_files:
            files = utils.FileQueue(file_list=input_files)
        elif input_file_from is None:
            raise ValueError('provide input files or input_file_from')
        elif dynamic_queue or world is not None or rank is not None:
            with open(input_file_from) as fp:
                lst = [ln.strip() for ln in fp if ln.strip()]
            if dynamic_queue:
                files = distributed.CoordinatedFileQueue(lst)
            else:
                files = utils.ShardedFileQueue(lst, rank=rank, world=world)
        else:
            files = utils.FileQueue(file_from=input_file_from,
                                    queue=queue_file)
        yield Fleet(files, rank, world)
    finally:
        if in_world:
            distributed.barrier(done_barrier)
            distributed.shutdown()


def main(args=None):
    """``rvstorch_desi_fit``: fit DESI coadd/spectra files and write
    RVTAB/RVMOD files.  Runs on the CUDA card unless ``--device cpu``
    is given, and raises without a card; one process of a
    multi-process run (:func:`fleet`) takes card ``rank %
    device_count()``."""
    if args is None:
        args = sys.argv[1:]
    cmdline = ' '.join(['rvstorch_desi_fit'] + list(args))
    parser = argparse.ArgumentParser(description='Fit DESI spectra')
    parser.add_argument('input_files', nargs='*', default=[])
    parser.add_argument('--input_file_from', type=str, default=None,
                        help='text file with one input file per line')
    parser.add_argument('--queue_file', action='store_true',
                        default=False,
                        help='use --input_file_from as a work queue '
                        'shared by processes on a shared filesystem')
    parser.add_argument('--dynamic_queue', action='store_true',
                        default=False,
                        help='claim --input_file_from items dynamically '
                        "across the world through its store (no shared "
                        'filesystem needed); needs --coordinator')
    parser.add_argument('--output_dir', type=str, required=True)
    parser.add_argument('--config', type=str, default=None)
    parser.add_argument('--templ_lib', type=str, default=None)
    parser.add_argument('--setups', type=str, default='b,r,z')
    parser.add_argument('--fitarm', type=str, default=None,
                        help='comma-separated subset of arms to fit '
                        '(e.g. b,r)')
    parser.add_argument('--minsn', type=float, default=-1e9)
    parser.add_argument('--npoly', type=int, default=10)
    parser.add_argument('--targetid', type=int, default=None)
    parser.add_argument('--targetid_file_from', type=str, default=None)
    parser.add_argument('--minexpid', type=int, default=None)
    parser.add_argument('--maxexpid', type=int, default=None)
    parser.add_argument('--zbest_select', action='store_true',
                        default=False,
                        help='select STAR-like objects using the '
                        'redrock file next to the coadd')
    parser.add_argument('--doplot', action='store_true', default=False,
                        help='write a plot of each fiber\'s fit '
                        '(needs matplotlib)')
    parser.add_argument('--figure_dir', type=str, default=None,
                        help='directory for the plots (default: '
                        'output_dir)')
    parser.add_argument('--figure_prefix', type=str, default='fig',
                        help='filename prefix for the plots')
    parser.add_argument('--output_tab_prefix', type=str,
                        default=TABLE_PREFIX,
                        help='prefix of the output table files')
    parser.add_argument('--output_mod_prefix', type=str,
                        default=MODEL_PREFIX,
                        help='prefix of the output model files')
    parser.add_argument('--targetmask_yaml', type=str, default=None,
                        action='append',
                        help='desitarget-format targetmask yaml(s) whose '
                        '*_desi_mask/cmx_mask bit names extend the '
                        'embedded tables for --objtypes; repeatable')
    parser.add_argument('--objtype_mask', type=int, default=None,
                        help='explicit target-column bitmask')
    parser.add_argument('--objtypes', type=str, default=None,
                        help='comma-separated regexes matched against '
                        "target bit names, e.g. 'MWS_.*,STD_.*'")
    parser.add_argument('--overwrite', type=str, default=None,
                        help='(kept for reference CLI compatibility; '
                        'meaningless now)')
    parser.add_argument('--version', action='store_true', default=False,
                        help='print the software version and exit')
    parser.add_argument('--param_init', type=str, default='CCF',
                        help='how the parameters are initialized: CCF '
                        'or bruteforce')
    parser.add_argument('--no_ccf_continuum_normalize',
                        dest='ccf_continuum_normalize',
                        action='store_false', default=True)
    parser.add_argument('--resolution_matrix', action='store_true',
                        default=False)
    parser.add_argument('--no-resolution_matrix',
                        dest='resolution_matrix', action='store_false')
    parser.add_argument('--nthreads', type=int, default=None,
                        help='ignored (reference compatibility): '
                        'fibers are fitted as one device batch')
    parser.add_argument('--coalesce', type=int, default=2,
                        help='fit up to N consecutive compatible files '
                        'as one batch (static file lists only; queue '
                        'inputs run at 1); 1 fits file by file')
    parser.add_argument('--skipexisting', action='store_true',
                        default=False)
    parser.add_argument('--throw_exceptions', action='store_true',
                        default=False)
    parser.add_argument('--process_status_file', type=str, default=None,
                        help='per-file processing log; %%d expands to '
                        'the rank')
    parser.add_argument('--log', type=str, default=None,
                        help='log file; %%d expands to the rank')
    parser.add_argument('--log_level', type=str, default='INFO')
    parser.add_argument('--rank', type=int, default=None,
                        help='this process\'s rank (default: the '
                        "world's, or RANK)")
    parser.add_argument('--world', type=int, default=None,
                        help='number of processes (default: the '
                        "world's, or WORLD_SIZE)")
    parser.add_argument('--coordinator', type=str, default=None,
                        help='host:port of the world\'s store, which '
                        'rank 0 hosts; enables the multi-process world '
                        '(default: MASTER_ADDR:MASTER_PORT where '
                        'MASTER_ADDR is set)')
    parser.add_argument('--device', type=str, default=None,
                        help="torch device, e.g. 'cpu' (default: the "
                        'CUDA card, rank %% device_count() in a world; '
                        'raises without one)')
    args = parser.parse_args(args)

    if args.version:
        print(__version__)
        return
    if args.overwrite is not None:
        logging.warning('overwrite keyword is meaningless now')
    if args.param_init not in ('CCF', 'bruteforce'):
        parser.error('Unknown param_init value; only known ones are '
                     'CCF and bruteforce')
    if not args.input_files and not args.input_file_from:
        parser.error('provide input files or --input_file_from')

    with fleet(args.input_files, args.input_file_from,
               queue_file=args.queue_file,
               dynamic_queue=args.dynamic_queue, rank=args.rank,
               world=args.world, coordinator=args.coordinator) as fl:
        device = resolve_device(args.device)
        logging.basicConfig(filename=per_rank(args.log, fl.rank),
                            level=getattr(logging, args.log_level))

        override = {'ccf_continuum_normalize': args.ccf_continuum_normalize}
        if args.templ_lib:
            override['template_lib'] = args.templ_lib
        config = utils.read_config(args.config, override)

        fit_targetid = None
        if args.targetid is not None:
            fit_targetid = np.array([args.targetid])
        elif args.targetid_file_from:
            fit_targetid = np.loadtxt(args.targetid_file_from,
                                      dtype=np.int64, ndmin=1)
        expid_range = None
        if args.minexpid is not None or args.maxexpid is not None:
            expid_range = (args.minexpid if args.minexpid is not None
                           else -10**18,
                           args.maxexpid if args.maxexpid is not None
                           else 10**18)

        proc_many(fl.files, args.output_dir,
                  output_tab_prefix=args.output_tab_prefix,
                  output_mod_prefix=args.output_mod_prefix,
                  config=config, options={'npoly': args.npoly},
                  skipexisting=args.skipexisting,
                  status_fname=per_rank(args.process_status_file,
                                        fl.rank),
                  coalesce=args.coalesce, device=device,
                  throw_exceptions=args.throw_exceptions, cmdline=cmdline,
                  zbest_select=args.zbest_select,
                  ccf_init=args.param_init == 'CCF',
                  doplot=args.doplot, figure_dir=args.figure_dir,
                  figure_prefix=args.figure_prefix,
                  setups=tuple(args.setups.split(',')),
                  minsn=args.minsn, fit_targetid=fit_targetid,
                  expid_range=expid_range,
                  objtype_mask=args.objtype_mask,
                  objtypes=(args.objtypes.split(',')
                            if args.objtypes else None),
                  target_tables=(load_targetmask_yaml(args.targetmask_yaml)
                                 if args.targetmask_yaml else None),
                  use_resolution_matrix=args.resolution_matrix,
                  fitarm=(tuple(args.fitarm.split(','))
                          if args.fitarm else None))


if __name__ == '__main__':
    main()
