"""WEAVE batch-fitting driver (``rvstorch_weave_fit``).

Counterpart of rvspecfit_tpu/survey/weave.py.  Per red(+blue) file
pair:

 1. read each file (io/fitsio); its CAMERA names the arm (weave_b,
    weave_r); wavelengths from the linear WCS keywords;
 2. select the fibers whose TARGCAT is one of ``programs``, striped
    over ``nthreads`` workers;
 3. inflate the errors in the telluric bands;
 4. fit the selected fibers as one batch: CCF first guess (kernel B)
    -> Nelder-Mead with rotation (kernel A) -> optional gradient polish
    (kernel A and its adjoint) -> velocity refinement -> AD Hessian
    errors -> best-fit models;
 5. write one ``WEAVE_RV`` table per pair, with status lines and
    ``overwrite=False`` skipping done pairs.

Many processes share the work by striping the fibers of each pair:
``--nthreads``/``--threadid``, or with ``--coordinator`` the world's
size and rank (parallel/distributed).  ``--doplot`` writes a plot per
fiber.

While a pair fits, a daemon thread reads the next pair's files
(:func:`proc_many`'s ``prefetch``, on by default as in the reference).
On a host with several cards the fitter is sharded over them
(parallel/mesh.auto_shard; ``RVST_NO_MESH=1`` opts out).

Difference from the reference, by design: a CCF failure raises (the
reference starts every fiber at default parameters).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import glob
import logging
import os
import sys
import threading
import time

import numpy as np

from rvspecfit_torch import utils
from rvspecfit_torch.device import resolve_device
from rvspecfit_torch.fit import vel_fit
from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
from rvspecfit_torch.io import fitsio
from rvspecfit_torch.parallel import distributed
from rvspecfit_torch.parallel import mesh as pmesh
from rvspecfit_torch.pipeline import library
from rvspecfit_torch.survey.desi import (ccf_starts, make_plot,
                                         masked_median,
                                         update_process_status_file)

TELLURIC_BANDS = [(6850, 7000), (8130, 8350), (8940, 9240),
                  (9250, 9545), (9550, 10000)]
DEFAULT_PROGRAMS = ('GA_LRhighlat', 'GA_LRdisc')
CAMERAS = {'b': 'BLUE', 'r': 'RED'}


def wcs_wavelengths(header, npix):
    """Wavelengths in angstrom of a linear WCS: CRVAL1, CD1_1 (or
    CDELT1), CRPIX1 and CUNIT1 (m, nm or angstrom; default m)."""
    crval = float(header.get('CRVAL1', 0.0))
    cd = header.get('CD1_1', header.get('CDELT1', 1.0))
    crpix = float(header.get('CRPIX1', 1.0))
    unit = str(header.get('CUNIT1', 'm')).strip().lower()
    scale = {'m': 1e10, 'angstrom': 1.0, 'nm': 10.0}.get(unit, 1e10)
    pix = np.arange(npix)
    return (crval + (pix + 1 - crpix) * float(cd)) * scale


def valid_file(fp):
    """Whether a red file has the extensions the driver reads."""
    names = {str(n).upper() for n in fp.names()}
    missing = {'RED_DATA', 'RED_IVAR', 'FIBTABLE'} - names
    if missing:
        logging.error('Missing extensions: %s', sorted(missing))
        return False
    return True


def telluric_ivar(wave, flux, ivar):
    """``ivar`` with the pixels of the telluric bands set to an error of
    10% of max(flux, 1)."""
    telluric = np.zeros(len(wave), bool)
    for lo, hi in TELLURIC_BANDS:
        telluric |= (wave >= lo) & (wave < hi)
    ivar = np.array(ivar, np.float64)
    ivar[:, telluric] = 1.0 / 100.0 / np.maximum(flux[:, telluric],
                                                 1.0)**2
    return ivar


def _read_pair(fnames):
    """{setup letter: FITSFile} of a pair, by CAMERA."""
    fps = {}
    for f in fnames:
        fp = fitsio.read(f)
        cam = str(fp[0].header.get('CAMERA', '')).replace('WEAVE', '')
        s = {v: k for k, v in CAMERAS.items()}.get(cam.strip().upper())
        if s is None:
            raise RuntimeError(f'{f}: unknown CAMERA {cam!r}')
        fps[s] = fp
    return fps


def proc_weave(fnames, config, threadid=0, nthreads=1,
               programs=DEFAULT_PROGRAMS, options=None, templates=None,
               banks=None, device=None, fig_prefix=None, prehdus=None):
    """Fit one WEAVE red(+blue) file pair; returns a dict of columns
    (None when no fibers are selected).  With ``fig_prefix``, a plot
    per fiber, ``{fig_prefix}_{target id}.png`` (a plot that fails is
    logged, as in the reference).  ``prehdus``: the pair as
    :func:`_read_pair` gives it, read ahead by :func:`proc_many`.

    ``templates`` ({weave_b/weave_r: TemplateModel}) and ``banks``
    ({setup: (tfft, t2fft, info)}) may come from memory; None loads
    them from ``config['template_lib']`` onto ``device`` (None: the
    CUDA card)."""
    options = options or {'npoly': 15}
    fnames = _names(fnames)
    fps = prehdus if prehdus is not None else _read_pair(fnames)
    setups = sorted(fps)                                  # b before r
    tab = hdr0 = None
    for s in setups:
        if 'FIBTABLE' in fps[s]:
            tab, hdr0 = fps[s]['FIBTABLE'].data, fps[s][0].header
            break
    if tab is None:
        raise RuntimeError('No FIBTABLE extension found')
    targetid = np.char.replace(np.asarray(tab['TARGID']).astype(str),
                               '"', '')
    brick = str(hdr0.get('OBID', 'unknown')).replace('.', '').replace(
        '/', '').replace('_', '')
    targcat = np.char.strip(np.asarray(tab['TARGCAT']).astype(str))
    xids = np.nonzero(np.isin(targcat, list(programs)))[0]
    if len(xids) > 0 and nthreads > 1:
        stripe = np.linspace(0, nthreads, len(xids), False).astype(int)
        xids = xids[stripe == threadid]
    if len(xids) == 0:
        return None

    arms, sns = [], {}
    for s in setups:
        cam = CAMERAS[s]
        data = fps[s][f'{cam}_DATA']
        flux = np.atleast_2d(data.data)[xids].astype(np.float64)
        ivar = np.atleast_2d(fps[s][f'{cam}_IVAR'].data)[xids]
        wave = wcs_wavelengths(data.header, flux.shape[1])
        ivar = telluric_ivar(wave, flux, ivar)
        badmask = ivar <= 0
        with np.errstate(divide='ignore'):
            esp = 1.0 / np.sqrt(np.where(badmask, 1, ivar))
        sns[s] = masked_median(flux / esp, ~badmask)
        arms.append(BatchArm(f'weave_{s}', wave, flux, ivar,
                             badmask=badmask, setup=f'weave_{s}'))
    if templates is None:
        templates = library.load_template_models(
            config, {a.setup for a in arms}, device=device)
    parnames = templates[arms[0].setup].parnames
    device = next(iter(templates.values())).geom.h.device

    start_params, start_vel, start_vsini, _, _ = ccf_starts(
        arms, parnames, config, banks, device)
    bf = BatchedFitter(arms, templates, config, options=options,
                       use_vsini=True)
    if pmesh.auto_shard(bf) is not None:
        logging.info('fitter sharded over %d devices', len(bf.shards))
    paramDict0 = dict(zip(parnames, start_params.mean(axis=0)))
    paramDict0['vsini'] = 0.01
    mapper = vel_fit.ParamMapper(
        parnames, paramDict0, [],
        vel_fit.VSiniMapper(config['max_vsini'],
                            config.get('min_vsini') or 0.0), True)
    x0 = np.zeros((len(xids), mapper.nvec))
    x0[:, 0] = start_vel
    x0[:, 1] = np.clip(start_vsini, 0, config['max_vsini'])
    x0[:, 2:] = start_params
    nmres = bf.run_neldermead(mapper, start_vel, x0=x0)
    tail = bf.run_tail(mapper, nmres['x'], fun=nmres['fun'],
                       parnames=parnames,
                       polish=bool(config.get('second_minimizer')))
    ref, params_b, mods = tail['ref'], tail['params'], tail['mods']

    out = dict(brickname=np.full(len(xids), brick),
               target_id=targetid[xids],
               vrad=ref['best_vel'], vrad_err=ref['vel_err'],
               vsini=tail['vsini'])
    for i, p in enumerate(parnames):
        out[p] = params_b[:, i]
        out[p + '_err'] = tail['errs'][:, i]
    out['chisq_tot'] = np.sum([mods['chisq'][a.name] for a in arms],
                              axis=0)
    for s, a in zip(setups, arms):
        out['chisq_%s' % s] = mods['chisq'][a.name]
        out['chisq_c_%s' % s] = mods['cont_chisq'][a.name]
        out['sn_%s' % s] = sns[s]
    if fig_prefix is not None:
        for k in range(len(xids)):
            title = ('teff=%.0f logg=%.1f V=%.1f+/-%.1f' % (
                out['teff'][k], out['logg'][k], out['vrad'][k],
                out['vrad_err'][k]))
            try:
                make_plot([a.lam for a in arms], [a.flux[k] for a in arms],
                          [mods['models'][a.name][k] for a in arms], title,
                          '%s_%s.png' % (fig_prefix,
                                         str(out['target_id'][k]).strip()))
            except Exception as exc:
                logging.warning('plotting failed: %s', exc)
    return out


def output_path(grp, oprefix, threadid=0, output_tab_prefix='outtab'):
    """The table of a file group: {prefix}_{first file's base}_{thread}."""
    base = os.path.basename(str(grp).split(',')[0]).replace('.fits', '')
    return os.path.join(oprefix,
                        f'{output_tab_prefix}_{base}_{threadid}.fits')


def _names(grp):
    return grp.split(',') if isinstance(grp, str) else list(grp)


def proc_many(file_groups, oprefix, config, threadid=0, nthreads=1,
              options=None, overwrite=True, status_fname=None,
              output_tab_prefix='outtab', templates=None, banks=None,
              device=None, throw_exceptions=False, fig_prefix=None,
              prefetch=True):
    """Fit file groups one after another and write one WEAVE_RV table
    per group (:func:`output_path`).  ``overwrite=False`` skips groups
    whose table exists (status SKIPPED); ``status_fname`` gets one
    line per group: SUCCESS, EMPTY, FAILED or SKIPPED.  A failed group
    is logged and the next one fitted, unless ``throw_exceptions``.
    ``prefetch``: read the next group's files on a daemon thread while
    a group fits (reference: rvspecfit_tpu/survey/weave.py:238-285); a
    read that fails is made again by :func:`proc_weave`, under its crash
    isolation.  ``templates``/``banks``/``fig_prefix``: as in
    :func:`proc_weave`."""
    os.makedirs(oprefix, exist_ok=True)
    if status_fname:
        update_process_status_file(status_fname, None, None, 0, 0,
                                   start=True)

    def status(ofname, code, nobj, t0):
        if status_fname:
            update_process_status_file(status_fname, ofname, code, nobj,
                                       time.time() - t0)

    def read_ahead(grp):
        fut = concurrent.futures.Future()

        def run():
            try:
                fut.set_result(_read_pair(_names(grp)))
            except Exception:
                fut.set_result(None)
        threading.Thread(target=run, daemon=True,
                         name='rvst-reader').start()
        return grp, fut

    groups = list(file_groups)
    ahead = None
    for gi, grp in enumerate(groups):
        t0 = time.time()
        ofname = output_path(grp, oprefix, threadid, output_tab_prefix)
        if not overwrite and os.path.exists(ofname):
            logging.info('skipping, products already exist %s', grp)
            status(ofname, 'SKIPPED', 0, t0)
            continue
        prehdus = ahead[1].result() if ahead and ahead[0] is grp else None
        ahead = read_ahead(groups[gi + 1]) \
            if prefetch and gi + 1 < len(groups) else None
        try:
            out = proc_weave(grp, config, threadid=threadid,
                             nthreads=nthreads, options=options,
                             templates=templates, banks=banks,
                             device=device, fig_prefix=fig_prefix,
                             prehdus=prehdus)
        except Exception:
            logging.exception('failed processing %s', grp)
            status(ofname, 'FAILED', 0, t0)
            if throw_exceptions:
                raise
            continue
        if out is None:
            logging.info('%s: no selected fibers', grp)
            status(ofname, 'EMPTY', 0, t0)
            continue
        fitsio.write(ofname, [dict(kind='table', name='WEAVE_RV',
                                   data=list(out.items()))])
        status(ofname, 'SUCCESS', len(out['vrad']), t0)
        logging.info('%s -> %s (%.1f s)', grp, ofname, time.time() - t0)


def main(args=None):
    """``rvstorch_weave_fit``: fit WEAVE file pairs and write WEAVE_RV
    tables.  Runs on the CUDA card unless ``--device cpu`` is given,
    and raises without a card.  With ``--coordinator`` (or
    ``MASTER_ADDR`` set) the process joins a multi-process world whose
    rank and size stripe the fibers (unless ``--threadid``/``--nthreads``
    are given), and waits for every rank before it exits."""
    if args is None:
        args = sys.argv[1:]
    parser = argparse.ArgumentParser(description='Fit WEAVE spectra')
    parser.add_argument('input_files', nargs='*',
                        help='comma-separated red,blue file groups')
    parser.add_argument('--input_file_mask', type=str, default=None,
                        help='glob mask of input files')
    parser.add_argument('--input_file', type=str, default=None,
                        help='file with one input group per line')
    parser.add_argument('--oprefix', type=str, default=None,
                        help='(legacy) output directory; superseded by '
                        '--output_dir')
    parser.add_argument('--output_dir', type=str, default=None,
                        help='output directory for the tables')
    parser.add_argument('--output_tab_prefix', type=str,
                        default='outtab',
                        help='prefix of output table files')
    parser.add_argument('--doplot', action='store_true', default=False,
                        help='write a plot of each fiber\'s fit '
                        '(needs matplotlib)')
    parser.add_argument('--figure_dir', type=str, default='./',
                        help='directory for the plots')
    parser.add_argument('--figure_prefix', type=str, default='fig',
                        help='filename prefix for the plots')
    parser.add_argument('--config', type=str, default=None)
    parser.add_argument('--templ_lib', type=str, default=None)
    parser.add_argument('--nthreads', type=int, default=1)
    parser.add_argument('--threadid', type=int, default=0)
    parser.add_argument('--npoly', type=int, default=15)
    parser.add_argument('--overwrite', action='store_true',
                        default=False,
                        help='overwrite existing products; otherwise '
                        'they are skipped')
    parser.add_argument('--process_status_file', type=str, default=None,
                        help='per-group processing log enabling '
                        'restart; %%d expands to the thread id')
    parser.add_argument('--log', type=str, default=None)
    parser.add_argument('--log_level', type=str, default='WARNING')
    parser.add_argument('--coordinator', type=str, default=None,
                        help='host:port of the world\'s store, which '
                        'rank 0 hosts; enables the multi-process world '
                        '(threadid/nthreads default to its rank/size)')
    parser.add_argument('--device', type=str, default=None,
                        help="torch device, e.g. 'cpu' (default: the "
                        'CUDA card, rank %% device_count() in a world; '
                        'raises without one)')
    args = parser.parse_args(args)

    use_world = bool(args.coordinator or os.environ.get('MASTER_ADDR'))
    if use_world:
        pid, nproc = distributed.init_distributed(args.coordinator)
        if args.nthreads == 1 and args.threadid == 0:
            args.threadid, args.nthreads = pid, nproc
    try:
        device = resolve_device(args.device)
        log_fname = args.log
        if log_fname is not None and '%d' in log_fname:
            log_fname = log_fname % args.threadid
        logging.basicConfig(
            filename=log_fname,
            level=getattr(logging, args.log_level.upper(), logging.WARNING))

        files = list(args.input_files)
        if args.input_file_mask is not None:
            files.extend(sorted(glob.glob(args.input_file_mask)))
        if args.input_file is not None:
            with open(args.input_file) as fp:
                files.extend(ln.strip() for ln in fp if ln.strip())
        if not files:
            parser.error('no input files: pass groups, --input_file_mask '
                         'or --input_file')
        status_fname = args.process_status_file
        if status_fname is not None and '%d' in status_fname:
            status_fname = status_fname % args.threadid
        override = {}
        if args.templ_lib:
            override['template_lib'] = args.templ_lib
        config = utils.read_config(args.config, override)
        fig_prefix = None
        if args.doplot:
            os.makedirs(args.figure_dir, exist_ok=True)
            fig_prefix = os.path.join(args.figure_dir, args.figure_prefix)
        proc_many(files, args.output_dir or args.oprefix or 'outputs/',
                  config, threadid=args.threadid, nthreads=args.nthreads,
                  options={'npoly': args.npoly}, overwrite=args.overwrite,
                  status_fname=status_fname,
                  output_tab_prefix=args.output_tab_prefix, device=device,
                  fig_prefix=fig_prefix)
    finally:
        if use_world:
            distributed.barrier('rvstorch_weave_fit_done')
            distributed.shutdown()


if __name__ == '__main__':
    main()
