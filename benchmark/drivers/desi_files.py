"""Traffic of DESI coadd files through rvspecfit_torch.survey.desi.proc_many.

Set-up writes ``files`` coadds of ``fibres_per_file`` fibres in the
DESI coadd data model (stars, their order and their noise drawn from the
run's seed) (B/R/Z WAVELENGTH, FLUX, IVAR, MASK; FIBERMAP
with OBJTYPE TGT and FIBERSTATUS 0; SCORES) through the program's FITS
writer into a directory under TMPDIR, and builds the template models
and CCF banks on the card.  The window is one proc_many call over all
files at ``coalesce``, the driver's overlaps at their defaults; a group
of ``coalesce`` files completes when the last of their RVTAB and RVMOD
files is written.  Once the window has closed, no new group fit starts.
``sample_per_file`` fibres of every file, drawn from the seed, are
judged against the reference, with what the driver handed its writer.

The driver is watched through five of the program's functions (the
writer, the group fit, the read-ahead, and the likelihood's two cores,
which stop the group fit in flight once the window has closed).  Each
is looked up by name and its arguments bound by name; a run in which
one of them was never called fails, so that a change of the program's
call structure shows as an error and not as a quiet window."""
import inspect
import os
import shutil
import tempfile
import threading
import time
from unittest import mock

import numpy as np

from benchlib import generator, program, reference, reference_ccf
from benchlib.harness import WindowClosed, log

DICHROIC = (4300.0, 4450.0)
PARAM_COLS = ('TEFF', 'LOGG', 'FEH', 'ALPHAFE')


def _coadd(path, arms_data, truth):
    from rvspecfit_torch.io import fitsio
    nfib = len(truth['vel'])
    hdus = [dict(kind='image', data=None)]
    for s, (lam, flux, ivar) in arms_data.items():
        su = s.upper()
        hdus += [dict(kind='image', data=lam, name=f'{su}_WAVELENGTH'),
                 dict(kind='image', data=flux, name=f'{su}_FLUX'),
                 dict(kind='image', data=ivar, name=f'{su}_IVAR'),
                 dict(kind='image', data=np.zeros(flux.shape, np.int32),
                      name=f'{su}_MASK')]
    hdus.append(dict(kind='table', name='FIBERMAP', data=[
        ('TARGETID', np.arange(nfib, dtype=np.int64) + 39627000000000000),
        ('TARGET_RA', np.linspace(0, 1, nfib)),
        ('TARGET_DEC', np.zeros(nfib)),
        ('FIBER', np.arange(nfib, dtype=np.int32)),
        ('OBJTYPE', np.array(['TGT'] * nfib)),
        ('FIBERSTATUS', np.zeros(nfib, np.int32)),
        ('DESI_TARGET', np.full(nfib, 1 << 61, np.int64))]))
    hdus.append(dict(kind='table', name='SCORES', data=[
        ('MEDIAN_CALIB_SNR_' + s.upper(), truth['snr'])
        for s in arms_data]))
    fitsio.write(path, hdus)


def prepare(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dtype = ctx.dtype
    models, grids, raw = program.template_models(ctx, cfg, dtype)
    log('template models built')
    banks = program.ccf_banks(ctx, cfg, raw, dtype)
    del raw
    log('CCF banks built')
    workdir = tempfile.mkdtemp(prefix='rvst-bench-')
    nfib = int(tr['fibres_per_file'])
    files, truths, samples, data = [], [], [], []
    for k in range(int(tr['files'])):
        rng = ctx.rng(1000 + k)
        truth = generator.draw_truths(tr, nfib, rng)
        noise = generator.device_generator(ctx.seed, ctx.device, 1000 + k)
        arms_data = {}
        for s, arm in cfg['arms'].items():
            flux, ivar = generator.observe(cfg, arm['setup'], arm, truth,
                                           noise, ctx.device)
            arms_data[s] = (generator.arm_lam(arm), flux, ivar)
        path = os.path.join(workdir, f'coadd-main-dark-{k:05d}.fits')
        _coadd(path, arms_data, truth)
        pick = np.sort(rng.choice(nfib, int(tr['sample_per_file']),
                                  replace=False))
        files.append(path)
        truths.append(truth)
        samples.append(pick)
        data.append({s: (a[1][pick], a[2][pick])
                     for s, a in arms_data.items()})
    log(f'{len(files)} coadds written')
    return dict(models=models, grids=grids, banks=banks, workdir=workdir,
                files=files, truths=truths, samples=samples, data=data,
                captured={}, dtype=dtype)


def _fit_config(cfg):
    fit = dict(cfg['fit'])
    fit.pop('npoly', None)
    return fit


def _bound(fn):
    """A function that binds ``fn``'s call arguments to their names."""
    sig = inspect.signature(fn)
    return lambda args, kwargs: sig.bind(*args, **kwargs).arguments


def _answer(res, j, arms):
    """What the driver handed its writer for row ``j`` of a file."""
    col = lambda c: float(res[c][j])  # noqa: E731
    return dict(
        vel=col('VRAD'), vsini=col('VSINI'),
        params=[col(c) for c in PARAM_COLS], chisq=col('CHISQ_TOT'),
        vel_err=col('VRAD_ERR'),
        param_errs=[col(c + '_ERR') for c in PARAM_COLS],
        ccf_vel=col('VRAD_CCF'), ccf_chisq=col('CHISQ_CCF'),
        ccf_params=[col(c + '_CCF') for c in PARAM_COLS],
        ccf_vsini=col('VSINI_CCF'))


def measure(ctx, st, win, dtrace):
    from rvspecfit_torch.fit import batch
    from rvspecfit_torch.ops import ccf_chisq
    from rvspecfit_torch.survey import desi
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    index = {f: k for k, f in enumerate(st['files'])}
    coalesce = int(tr['coalesce'])
    st['coalesce'] = coalesce
    calls = dict(write=0, fit=0, read_ahead=0, chisq_trials_core=0,
                 scan_core=0)
    write_args = _bound(desi._write_outputs)
    prep_args = _bound(desi.prepare_desi_group)

    def on_write(args, kwargs, out):
        a = write_args(args, kwargs)
        res, mods, idx = a['res'], a['mods'], a['idx']
        k = index[a['src_fname']]
        calls['write'] += 1
        pos = {int(i): j for j, i in enumerate(np.asarray(idx))}
        cap = []
        for i in st['samples'][k]:
            j = pos.get(int(i))
            if j is None:
                cap.append(None)
                continue
            cap.append(dict(_answer(res, j, cfg['arms']), models=[
                np.array(mods['models'][f'desi_{s}'][j])
                for s in cfg['arms']]))
        st['captured'][k] = dict(answers=cap, vrad=np.array(res['VRAD']),
                                 idx=np.array(idx))
        # a group completes when the last of its files is written
        g = k // coalesce
        members = range(g * coalesce, min(len(st['files']),
                                          (g + 1) * coalesce))
        if all(m in st['captured'] for m in members):
            win.complete(sum(len(st['captured'][m]['idx'])
                             for m in members), key=g)
        return dict(group=k // coalesce)

    real_fit = desi._run_group_fit

    def fit(arms, *a, **kw):
        if win.closed:
            raise WindowClosed()
        calls['fit'] += 1
        t0 = time.time()
        out = real_fit(arms, *a, **kw)
        ctx.groups.append(dict(nfibers=arms[0].nfibers, out=out, t=t0))
        return out

    def stop_when_closed(name, real):
        # the group fit in flight when the window closes is dropped:
        # its next likelihood call raises
        def call(*a, **kw):
            calls[name] += 1
            if win.closed:
                raise WindowClosed()
            if dtrace is not None and dtrace.due() and \
                    threading.current_thread() is threading.main_thread():
                dtrace.stop()
                ctx.tracing = False
            return real(*a, **kw)
        return call

    real_read_ahead = desi._Reader.start
    reads = []

    def read_ahead(self, fnames):
        # proc_many's loop asks to read the next group's files as it
        # starts a group: the trace starts as the second group starts
        # (the one that the window's opening finds running), before the
        # third group's prep dispatches its CCF
        calls['read_ahead'] += 1
        reads.append(fnames)
        if dtrace is not None and len(reads) == 2:
            dtrace.start()
            ctx.tracing = True
        return real_read_ahead(self, fnames)

    config = _fit_config(cfg)
    with ctx.spans.wrap(desi, '_write_outputs', 'write', on_write), \
            mock.patch.object(desi._Reader, 'start', read_ahead), \
            mock.patch.object(batch, 'chisq_trials_core', stop_when_closed(
                'chisq_trials_core', batch.chisq_trials_core)), \
            mock.patch.object(batch, 'scan_core', stop_when_closed(
                'scan_core', batch.scan_core)), \
            ctx.spans.wrap(desi, 'prepare_desi_group', 'prep',
                           lambda args, kw, out: dict(group=index[
                               prep_args(args, kw)['fnames'][0]]
                               // coalesce)), \
            ctx.spans.wrap(ccf_chisq, 'ccf_chisq', 'kernel_b',
                           program.kernel_b_calls(ctx)), \
            mock.patch.object(desi, '_run_group_fit', fit):
        setups = {f'desi_{s}': st['models'][a['setup']]
                  for s, a in cfg['arms'].items()}
        banks = {f'desi_{s}': st['banks'][a['setup']]
                 for s, a in cfg['arms'].items()}
        outdir = os.path.join(st['workdir'], 'out')
        try:
            desi.proc_many(
                st['files'], outdir, config=config,
                options={'npoly': cfg['fit']['npoly']},
                status_fname=os.path.join(st['workdir'], 'status.txt'),
                coalesce=coalesce, templates=setups,
                banks=banks, throw_exceptions=True,
                setups=tuple(cfg['arms']))
        except WindowClosed:
            pass
    quiet = [k for k in ('write', 'fit', 'read_ahead') if not calls[k]]
    if not calls['chisq_trials_core'] + calls['scan_core']:
        quiet.append('chisq_trials_core or scan_core')
    if quiet:
        raise RuntimeError(
            'the program never called ' + ', '.join(quiet) + ' in this '
            'run: its call structure changed, and drivers/desi_files.py '
            'can no longer watch it')


def _files(st, win):
    c = st['coalesce']
    return [k for g in win.keys()
            for k in range(g * c, min(len(st['files']), (g + 1) * c))]


def answers(ctx, st, win):
    """The sampled fibres of every file completed in the window (the
    fit models rotation where the CCF bank has rotated templates)."""
    rotation = bool(ctx.cell.config['ccf'].get('vsinis'))
    out, rows = [], 0
    st['rows'] = []
    for k in _files(st, win):
        cap = st['captured'][k]['answers']
        for j, a in enumerate(cap):
            st['rows'].append((k, j))
            fib = st['samples'][k][j]
            row = dict(row=rows, use_vsini=rotation, chisq_kind='chi2',
                       truth={p: float(st['truths'][k][p][fib])
                              for p in ('snr', 'vel', 'vsini')
                              + generator.PARNAMES})
            if a is not None:
                row.update(a)
            out.append(row)
            rows += 1
    return out


def reference_arms(ctx, st):
    """The reference's arms of the judged fibres: the float32 flux and
    inverse variance the coadds hold, with the driver's documented
    treatment of the dichroic gap (4300-4450 A masked, its sigma 1e9
    times the row's median sigma as numpy takes it) and npoly; and, for
    the CCF, the flux with the errors that the driver hands it (1000
    times the median good flux in the masked gap, the good errors at
    least 0.3 times their median) and its mask."""
    cfg = ctx.cell.config
    arms = []
    for s, arm in cfg['arms'].items():
        lam = generator.arm_lam(arm)
        flux = np.concatenate([st['data'][k][s][0][j:j + 1]
                               for k, j in st['rows']]).astype(np.float64)
        ivar = np.concatenate([st['data'][k][s][1][j:j + 1]
                               for k, j in st['rows']]).astype(np.float64)
        bad = np.zeros(flux.shape, bool) | (
            (lam > DICHROIC[0]) & (lam < DICHROIC[1]))[None, :]
        sig = 1.0 / np.sqrt(ivar)
        med = np.median(np.where(bad, np.nan, sig), axis=1)
        med = np.where(np.isfinite(med) & (med > 0), med, 1.0)
        ref = reference.Arm(lam, flux, np.where(bad, 1e9 * med[:, None],
                                                sig),
                            ~bad, st['grids'][arm['setup']],
                            cfg['fit']['npoly'], ctx.device)
        medf = np.nanmedian(np.where(bad, np.nan, flux), axis=1)
        gmed = np.nanmedian(np.where(bad, np.nan, sig), axis=1)
        err = np.maximum(sig, 0.3 * gmed[:, None])
        err = np.where(bad, 1000.0 * medf[:, None], err)
        ref.ccf = reference_ccf.CcfArm(
            lam, flux, err, bad, st['grids'][arm['setup']],
            cfg['templates']['setups'][arm['setup']],
            cfg['templates']['step'], ctx.device)
        arms.append(ref)
    return arms


def velocity_devs(ctx, st, win):
    """|v_fit - v_true| of every spectrum completed in the window."""
    return [abs(float(v - t)) for k in _files(st, win)
            for v, t in zip(st['captured'][k]['vrad'],
                            st['truths'][k]['vel'][st['captured'][k]['idx']])]


def free(ctx, st):
    """Drop the program's models and banks and the input files; keep
    each group's phases (group i fitted files coalesce*i...)."""
    for k in ('models', 'banks'):
        st.pop(k, None)
    ctx.phases = {i: dict(g['out']['phases'], nfibers=g['nfibers'])
                  for i, g in enumerate(ctx.groups)}
    ctx.groups.clear()
    shutil.rmtree(st['workdir'], ignore_errors=True)
