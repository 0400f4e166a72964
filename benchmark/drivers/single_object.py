"""Traffic of single objects through rvspecfit_torch's single-object
API: for each object, fit/ccf.fit, then fit/vel_fit.process from the
CCF's best parameters (and its rotation, where the bank has one).

Set-up makes ``objects`` spectra in memory (the stars, stratified
within each ``block``, and their noise from the run's seed) and the
template models and CCF banks on the card, and fits object 0 once (its
first fit builds the kernels).  The window fits objects 1, 2, ... one after another
(closed loop, one client); each completes when process returns.  All
objects completed in the window, up to ``sample`` of them drawn from
the seed, are judged against the reference."""
import time

import numpy as np

from benchlib import generator, program, reference


def prepare(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    models, grids, raw = program.template_models(ctx, cfg, ctx.dtype)
    banks = program.ccf_banks(ctx, cfg, raw, ctx.dtype)
    del raw
    n = int(tr['objects'])
    truth = generator.draw_truths(tr, n, ctx.rng(1000))
    noise = generator.device_generator(ctx.seed, ctx.device, 1000)
    data = {}
    for s, arm in cfg['arms'].items():
        flux, ivar = generator.observe(cfg, arm['setup'], arm, truth, noise,
                                       ctx.device)
        data[s] = (generator.arm_lam(arm), flux.astype(np.float64),
                   ivar.astype(np.float64))
    st = dict(models=models, grids=grids, banks=banks, truth=truth,
              data=data, results={})
    _fit(ctx, st, 0)                     # builds the kernels
    return st


def _fit(ctx, st, i):
    from rvspecfit_torch.fit import ccf, vel_fit
    from rvspecfit_torch.fit.spec_data import SpecData
    cfg = ctx.cell.config
    sds = [SpecData(arm['setup'], st['data'][s][0], st['data'][s][1][i],
                    1.0 / np.sqrt(st['data'][s][2][i]))
           for s, arm in cfg['arms'].items()]
    setups = {a['setup'] for a in cfg['arms'].values()}
    fit = dict(cfg['fit'])
    npoly = fit.pop('npoly')
    t0 = time.time()
    guess = ccf.fit(sds, fit, banks={s: st['banks'][s] for s in setups},
                    device=ctx.device)
    t1 = time.time()
    start = dict(guess['best_par'])
    if guess.get('best_vsini') is not None:
        start['vsini'] = guess['best_vsini']
    res = vel_fit.process(sds, start, config=fit, options={'npoly': npoly},
                          templates={s: st['models'][s] for s in setups},
                          device=ctx.device)
    t2 = time.time()
    ctx.spans.add('ccf', t0, t1, group=i)
    ctx.spans.add('process', t1, t2, group=i)
    return res


def measure(ctx, st, win, dtrace):
    from rvspecfit_torch.ops import ccf_chisq
    n = int(ctx.cell.traffic['objects'])
    with ctx.spans.wrap(ccf_chisq, 'ccf_chisq', 'kernel_b',
                        program.kernel_b_calls(ctx)):
        if dtrace is not None:
            dtrace.start()
            ctx.tracing = True
        for i in range(1, n):
            st['results'][i] = _fit(ctx, st, i)
            win.complete(1, key=i)
            if dtrace is not None and dtrace.due():
                dtrace.stop()
                ctx.tracing = False
            if win.closed:
                break


def answers(ctx, st, win):
    keys = list(win.keys())
    nmax = int(ctx.cell.traffic['sample'])
    if len(keys) > nmax:
        keys = sorted(ctx.rng(7).choice(keys, nmax, replace=False).tolist())
    st['rows'] = keys
    out = []
    for row, i in enumerate(keys):
        r = st['results'].get(i)
        a = dict(row=row, use_vsini=False, chisq_kind='m2logl')
        if r is not None:
            a.update(vel=float(r['vel']), vsini=r.get('vsini'),
                     params=[float(r['param'][p])
                             for p in generator.PARNAMES],
                     chisq=float(r['chisq']),
                     models=[np.asarray(m) for m in r['yfit']])
            a['use_vsini'] = 'vsini' in r
        out.append(a)
    return out


def reference_arms(ctx, st):
    cfg = ctx.cell.config
    arms = []
    for s, arm in cfg['arms'].items():
        lam, flux, ivar = st['data'][s]
        rows = st['rows']
        arms.append(reference.Arm(lam, flux[rows], 1.0 / np.sqrt(ivar[rows]),
                                  np.ones((len(rows), len(lam)), bool),
                                  st['grids'][arm['setup']],
                                  cfg['fit']['npoly'], ctx.device))
    return arms


def velocity_devs(ctx, st, win):
    """|v_fit - v_true| of every object completed in the window."""
    return [abs(st['results'][i]['vel'] - st['truth']['vel'][i])
            for i in win.keys()]


def free(ctx, st):
    for k in ('models', 'banks'):
        st.pop(k, None)
