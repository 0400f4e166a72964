"""DESI survey fit: the device stage of one fiber group.

Counterpart of ``_run_group_fit`` in rvspecfit_tpu/survey/desi.py, its
synchronous branch (``RVST_DEFER_TAIL=0``): CCF starts -> Nelder-Mead
-> gradient polish -> velocity refinement -> AD Hessian errors ->
best-fit models.  File I/O, fiber selection, resolution matrices and
the RVTAB/RVMOD writers are not ported yet, nor the deferred tail, the
compile warm-up and the brute-force first guess (``ccf_init=False``).
A CCF failure raises (the reference logs it and starts every fiber at
the default parameters).
"""
from __future__ import annotations

import logging
import time

import numpy as np

from rvspecfit_torch.fit import ccf as ccf_mod
from rvspecfit_torch.fit import vel_fit
from rvspecfit_torch.fit.batch import BatchedFitter

# start parameters of a fiber whose CCF chi-square is not finite
DEFAULT_START = (5000.0, 3.0, -1.0, 0.2)
# CCF-stage column names of the parameters (reference schema)
CCF_NAMES = dict(teff='TEFF', logg='LOGG', feh='FEH', alpha='ALPHAFE')


def _ccf_args(arms):
    """Arm tuples consumed by the batched CCF fitter."""
    return [(a.setup, a.lam, a.flux,
             1.0 / np.sqrt(np.maximum(a.ivar, 1e-30)), a.badmask)
            for a in arms]


def _run_group_fit(arms, templates, config, options, banks=None):
    """Fit a stacked fiber batch: list of BatchArm, setup ->
    TemplateModel (all on one device), config (min_vel, max_vel,
    vel_step0, min_vel_step, max_vsini, min_vsini, second_minimizer,
    and template_lib where ``banks`` is None), fitter options.

    ``banks`` : optional {setup: (tfft, t2fft, info)} in-memory CCF
    banks; None loads them from the library onto the templates' device.
    Returns per-fiber host arrays: ref, params, vsini, errs, bad_hess,
    mods, converged, ccf_cols, vrad_ccf, parnames, and phases (seconds
    per stage: ccf, nm, polish, refine, hessian, models).
    """
    nf = arms[0].nfibers
    parnames = templates[arms[0].setup].parnames
    device = next(iter(templates.values())).geom.h.device
    t = [time.perf_counter()]

    cres = ccf_mod.fit_batch(_ccf_args(arms), config, banks=banks,
                             device=device)
    order = [cres['parnames'].index(p) for p in parnames]
    start_params = np.array(cres['best_params'], np.float64)[:, order]
    start_vel = np.array(cres['best_vel'], np.float64)
    vs = cres['best_vsini']
    has_vs = np.isfinite(vs)
    start_vsini = np.where(has_vs, vs, 0.0)
    bad = ~np.isfinite(cres['best_chi'])
    if bad.any():
        logging.warning('CCF failed for %d fibers', bad.sum())
        start_params[bad] = DEFAULT_START[:len(parnames)]
        start_vel[bad] = 0.0
    ccf_cols = dict(CHISQ_CCF=cres['best_chi'],
                    VSINI_CCF=np.where(has_vs, vs, 0.0))
    for j, p in enumerate(parnames):
        ccf_cols[CCF_NAMES.get(p, p.upper()) + '_CCF'] = start_params[:, j]
    vrad_ccf = start_vel.copy()
    t.append(time.perf_counter())

    # rotation is modeled only when the CCF bank's best templates
    # carried vsini
    fit_vsini = bool(has_vs.any())
    bf = BatchedFitter(arms, templates, config, options=options,
                       use_vsini=fit_vsini)
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
    t.append(time.perf_counter())

    tail = bf.run_tail(mapper, nmres['x'], fun=nmres['fun'],
                       parnames=parnames,
                       polish=bool(config.get('second_minimizer')))
    phases = dict(zip(('ccf', 'nm'), np.diff(t)), **tail['phases'])
    logging.debug('fit phases: %s', ' '.join(
        f'{k}={v:.2f}s' for k, v in phases.items()))
    return dict(ref=tail['ref'], params=tail['params'],
                vsini=tail['vsini'], errs=tail['errs'],
                bad_hess=tail['bad_hess'], mods=tail['mods'],
                converged=nmres['converged'], ccf_cols=ccf_cols,
                vrad_ccf=vrad_ccf, parnames=parnames, phases=phases,
                nm=nmres, x=tail['x'], fun=tail['fun'])
