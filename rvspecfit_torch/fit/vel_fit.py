"""The maximum-likelihood fit of one object, and the optimization-vector
mapping and Hessian errors the batched fit shares.

Counterpart of rvspecfit_tpu/fit/vel_fit.py.  :func:`process` runs, on
the device of the template models:

1. a velocity scan at the starting parameters (find_best: kernel A,
   shared mode);
2. Nelder-Mead on [vel, vsini?, free parameters] with bounds, priors
   and the vsini penalty (neldermead.minimize_batch: float64
   bookkeeping, trials through kernel A per-row), restarted once from
   a fresh simplex;
3. optionally BFGS (scipy) with the autograd gradient (kernel A's
   adjoint on the card), kept only where it does not raise the
   objective;
4. iterative velocity refinement (kernel A, shared mode);
5. the best-fit models (FusedChisq.full_output);
6. parameter errors from the AD Hessian of 0.5 chi-square plus priors
   (FusedChisq.hessian) with the robust inversion fallbacks.

:func:`firstguess` is the brute-force start over a small grid.
"""
from __future__ import annotations

import itertools
import logging
import math

import numpy as np
import scipy.linalg
import scipy.optimize
import torch

from rvspecfit_torch import trace
from rvspecfit_torch.fit import neldermead as nm
from rvspecfit_torch.fit.find_best import find_best, scan_stats
from rvspecfit_torch.fit.likelihood import FusedChisq
from rvspecfit_torch.ops.clip import clip

SIMPLEX_SEED = 20260816


class VSiniMapper:
    """Internal <-> physical vsini with a quadratic out-of-range
    penalty; ``min_vsini`` floors the fitted rotation."""

    def __init__(self, max_vsini, min_vsini=0.0):
        self.max_vsini = float(max_vsini)
        self.min_vsini = float(min_vsini)

    def to_internal(self, vsini):
        return float(np.clip(vsini, self.min_vsini, self.max_vsini))

    def to_vsini(self, x):
        v = clip(x, self.min_vsini, self.max_vsini)
        return v, (v - x)**2


class ParamMapper:
    """Pack/unpack the optimization vector [vel, vsini?, free params]."""

    def __init__(self, specParams, paramDict0, fixParam, vsiniMapper,
                 fitVsini):
        self.specParams = tuple(specParams)
        self.paramDict0 = dict(paramDict0)
        self.fixParam = tuple(fixParam or ())
        self.vsiniMapper = vsiniMapper
        self.fitVsini = bool(fitVsini)
        self.free_names = [p for p in self.specParams
                           if p not in self.fixParam]

    @property
    def nvec(self):
        return 1 + int(self.fitVsini) + len(self.free_names)

    def get_fitted_params(self):
        out = ['vel']
        if self.fitVsini:
            out.append('vsini')
        return out + self.free_names

    def start_vector(self, best_vel):
        vec = [best_vel]
        if self.fitVsini:
            vec.append(self.vsiniMapper.to_internal(
                self.paramDict0['vsini']))
        vec.extend(self.paramDict0[p] for p in self.free_names)
        return np.array(vec, dtype=np.float64)

    def scales(self):
        std = {'logg': 0.5, 'teff': 300.0, 'feh': 0.5, 'alpha': 0.25}
        vec = [5.0]
        if self.fitVsini:
            vec.append(3.0)
        vec.extend(std.get(p, 0.5) for p in self.free_names)
        return np.array(vec, dtype=np.float64)

    def _columns(self, pvec, full):
        idx = 2 if self.fitVsini else 1
        free = itertools.count(idx)
        return [full(float(self.paramDict0[p])) if p in self.fixParam
                else pvec[:, next(free)] for p in self.specParams]

    def unpack_host(self, pvec):
        """numpy (B, nvec) -> (vel (B,), params (B, ndim), vsini (B,))."""
        pvec = np.atleast_2d(np.asarray(pvec, np.float64))
        b = pvec.shape[0]
        if self.fitVsini:
            vsini = np.clip(pvec[:, 1], self.vsiniMapper.min_vsini,
                            self.vsiniMapper.max_vsini)
        elif 'vsini' in self.fixParam:
            vsini = np.full(b, float(self.paramDict0['vsini']))
        else:
            vsini = np.zeros(b)
        cols = self._columns(pvec, lambda x: np.full(b, x))
        return pvec[:, 0], np.stack(cols, axis=1), vsini

    def unpack(self, pvec):
        """(B, nvec) tensor -> (vel (B,), params (B, ndim), vsini (B,),
        penalty (B,)); vsini is 0 when rotation is not modeled."""
        b = pvec.shape[0]
        full = lambda x: torch.full((b,), x, dtype=pvec.dtype,
                                    device=pvec.device)
        penalty = full(0.0)
        if self.fitVsini:
            vsini, penalty = self.vsiniMapper.to_vsini(pvec[:, 1])
        elif 'vsini' in self.fixParam:
            vsini = full(float(self.paramDict0['vsini']))
        else:
            vsini = full(0.0)
        params = torch.stack(self._columns(pvec, full), dim=1)
        return pvec[:, 0], params, vsini, penalty


def uncertainties_from_hessian(hessian):
    """Robust parameter errors and covariance from a (possibly bad)
    host Hessian: (err (ndim,), covariance, bad_hessian).

    The inverse's diagonal gives the errors; where it is negative the
    inverse of the Hessian's diagonal stands in (error 0 and then NaN
    where that is negative too), and a failed inversion falls back to
    the inverse diagonal.  Any of these, or a non-finite error, flags
    the Hessian as bad; a failed inversion is logged at DEBUG (the batch
    logs one summary line)."""
    diag_h = np.diag(hessian)
    inv_diag = 1.0 / (diag_h + (diag_h == 0))
    inv_diag[diag_h == 0] = np.inf
    bad_hessian = False
    try:
        hess_inv = scipy.linalg.inv(hessian)
    except (np.linalg.LinAlgError, ValueError):
        bad_hessian = True
        logging.debug('Hessian inversion failed')
        hess_inv = np.diag(inv_diag)
    diag_err0 = np.array(np.diag(hess_inv), dtype=np.float64)
    bad0 = diag_err0 < 0
    bad1 = inv_diag < 0
    if bad0.any():
        bad_hessian = True
    sub1 = bad0 & ~bad1
    sub2 = bad0 & bad1
    diag_err0[sub1] = inv_diag[sub1]
    diag_err0[sub2] = 0
    err = np.sqrt(diag_err0)
    err[sub2] = np.nan
    if (~np.isfinite(err)).any():
        bad_hessian = True
    return err, hess_inv, bad_hessian


def prior_rows(names, priors):
    """[(index, mean, sigma)] of the parameters that have a prior."""
    return [(i, float(priors[p][0]), float(priors[p][1]))
            for i, p in enumerate(names or ()) if priors and p in priors]


def _make_objective(fused, mapper, config, priors):
    """Batched objective, tensor (B, nvec) -> (B,): -2logL plus priors
    and the vsini penalty; 1e30 outside the velocity bounds or at
    non-finite parameters."""
    min_vel, max_vel = float(config['min_vel']), float(config['max_vel'])
    rows = prior_rows(mapper.specParams, priors)

    def objective(pvec):
        vel, params, vsini, penalty = mapper.unpack(pvec)
        chis = fused._chisq_trials(vel, params, vsini)
        for i, mu, sig in rows:
            chis = chis + ((params[:, i] - mu) / sig)**2
        chis = chis + penalty
        bad = (vel > max_vel) | (vel < min_vel) \
            | ~torch.isfinite(params).all(1)
        return torch.where(bad, 1e30, chis)

    return objective


def _minimum_sampler(scan_fn, best_vel, min_vel, max_vel, vel_step0,
                     min_vel_step, crit_ratio=5.0, goal_width=10.0,
                     maxiter=10):
    """Iterative velocity-grid refinement: scan, then narrow the window
    and the step around the minimum until the step resolves the
    velocity error.  scan_fn(vels) -> (best_vel, err, result)."""
    best_vel = float(np.clip(best_vel, min_vel, max_vel))
    vel_step = vel_step0
    for it in range(maxiter):
        grid_lo = math.ceil((min_vel - best_vel) / vel_step) * vel_step
        vels = np.arange(grid_lo, max_vel - best_vel, vel_step) + best_vel
        best_vel, cur_err, res = scan_fn(vels)
        if vel_step < cur_err / crit_ratio or vel_step < min_vel_step:
            break
        if vel_step > cur_err:
            vel_step_new = vel_step / crit_ratio
            width_new = vel_step * goal_width
        else:
            vel_step_new = cur_err / crit_ratio * 0.8
            width_new = cur_err * goal_width
        min_vel = max(best_vel - width_new, min_vel)
        max_vel = min(best_vel + width_new, max_vel)
        vel_step = vel_step_new
    if it > 5:
        logging.warning('Velocity-error refinement used %d iterations', it)
    return best_vel, cur_err, res


def _scan_velocities(fused, vels, param, vsini):
    """Minimum and posterior moments of the chi-square over ``vels`` at
    one parameter vector (FusedChisq.scan, then scan_stats in float64).
    The reference pads the grid to a power of two to bound its compiled
    shapes; an eager scan needs no padding.  Returns (best_vel, err,
    result dict)."""
    chis = fused.scan(vels, param, None if vsini is None else [vsini])
    vels_t = torch.as_tensor(np.asarray(vels, np.float64)[None],
                             device=chis.device)
    st = scan_stats(vels_t, torch.ones_like(vels_t, dtype=torch.bool),
                    chis.double())[0][0].tolist()
    best_vel, err, best_chi, skew, kurt = st
    return best_vel, err, dict(best_vel=best_vel, vel_err=err,
                               skewness=skew, kurtosis=kurt,
                               best_chi=best_chi)


def _templates_for(specdata, config, templates, device):
    if templates is not None:
        return templates
    from rvspecfit_torch.pipeline.library import load_template_models
    return load_template_models(config, {sd.name for sd in specdata},
                                device=device)


def process(specdata, paramDict0, fixParam=None, options=None, config=None,
            resolParams=None, priors=None, templates=None,
            espec_systematic=None, device=None):
    """Maximum-likelihood fit of one object.

    specdata : list of SpecData (name = setup); paramDict0 : starting
    parameters (with 'vsini' to model rotation; add it to fixParam to
    keep it fixed); priors : {name: (mean, sigma)}; resolParams :
    {setup: BandedMatrix}; templates : {setup: TemplateModel}, or None
    to load them from config['template_lib'] onto ``device`` (None: the
    CUDA card).  The fit runs on the templates' device.

    Returns dict of param, param_err, param_covar, vel, vel_err,
    vel_skewness, vel_kurtosis, [vsini], yfit, raw_models, chisq, logl,
    chisq_array, npix_array, minimize_success, bad_hessian.
    """
    if config is None:
        raise RuntimeError('config must be provided')
    if not isinstance(specdata, (list, tuple)):
        specdata = [specdata]
    options = options or {}
    fixParam = fixParam or []
    templates = _templates_for(specdata, config, templates, device)
    min_vel, max_vel = config['min_vel'], config['max_vel']
    vel_step0, min_vel_step = config['vel_step0'], config['min_vel_step']
    fitVsini = 'vsini' in paramDict0 and 'vsini' not in fixParam
    use_vsini = 'vsini' in paramDict0
    vsiniMapper = VSiniMapper(config['max_vsini'],
                              config.get('min_vsini') or 0.0) \
        if fitVsini else None
    specParamNames = templates[specdata[0].name].parnames
    curparam = np.array([paramDict0[p] for p in specParamNames],
                        np.float64)
    # each stage is a span vel_fit.<stage> (rvspecfit_torch.trace)
    total = []

    def phase(sp):
        total.append(sp.seconds)
        logging.debug('process() phase %s: %.3f s',
                      sp.name[len('vel_fit.'):], sp.seconds)

    with trace.span('vel_fit.setup') as sp:
        fused = FusedChisq(specdata, templates, config, options=options,
                           resol_mats=resolParams, use_vsini=use_vsini,
                           espec_systematic=espec_systematic)
    phase(sp)

    # 1. velocity scan at the starting parameters
    with trace.span('vel_fit.scan') as sp:
        rot0 = paramDict0.get('vsini') if use_vsini else None
        best_vel = find_best(fused, np.arange(min_vel, max_vel, vel_step0),
                             [curparam], vsini=rot0)['best_vel']
    phase(sp)

    # 2. Nelder-Mead, restarted once from a fresh simplex around its best
    with trace.span('vel_fit.neldermead') as sp:
        mapper = ParamMapper(specParamNames, paramDict0, fixParam,
                             vsiniMapper, fitVsini)
        objective = _make_objective(fused, mapper, config, priors)
        nvec = mapper.nvec

        def nm_objective(x):
            return objective(x.reshape(-1, nvec)).reshape(x.shape[:2])

        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                        device=fused.device)
        scales = mapper.scales()
        simplex = f64(nm.build_simplex(
            mapper.start_vector(best_vel)[None], scales, SIMPLEX_SEED))
        minimize_success = True
        maxiter = 2
        nm_fatol = config.get('nm_fatol') or 1e-3
        for curiter in range(1, maxiter + 1):
            nmres = nm.minimize_batch(nm_objective, simplex,
                                      fatol=nm_fatol, xatol=scales * 0.01,
                                      maxiter=10000, dtype=fused.dtype)
            xbest = nmres['x'][0].cpu().numpy()
            if bool(nmres['converged'][0]):
                break
            if curiter == maxiter:
                logging.warning('Maximum number of NM restarts reached')
                minimize_success = False
                break
            # a fresh simplex: re-feeding the collapsed one replays the
            # collapse
            simplex = f64(nm.build_simplex(xbest[None], scales,
                                           SIMPLEX_SEED + curiter))

        # 3. optional BFGS with autograd gradients, kept if not worse
        if config.get('second_minimizer'):
            def fun_and_jac(p):
                x = fused.tensor(p).requires_grad_(True)
                with torch.enable_grad():
                    v = objective(x[None])[0]
                    g, = torch.autograd.grad(v, x)
                return float(v.detach()), g.double().cpu().numpy()

            res2 = scipy.optimize.minimize(fun_and_jac, xbest, jac=True,
                                           method='BFGS')
            logging.debug('BFGS: %d objective and gradient calls', res2.nfev)
            if np.isfinite(res2.fun) and res2.fun <= float(nmres['fun'][0]):
                xbest = res2.x
    phase(sp)
    vel_b, params_b, vsini_b = mapper.unpack_host(xbest[None])
    best_params = params_b[0]
    best_vel = float(vel_b[0])
    best_vsini = float(vsini_b[0]) if use_vsini else None
    ret = dict(param=dict(zip(specParamNames, best_params.tolist())))
    if fitVsini:
        ret['vsini'] = best_vsini

    # 4. velocity refinement
    with trace.span('vel_fit.refinement') as sp:
        best_vel, vel_err, res1 = _minimum_sampler(
            lambda vels: _scan_velocities(fused, vels, best_params,
                                          best_vsini),
            best_vel, min_vel, max_vel, vel_step0, min_vel_step)
    phase(sp)
    ret.update(vel=best_vel, vel_err=vel_err,
               vel_skewness=res1['skewness'],
               vel_kurtosis=res1['kurtosis'])

    # 5. models at the optimum
    with trace.span('vel_fit.models') as sp:
        outp = fused.full_output(best_vel, best_params, best_vsini)
    phase(sp)

    # 6. AD Hessian of 0.5 (chisq + priors) in the parameters
    with trace.span('vel_fit.hessian') as sp:
        hess = fused.hessian(best_vel, best_params, best_vsini,
                             prior_rows(specParamNames, priors))
        diag_err, covar, bad_hessian = uncertainties_from_hessian(
            hess.double().cpu().numpy())
    phase(sp)
    logging.debug('process() total: %.3f s', sum(total))
    ret.update(param_err=dict(zip(specParamNames, diag_err.tolist())),
               param_covar=covar, minimize_success=minimize_success,
               bad_hessian=bad_hessian, yfit=outp['models'],
               raw_models=outp['raw_models'], chisq=outp['chisq'],
               logl=outp['logl'], chisq_array=outp['chisq_array'],
               npix_array=outp['npix_array'])
    return ret


def firstguess(specdata, options=None, config=None, resolParams=None,
               vsinigrid=(None, 10, 100), paramsgrid=None, templates=None,
               device=None):
    """Brute-force start: the best of a small parameter grid at each
    vsini of ``vsinigrid`` (None: no rotation), over the velocity grid
    min_vel..max_vel at vel_step0.  Returns {param: value} (with 'vsini'
    when the best one rotates)."""
    if not isinstance(specdata, (list, tuple)):
        specdata = [specdata]
    options = options or {}
    templates = _templates_for(specdata, config, templates, device)
    if paramsgrid is None:
        paramsgrid = {'logg': [1, 2, 3, 4, 5],
                      'teff': [3000, 5000, 8000, 10000],
                      'feh': [-2, -1, 0],
                      'alpha': [0]}
    specParams = templates[specdata[0].name].parnames
    params = [[dict(zip(paramsgrid, combo))[p] for p in specParams]
              for combo in itertools.product(*paramsgrid.values())]
    vels_grid = np.arange(config['min_vel'], config['max_vel'],
                          config['vel_step0'])
    best_chisq = np.inf
    bestpar = None
    for vsini in vsinigrid:
        fused = FusedChisq(specdata, templates, config, options=options,
                           resol_mats=resolParams,
                           use_vsini=vsini is not None)
        res = find_best(fused, vels_grid, params, vsini=vsini)
        if res['best_chi'] < best_chisq:
            bestpar = dict(zip(specParams, res['best_param']))
            if vsini is not None:
                bestpar['vsini'] = vsini
            best_chisq = res['best_chi']
    return bestpar
