"""Batched multi-fiber fitting on one device.

Counterpart of rvspecfit_tpu/fit/batch.py: the Nelder-Mead rounds
with straggler compaction, the gradient polish, the iterative velocity
refinement, the AD Hessian errors and the best-fit models, all on a
whole exposure of fibers that share per-arm wavelength grids, and
:meth:`BatchedFitter.run_tail`, the synchronous post-NM chain.  The
device of the template tensors decides where everything runs (CUDA:
the CUDA kernels, the derivatives through kernel A's autograd pair;
CPU: their plain versions), and their dtype the precision (float64,
the working dtype on both).

Derivatives: fibers are independent, so one backward of the summed
objective gives every fiber's gradient, and one backward of each
gradient column (summed over fibers) gives every fiber's Hessian row
(:func:`grad_hessian`).

Not ported yet: the deferred tail (run_tail_async), the compile
warm-up (warm), the mesh, and the polish's environment knobs
(RVST_POLISH_STEPS, RVST_POLISH_FREEZE_H).
"""
from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from rvspecfit_torch.fit import neldermead as nm
from rvspecfit_torch.fit.find_best import scan_stats
from rvspecfit_torch.fit.likelihood import (chisq_trials_core,
                                            grad_hessian, hessian_core,
                                            models_core, overlap_check,
                                            scan_core)
from rvspecfit_torch.fit.spec_data import ArmState
from rvspecfit_torch.fit.vel_fit import (SIMPLEX_SEED, prior_rows,
                                         uncertainties_from_hessian)
from rvspecfit_torch.ops import vsini as vsini_mod
from rvspecfit_torch.ops.resolution import BandedMatrix


class BatchArm:
    """Stacked per-fiber data of one arm (host arrays)."""

    def __init__(self, name, lam, flux, ivar, badmask=None,
                 resolution=None, setup=None):
        """lam (npix,) shared grid; flux, ivar (B, npix); badmask
        (B, npix) bool; resolution (B, noff, npix) row-indexed bands."""
        self.name = str(name)
        self.setup = setup or self.name
        self.lam = np.asarray(lam, dtype=np.float64)
        self.flux = np.asarray(flux, dtype=np.float64)
        self.ivar = np.asarray(ivar, dtype=np.float64)
        self.badmask = (np.zeros(self.flux.shape, dtype=bool)
                        if badmask is None else np.asarray(badmask, bool))
        self.resolution = resolution
        if self.flux.ndim != 2 or self.flux.shape[1] != len(self.lam):
            raise ValueError('flux must be (nfibers, npix)')

    @property
    def nfibers(self):
        return self.flux.shape[0]

    def bad(self):
        return (~np.isfinite(self.ivar)) | (self.ivar <= 0) | self.badmask \
            | ~np.isfinite(self.flux)

    def espec(self):
        """Error vector; masked/invalid pixels get huge errors."""
        bad = self.bad()
        with np.errstate(divide='ignore', invalid='ignore'):
            esp = 1.0 / np.sqrt(np.where(bad, 1.0, self.ivar))
        med = np.median(np.where(bad, np.nan, esp), axis=1)
        med = np.where(np.isfinite(med) & (med > 0), med, 1.0)
        return np.where(bad, 1e9 * med[:, None], esp)


class BatchedFitter:
    """Fit a batch of fibers sharing arm wavelength grids."""

    def __init__(self, arms, templates, config, options=None,
                 use_vsini=False):
        """arms : list of BatchArm; templates : setup -> TemplateModel
        (all on one device); config : min_vel, max_vel, vel_step0,
        min_vel_step (and max_vsini with ``use_vsini``); options :
        npoly (default 5), rbf_continuum (default True)."""
        options = options or {}
        self.npoly = options.get('npoly') or 5
        self.rbf = options.get('rbf_continuum', True)
        self.config = config
        self.use_vsini = bool(use_vsini)
        self.templates = {}
        for a in arms:
            if a.setup not in templates:
                raise KeyError(f'no template model for setup {a.setup!r}')
            self.templates[a.setup] = templates[a.setup]
            overlap_check(templates[a.setup], a.lam, config['min_vel'],
                          config['max_vel'])
        geom0 = next(iter(self.templates.values())).geom
        self.device = geom0.h.device
        self.dtype = geom0.h.dtype
        self.batch_arms = list(arms)
        self.nfibers = arms[0].nfibers
        self.arms = []
        for a in arms:
            band = None
            if a.resolution is not None:
                res = np.asarray(a.resolution)
                w = res.shape[1] // 2
                band = BandedMatrix(tuple(k - w for k in range(res.shape[1])),
                                    res)
            self.arms.append(ArmState.from_host(
                a.name, a.setup, a.lam,
                np.where(np.isfinite(a.flux), a.flux, 0.0), a.espec(),
                self.templates[a.setup].geom, npoly=self.npoly,
                rbf=self.rbf, band=band, device=self.device,
                dtype=self.dtype))
        self.badchi = float(10 * sum(len(a.lam) for a in arms))
        self.half_widths = {}
        if self.use_vsini:
            for s, tm in self.templates.items():
                self.half_widths[s] = vsini_mod.kernel_half_width(
                    float(config['max_vsini']), tm.log_step)

    def _tensor(self, x):
        return torch.as_tensor(np.array(x, np.float64), dtype=self.dtype,
                               device=self.device)

    def _vsinis(self, vsinis):
        return torch.zeros(self.nfibers, dtype=self.dtype,
                           device=self.device) if vsinis is None \
            else self._tensor(vsinis)

    def _arms_at(self, idx):
        return [a.take(idx) for a in self.arms]

    # -------------------------------------------------------------
    def chisq(self, vels, params, vsinis=None):
        """(B, K) velocities x (B, K, ndim) params -> (B, K) -2logL
        tensor."""
        vels = self._tensor(vels)
        vs = torch.zeros_like(vels) if vsinis is None \
            else self._tensor(vsinis)
        return chisq_trials_core(self.arms, self.templates, vels,
                                 self._tensor(params), vs,
                                 badchi=self.badchi,
                                 use_vsini=self.use_vsini,
                                 half_widths=self.half_widths)

    def _scan(self, arms, vels, params, vsinis):
        return scan_core(arms, self.templates, vels, params, vsinis,
                         badchi=self.badchi, use_vsini=self.use_vsini,
                         half_widths=self.half_widths)

    def scan_velocities(self, vel_grid, params0, vsini0=None):
        """Velocity scan on a shared grid (V,) at per-fiber parameters
        (B, ndim).  Returns host (B,) best_vel, vel_err, best_chi,
        skewness, kurtosis."""
        vels = self._tensor(np.tile(np.asarray(vel_grid, np.float64),
                                    (self.nfibers, 1)))
        chi = self._scan(self.arms, vels, self._tensor(params0),
                         self._vsinis(vsini0))
        st = scan_stats(vels, torch.ones_like(vels, dtype=torch.bool),
                        chi)[0].double().cpu().numpy()
        return dict(best_vel=st[:, 0], vel_err=st[:, 1], best_chi=st[:, 2],
                    skewness=st[:, 3], kurtosis=st[:, 4])

    # -------------------------------------------------------------
    def _objective(self, mapper, priors, idx):
        """fun(x (b, K, nvec)) -> (b, K) for the fibers ``idx``: -2logL
        plus priors and the vsini penalty; 1e30 outside the velocity
        bounds or at non-finite parameters."""
        min_vel = float(self.config['min_vel'])
        max_vel = float(self.config['max_vel'])
        rows_p = prior_rows(mapper.specParams, priors)
        arms = self._arms_at(idx)

        def fun(x):
            b, k, nvec = x.shape
            vel, params, vsini, penalty = mapper.unpack(
                x.reshape(b * k, nvec))
            vel = vel.reshape(b, k)
            params = params.reshape(b, k, -1)
            chis = chisq_trials_core(arms, self.templates, vel, params,
                                     vsini.reshape(b, k),
                                     badchi=self.badchi,
                                     use_vsini=self.use_vsini,
                                     half_widths=self.half_widths)
            for i, mu, sig in rows_p:
                chis = chis + ((params[:, :, i] - mu) / sig)**2
            chis = chis + penalty.reshape(b, k)
            bad = (vel > max_vel) | (vel < min_vel) \
                | ~torch.isfinite(params).all(-1)
            return torch.where(bad, 1e30, chis)

        return fun

    def run_neldermead(self, mapper, best_vel0=None, priors=None,
                       maxrestart=2, fatol=5e-2, xatol=None, maxiter=384,
                       x0=None, nm_chunk=64):
        """Batched Nelder-Mead over fibers, with straggler compaction.

        Rounds of ``nm_chunk`` iterations run on the fibers that have
        not converged, gathered into one tile: once most fibers have
        converged a round costs only the stragglers.  (The reference's
        ladder of padded tile widths exists to bound XLA's compiled
        shapes; an eager tile is exactly the unconverged set.)  Each
        restart rebuilds a fresh simplex (seed SIMPLEX_SEED + restart)
        around an unconverged fiber's best vertex.  The simplexes, their
        values and every step's arithmetic are float64 on the device;
        only the objective's trial points are in the working dtype
        (neldermead.in_working_dtype).

        Starts: ``x0`` (B, nvec), or the mapper's start vector with
        per-fiber velocities ``best_vel0``.  xatol defaults to 8% of
        the mapper's per-dimension scales (the refinement owns the
        velocity endgame).  Returns host x (B, nvec), fun (B,),
        converged (B,), obj_evals.
        """
        if x0 is None:
            x0 = np.tile(mapper.start_vector(0.0), (self.nfibers, 1))
            x0[:, 0] = np.asarray(best_vel0)
        x0 = np.asarray(x0, np.float64)
        b, nvec = x0.shape
        scales = mapper.scales().astype(np.float64)
        f64 = lambda a: torch.as_tensor(np.array(a, np.float64),
                                        dtype=torch.float64,
                                        device=self.device)
        xatol = f64(scales * 0.08 if xatol is None else xatol)
        simplex = f64(nm.build_simplex(x0, scales, SIMPLEX_SEED))
        fvals = torch.zeros((b, nvec + 1), dtype=torch.float64,
                            device=self.device)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        evals = 0

        def objective(idx):
            return nm.in_working_dtype(
                self._objective(mapper, priors, idx), self.dtype)

        def init(idx):
            nonlocal evals
            fvals[idx], done[idx] = nm.nm_init(objective(idx),
                                               simplex[idx], fatol, xatol)
            evals += idx.numel() * (nvec + 1)

        init(torch.arange(b, device=self.device))
        for restart in range(maxrestart):
            if restart > 0:
                undone = torch.nonzero(~done)[:, 0]
                if undone.numel() == 0:
                    break
                ib = torch.argmin(fvals[undone], dim=1)
                xb = simplex[undone, ib].double().cpu().numpy()
                simplex[undone] = f64(nm.build_simplex(
                    xb, scales, SIMPLEX_SEED + restart))
                init(undone)
            nit = 0
            while nit < maxiter:
                undone = torch.nonzero(~done)[:, 0]
                if undone.numel() == 0:
                    break
                logging.info('NM restart %d nit %d: %d/%d unconverged',
                             restart, nit, undone.numel(), b)
                s, f, d, it = nm.nm_chunk(objective(undone),
                                          simplex[undone],
                                          fvals[undone], done[undone],
                                          fatol, xatol, nm_chunk)
                simplex[undone], fvals[undone], done[undone] = s, f, d
                evals += undone.numel() * it * 2
                nit += nm_chunk
        rows = torch.arange(b, device=self.device)
        ib = torch.argmin(fvals, dim=1)
        return dict(x=simplex[rows, ib].double().cpu().numpy(),
                    fun=fvals[rows, ib].double().cpu().numpy(),
                    converged=done.cpu().numpy(), obj_evals=evals)

    # -------------------------------------------------------------
    def _chisq_at(self, vel, params, vsinis):
        """(B,) -2logL of one trial per fiber: vel (B,), params (B,
        ndim), vsinis (B,); differentiable in params and vsinis."""
        return chisq_trials_core(self.arms, self.templates, vel[:, None],
                                 params[:, None, :], vsinis[:, None],
                                 badchi=self.badchi,
                                 use_vsini=self.use_vsini,
                                 half_widths=self.half_widths)[:, 0]

    def run_polish(self, mapper, x, priors=None, steps=2, fun0=None):
        """Batched gradient polish, the ``second_minimizer`` stage.

        ``steps`` damped-Newton iterations over the non-velocity
        coordinates [vsini?, free params] (the refinement re-measures
        the velocity right after): each solves (H + ridge) dx = -grad,
        ridge 1e-6 max(|diag H|, 1e-12), with exact AD derivatives of
        -2logL plus priors and the vsini penalty; a non-finite dx is 0.
        The ladder [1, 0.25, 0.05] and the current point are evaluated
        in one objective call, and a fiber moves only when a trial is
        strictly better than its current value.

        x : (B, nvec) NM optima; fun0 : optional (B,) NM best values.
        Returns host x (B, nvec), fun (B,), moved (B,).
        """
        x = np.asarray(x, np.float64)
        b = x.shape[0]
        xc = self._tensor(x)
        fc = self._tensor(np.full(b, np.inf) if fun0 is None else fun0)
        objective = self._objective(mapper, priors,
                                    torch.arange(b, device=self.device))
        rows_p = prior_rows(mapper.specParams, priors)
        ladder = self._tensor([1.0, 0.25, 0.05])

        def scalar_obj(vel, rest):
            _, params, vsini, penalty = mapper.unpack(
                torch.cat([vel[:, None], rest], dim=1))
            chi = self._chisq_at(vel, params, vsini)
            for i, mu, sig in rows_p:
                chi = chi + ((params[:, i] - mu) / sig)**2
            return chi + penalty

        for _ in range(steps):
            vel = xc[:, 0]
            g, h = grad_hessian(lambda rest: scalar_obj(vel, rest),
                                xc[:, 1:])
            dh = torch.diagonal(h, dim1=-2, dim2=-1).abs()
            ridge = 1e-6 * torch.clamp(dh, min=1e-12)
            dx = -torch.linalg.solve_ex(h + torch.diag_embed(ridge),
                                        g[..., None])[0][..., 0]
            dx = torch.where(torch.isfinite(dx), dx, 0.0)
            cand = xc[:, None, :].repeat(1, 4, 1)           # (B, 4, nvec)
            cand[:, :3, 1:] += ladder[None, :, None] * dx[:, None, :]
            fcand = objective(cand)
            fcand = torch.where(torch.isfinite(fcand), fcand, torch.inf)
            ib = torch.argmin(fcand, dim=1)
            # the reference's one-hot product: 0 * inf = NaN, so a fiber
            # with a non-finite trial does not move at this step
            onehot = torch.nn.functional.one_hot(ib, 4).to(fcand.dtype)
            fbest = (onehot * fcand).sum(1)
            xbest = cand[torch.arange(b, device=self.device), ib]
            better = fbest < fc
            xc = torch.where(better[:, None], xbest, xc)
            fc = torch.where(better, fbest, fc)
        xf = xc.double().cpu().numpy()
        return dict(x=xf, fun=fc.double().cpu().numpy(),
                    moved=np.any(xf != x, axis=1))

    # -------------------------------------------------------------
    def refine_velocities(self, best_vel, params, vsinis=None, maxiter=10):
        """Iterative velocity refinement: one full-range pass
        (min_vel..max_vel at vel_step0, to catch every CCF peak), then
        128-point window passes on the fibers whose step does not yet
        resolve their uncertainty, until all are done or ``maxiter``
        passes ran.  Returns host (B,) best_vel, vel_err, best_chi,
        skewness, kurtosis, iterations."""
        cfg = self.config
        crit_ratio, goal_width, nv_win = 5.0, 10.0, 128
        min_vel0, max_vel0 = float(cfg['min_vel']), float(cfg['max_vel'])
        min_vel_step = float(cfg['min_vel_step'])
        vel_step0 = float(cfg['vel_step0'])
        nv = int(math.ceil((max_vel0 - min_vel0) / vel_step0)) + 1
        b = self.nfibers
        params_t = self._tensor(params)
        vs_t = self._vsinis(vsinis)
        best = torch.clamp(self._tensor(best_vel), min_vel0, max_vel0)
        full = lambda x: torch.full((b,), x, dtype=self.dtype,
                                    device=self.device)
        lo, hi, step = full(min_vel0), full(max_vel0), full(vel_step0)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        stats = torch.zeros((b, 5), dtype=self.dtype, device=self.device)

        def one_pass(idx, nv_cur):
            g0 = torch.ceil((lo[idx] - best[idx]) / step[idx]) * step[idx]
            grid = g0[:, None] + torch.arange(
                nv_cur, dtype=self.dtype, device=self.device) \
                * step[idx][:, None] + best[idx][:, None]
            mask = grid < hi[idx][:, None]
            mask[:, 0] = True
            grid = torch.where(mask, grid, grid[:, :1])
            chi = self._scan(self._arms_at(idx), grid, params_t[idx],
                             vs_t[idx])
            new = scan_stats(grid, mask, chi)[0]
            stats[idx] = new
            best[idx] = new[:, 0]
            err = new[:, 1]
            st = step[idx]
            unresolved = st > err
            width = torch.where(unresolved, st * goal_width,
                                err * goal_width)
            lo[idx] = torch.clamp(new[:, 0] - width, min=min_vel0)
            hi[idx] = torch.clamp(new[:, 0] + width, max=max_vel0)
            step[idx] = torch.where(unresolved, st / crit_ratio,
                                    err / crit_ratio * 0.8)
            done[idx] = (st < err / crit_ratio) | (st < min_vel_step)

        one_pass(torch.arange(b, device=self.device), nv)
        it = 1
        while it < maxiter and not bool(done.all()):
            one_pass(torch.nonzero(~done)[:, 0], nv_win)
            it += 1
        out = stats.double().cpu().numpy()
        return dict(best_vel=out[:, 0], vel_err=out[:, 1],
                    best_chi=out[:, 2], skewness=out[:, 3],
                    kurtosis=out[:, 4], iterations=np.full(b, float(it)))

    # -------------------------------------------------------------
    def best_models(self, best_vel, params, vsinis=None):
        """Best-fit models of every fiber and arm at the optimum
        (likelihood.models_core).

        Returns dict of per-arm {name: (B, npix)} models, raw_models,
        cont_models (continuum-only fit), and masked true chisq,
        cont_chisq, npix, red_chisq — computed from the arms this
        fitter was built with."""
        mods = models_core(self.arms, self.templates,
                           self._tensor(best_vel), self._tensor(params),
                           self._vsinis(vsinis), use_vsini=self.use_vsini,
                           half_widths=self.half_widths)
        flat = [[x.double().cpu().numpy() for x in m] for m in mods]
        return self._models_finalize(flat, self.batch_arms)

    # -------------------------------------------------------------
    def hessians(self, best_vel, params, vsinis=None, priors=None,
                 parnames=None):
        """(B, ndim, ndim) exact AD Hessians of 0.5 (-2logL + priors)
        with respect to the parameters at velocities ``best_vel``
        (likelihood.hessian_core)."""
        return hessian_core(self.arms, self.templates,
                            self._tensor(best_vel), self._tensor(params),
                            self._vsinis(vsinis),
                            prior_rows(parnames, priors),
                            badchi=self.badchi, use_vsini=self.use_vsini,
                            half_widths=self.half_widths)

    def hessian_errors(self, best_vel, params, vsinis=None, priors=None,
                       parnames=None):
        """Per-fiber errors, covariances and BAD_HESSIAN flags (host)
        from :meth:`hessians` at the (refined) velocities."""
        h = self.hessians(best_vel, params, vsinis=vsinis, priors=priors,
                          parnames=parnames)
        return self._hessian_finalize(h.double().cpu().numpy())

    @staticmethod
    def _hessian_finalize(hessians):
        """(B, ndim, ndim) host Hessians -> (errs, covars, bad) with the
        per-fiber robust-inversion fallbacks, and one summary warning."""
        b, ndim = hessians.shape[:2]
        errs = np.zeros((b, ndim))
        covars = np.zeros((b, ndim, ndim))
        bad = np.zeros(b, bool)
        for i in range(b):
            errs[i], covars[i], bad[i] = uncertainties_from_hessian(
                hessians[i])
        nbad = int(bad.sum())
        if nbad:
            logging.warning('%d/%d fibers flagged BAD_HESSIAN (robust '
                            'inversion fallback used)', nbad, b)
        return errs, covars, bad

    # -------------------------------------------------------------
    def run_tail(self, mapper, x, fun=None, parnames=None, priors=None,
                 polish=True):
        """The post-NM chain, synchronously: gradient polish (optional)
        -> unpack -> velocity refinement -> AD Hessian errors -> best
        models.  x : (B, nvec) NM optima; fun : (B,) NM best values.
        Returns dict(x, fun, params, vsini, ref, errs, covars,
        bad_hess, mods), the keys of the reference's run_tail_async
        collect(), and phases: wall seconds of polish, refine, hessian
        and models (each stage ends in a fetch to the host)."""
        t = [time.perf_counter()]
        x = np.asarray(x, np.float64)
        if polish:
            pol = self.run_polish(mapper, x, priors=priors, fun0=fun)
            x, fun = pol['x'], pol['fun']
        elif fun is not None:
            fun = np.asarray(fun, np.float64)
        t.append(time.perf_counter())
        vel, params, vsini = mapper.unpack_host(x)
        ref = self.refine_velocities(vel, params, vsinis=vsini)
        t.append(time.perf_counter())
        errs, covars, bad = self.hessian_errors(
            ref['best_vel'], params, vsinis=vsini, priors=priors,
            parnames=parnames)
        t.append(time.perf_counter())
        mods = self.best_models(ref['best_vel'], params, vsinis=vsini)
        t.append(time.perf_counter())
        return dict(x=x, fun=fun, params=params, vsini=vsini, ref=ref,
                    errs=errs, covars=covars, bad_hess=bad, mods=mods,
                    phases=dict(zip(('polish', 'refine', 'hessian',
                                     'models'), np.diff(t))))

    @staticmethod
    def _models_finalize(flat, batch_arms):
        """Per-arm (model, raw, continuum model) host arrays -> result
        dict with the masked true / continuum-only chi-squares."""
        ret = dict(models={}, raw_models={}, cont_models={}, chisq={},
                   red_chisq={}, npix={}, cont_chisq={})
        for (model, raw, cmodel), a in zip(flat, batch_arms):
            esp = a.espec()
            good = ~a.bad()
            flux = np.where(good, a.flux, 0.0)
            dev = np.where(good, (model - flux) / esp, 0.0)
            cdev = np.where(good, (cmodel - flux) / esp, 0.0)
            ret['models'][a.name] = model
            ret['raw_models'][a.name] = raw
            ret['cont_models'][a.name] = cmodel
            ret['chisq'][a.name] = (dev**2).sum(axis=1)
            ret['cont_chisq'][a.name] = (cdev**2).sum(axis=1)
            ret['npix'][a.name] = good.sum(axis=1)
            ret['red_chisq'][a.name] = ret['chisq'][a.name] / np.maximum(
                ret['npix'][a.name], 1)
        return ret
