"""Batched multi-fiber fitting on one device.

Counterpart of rvspecfit_tpu/fit/batch.py for the fit-only main path:
the Nelder-Mead rounds with straggler compaction, the iterative
velocity refinement and the best-fit models, all on a whole exposure
of fibers that share per-arm wavelength grids.  The device of the
template tensors decides where everything runs (CUDA: float32 and the
CUDA kernels; CPU: float64 and their plain versions).

Not ported yet: the gradient polish, the AD Hessian errors, the
deferred tail, the mesh and the compile warm-up.
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch

from rvspecfit_torch.fit import neldermead as nm
from rvspecfit_torch.fit.likelihood import (chisq_trials_core,
                                            doppler_u, overlap_check,
                                            scan_core, template_stages)
from rvspecfit_torch.fit.spec_data import ArmState
from rvspecfit_torch.fit.vel_fit import SIMPLEX_SEED
from rvspecfit_torch.ops import chisq as chisq_mod
from rvspecfit_torch.ops import vsini as vsini_mod
from rvspecfit_torch.ops.resolution import BandedMatrix
from rvspecfit_torch.ops.spline_eval import spline_eval_index


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


def scan_stats(vels, mask, chi):
    """Minimum + posterior moments of (B, V) velocity scans.

    Returns (B, 5) [best_vel, vel_err, best_chi, skewness, kurtosis];
    uniform grids per fiber, masked entries ignored; quadratic minimum
    refinement with fallbacks to the grid point (edge, non-convex, or
    vertex escaping the bracket).
    """
    b, v = chi.shape
    rows = torch.arange(b, device=chi.device)
    chi_m = torch.where(mask, chi, torch.inf)
    i1 = torch.argmin(chi_m, dim=1)
    best_chi = chi_m[rows, i1]
    step = vels[:, 1] - vels[:, 0]
    ic = torch.clamp(i1, 1, v - 2)
    y0, y1, y2 = chi_m[rows, ic - 1], chi_m[rows, ic], chi_m[rows, ic + 1]
    denom = y0 - 2 * y1 + y2
    offset = 0.5 * (y0 - y2) / torch.where(denom == 0, 1.0, denom)
    interior = (i1 >= 1) & (i1 <= v - 2) & torch.isfinite(y0) \
        & torch.isfinite(y2)
    good = interior & (denom > 0) & (offset.abs() < 1)
    best_vel = torch.where(good, vels[rows, ic] + offset * step,
                           vels[rows, i1])
    dchi = chi_m - best_chi[:, None]
    probs = torch.where(mask, torch.exp(-0.5 * torch.clamp(dchi, 0, 1400)),
                        0.0)
    probs = probs / probs.sum(1, keepdim=True)
    dv = vels - best_vel[:, None]
    err = torch.sqrt((probs * dv * dv).sum(1))
    safe = err > 1e-10
    err_s = torch.where(safe, err, 1.0)
    skew = torch.where(safe, (probs * dv**3).sum(1) / err_s**3, 0.0)
    kurt = torch.where(safe, (probs * dv**4).sum(1) / err_s**4, 0.0)
    return torch.stack([best_vel, err, best_chi, skew, kurt], dim=1)


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
        return torch.as_tensor(np.asarray(x, np.float64), dtype=self.dtype,
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
                        chi).double().cpu().numpy()
        return dict(best_vel=st[:, 0], vel_err=st[:, 1], best_chi=st[:, 2],
                    skewness=st[:, 3], kurtosis=st[:, 4])

    # -------------------------------------------------------------
    def _objective(self, mapper, priors, idx):
        """fun(x (b, K, nvec)) -> (b, K) for the fibers ``idx``: -2logL
        plus priors and the vsini penalty; 1e30 outside the velocity
        bounds or at non-finite parameters."""
        min_vel = float(self.config['min_vel'])
        max_vel = float(self.config['max_vel'])
        prior_rows = [(i, float(priors[p][0]), float(priors[p][1]))
                      for i, p in enumerate(mapper.specParams)
                      if priors and p in priors]
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
            for i, mu, sig in prior_rows:
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
        around an unconverged fiber's best vertex.

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
        xatol = self._tensor(scales * 0.08 if xatol is None else xatol)
        simplex = self._tensor(nm.build_simplex(x0, scales, SIMPLEX_SEED))
        fvals = torch.zeros((b, nvec + 1), dtype=self.dtype,
                            device=self.device)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        evals = 0

        def init(idx):
            nonlocal evals
            fun = self._objective(mapper, priors, idx)
            fvals[idx], done[idx] = nm.nm_init(fun, simplex[idx], fatol,
                                               xatol)
            evals += idx.numel() * (nvec + 1)

        init(torch.arange(b, device=self.device))
        for restart in range(maxrestart):
            if restart > 0:
                undone = torch.nonzero(~done)[:, 0]
                if undone.numel() == 0:
                    break
                ib = torch.argmin(fvals[undone], dim=1)
                xb = simplex[undone, ib].double().cpu().numpy()
                simplex[undone] = self._tensor(nm.build_simplex(
                    xb, scales, SIMPLEX_SEED + restart))
                init(undone)
            nit = 0
            while nit < maxiter:
                undone = torch.nonzero(~done)[:, 0]
                if undone.numel() == 0:
                    break
                logging.info('NM restart %d nit %d: %d/%d unconverged',
                             restart, nit, undone.numel(), b)
                fun = self._objective(mapper, priors, undone)
                s, f, d, it = nm.nm_chunk(fun, simplex[undone],
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
            new = scan_stats(grid, mask, chi)
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
        """Best-fit models of every fiber and arm at the optimum.

        Returns dict of per-arm {name: (B, npix)} models, raw_models,
        cont_models (continuum-only fit), and masked true chisq,
        cont_chisq, npix, red_chisq — computed from the arms this
        fitter was built with."""
        vel = self._tensor(best_vel)
        stage = template_stages(self.templates, self._tensor(params),
                                self._vsinis(vsinis), self.use_vsini,
                                self.half_widths)
        flat = []
        for arm in self.arms:
            geom = self.templates[arm.setup].geom
            val = spline_eval_index(geom, stage[arm.setup][0],
                                    doppler_u(arm, geom, vel))
            ctempl = torch.ones_like(val)
            if arm.band is not None:
                val = arm.band.matvec(val)
                ctempl = arm.band.matvec(ctempl)
            models = []
            for t in (val, ctempl):
                _, coef = chisq_mod.chisq_continuum_marg_batch(
                    arm.dvec, t * arm.espec_inv, arm.polys, arm.polys_prod,
                    arm.log_espec_sum, with_coeffs=True)
                models.append((coef @ arm.polys) * t)
            flat.append([x.double().cpu().numpy()
                         for x in (models[0], val, models[1])])
        return self._models_finalize(flat, self.batch_arms)

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
