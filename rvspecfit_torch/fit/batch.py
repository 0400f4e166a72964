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

Fiber microbatching (``microbatch``): every stage runs on tiles of at
most that many fibers, which bounds the device memory of a large group
(in float64 ~17 GB per 1000 fibers whole on an H100, PERF.md); every
stage is elementwise over fibers, so a tiled fit is the whole one.

The polish reads ``RVST_POLISH_STEPS`` (its Newton steps, default 2)
and ``RVST_POLISH_FREEZE_H=1`` (the Hessian of the first step reused
by the later ones), Nelder-Mead ``RVST_NM_XATOL_FRAC`` (its tolerance
as a fraction of the mapper's scales, default 0.08),
``RVST_NM_SIMPLEX_SCALE`` (the first simplex's size in those scales,
default 1), ``RVST_NM_CHUNK`` (its iterations per round) and, through
fit/neldermead.py, ``RVST_NM_SCHEME`` (its candidate scheme), as the
reference does.

:meth:`BatchedFitter.run_tail_async` runs the post-NM chain on a
worker thread and a CUDA stream of its own (device.Background), on a
snapshot of the fitter's arms, and returns ``collect``.  A fitter laid
over several devices by parallel/mesh.shard_fitter runs each stage
shard by shard, one host thread per shard, and concatenates the
results in fiber order.

Not ported: the reference's ``warm`` (it overlaps remote XLA compiles)
and ``update_arms`` (it reuses a fitter's compiled programs for the
next file; a fitter here serves one group, which is also what keeps a
deferred tail's arms its own).
"""
from __future__ import annotations

import copy
import logging
import math
import os

import numpy as np
import torch

from rvspecfit_torch import trace
from rvspecfit_torch.device import Background, map_tensors
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
                 use_vsini=False, microbatch=None):
        """arms : list of BatchArm; templates : setup -> TemplateModel
        (all on one device); config : min_vel, max_vel, vel_step0,
        min_vel_step (and max_vsini with ``use_vsini``); options :
        npoly (default 5), rbf_continuum (default True); microbatch :
        fit the fibers in tiles of at most this many (None: whole)."""
        options = options or {}
        if microbatch is not None and int(microbatch) < 1:
            raise ValueError(f'microbatch must be >= 1, not {microbatch}')
        self.microbatch = None if microbatch is None else int(microbatch)
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
        # parallel/mesh.shard_fitter's per-shard fitters and their
        # threads (None: the fitter runs on its one device)
        self.shards = self.shard_pools = None
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

    def _arms_at(self, idx, arms=None):
        return [a.take(idx) for a in (self.arms if arms is None else arms)]

    def _tiles(self, idx):
        """``idx`` (a long tensor of fibers) in tiles of at most
        ``microbatch`` fibers."""
        if self.microbatch is None:
            return [idx]
        return list(torch.split(idx, self.microbatch))

    def _run_mb(self, fn, *per_fiber):
        """fn(arms, *args) on every fiber: one call without
        ``microbatch``, else one per tile of consecutive fibers with the
        tile's arms and rows of ``per_fiber`` (tensors with a leading
        fiber axis), the outputs (tensors, or lists, tuples and dicts of
        them) concatenated along that axis."""
        b = self.nfibers
        if self.microbatch is None or self.microbatch >= b:
            return fn(self.arms, *per_fiber)
        parts = []
        for lo in range(0, b, self.microbatch):
            hi = min(lo + self.microbatch, b)
            idx = torch.arange(lo, hi, device=self.device)
            parts.append(fn(self._arms_at(idx),
                            *[a[lo:hi] for a in per_fiber]))
        return _concat_tiles(parts)

    # -------------------------------------------------------------
    def chisq(self, vels, params, vsinis=None):
        """(B, K) velocities x (B, K, ndim) params -> (B, K) -2logL
        tensor."""
        if self.shards:
            return self._on_shards('chisq', dict(vels=vels, params=params,
                                                 vsinis=vsinis))
        vels = self._tensor(vels)
        vs = torch.zeros_like(vels) if vsinis is None \
            else self._tensor(vsinis)
        return self._run_mb(
            lambda arms, v, p, w: chisq_trials_core(
                arms, self.templates, v, p, w, badchi=self.badchi,
                use_vsini=self.use_vsini, half_widths=self.half_widths),
            vels, self._tensor(params), vs)

    def _scan(self, arms, vels, params, vsinis, fast_interp=False):
        return scan_core(arms, self.templates, vels, params, vsinis,
                         badchi=self.badchi, use_vsini=self.use_vsini,
                         half_widths=self.half_widths,
                         fast_interp=fast_interp)

    def scan_velocities(self, vel_grid, params0, vsini0=None,
                        fast_interp=False):
        """Velocity scan on a shared grid (V,) at per-fiber parameters
        (B, ndim); ``fast_interp`` evaluates the templates at their
        nearest pixel (likelihood.doppler_eval).  Returns host (B,)
        best_vel, vel_err, best_chi, skewness, kurtosis."""
        if self.shards:
            return self._on_shards('scan_velocities', dict(
                params0=params0, vsini0=vsini0), vel_grid=vel_grid,
                fast_interp=fast_interp)
        vels = self._tensor(np.tile(np.asarray(vel_grid, np.float64),
                                    (self.nfibers, 1)))
        chi = self._run_mb(
            lambda arms, v, p, w: self._scan(arms, v, p, w, fast_interp),
            vels, self._tensor(params0), self._vsinis(vsini0))
        st = scan_stats(vels, torch.ones_like(vels, dtype=torch.bool),
                        chi)[0].double().cpu().numpy()
        return dict(best_vel=st[:, 0], vel_err=st[:, 1], best_chi=st[:, 2],
                    skewness=st[:, 3], kurtosis=st[:, 4])

    def scan_chisq(self, vel_grids, params0, vsini0=None, vchunk=128):
        """(B, V) per-fiber velocity grids x (B, ndim) params -> host
        (B, V) -2logL, the template stage once per fiber and the
        velocities in chunks of ``vchunk`` (bounding the device
        intermediates)."""
        if self.shards:
            return self._on_shards('scan_chisq', dict(
                vel_grids=vel_grids, params0=params0, vsini0=vsini0),
                vchunk=vchunk)
        vel_grids = np.asarray(vel_grids, np.float64)
        params, vs = self._tensor(params0), self._vsinis(vsini0)
        return np.concatenate([self._run_mb(
            self._scan, self._tensor(vel_grids[:, i:i + vchunk]), params,
            vs).double().cpu().numpy()
            for i in range(0, vel_grids.shape[1], vchunk)], axis=1)

    # -------------------------------------------------------------
    def _objective(self, mapper, priors, idx):
        """fun(x (b, K, nvec)) -> (b, K) for the fibers ``idx``
        (:meth:`_objective_arms`)."""
        return self._objective_arms(mapper, priors, self._arms_at(idx))

    def _objective_arms(self, mapper, priors, arms):
        """fun(x (b, K, nvec)) -> (b, K) for the fibers of ``arms``:
        -2logL plus priors and the vsini penalty; 1e30 outside the
        velocity bounds or at non-finite parameters."""
        min_vel = float(self.config['min_vel'])
        max_vel = float(self.config['max_vel'])
        rows_p = prior_rows(mapper.specParams, priors)

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
                       x0=None, nm_chunk=64, scheme=None):
        """Batched Nelder-Mead over fibers, with straggler compaction.

        Rounds of ``nm_chunk`` iterations (``RVST_NM_CHUNK`` overrides
        it when set and non-zero) run on the fibers that have not
        converged, gathered into one tile (or tiles of at most
        ``microbatch``): once most fibers have converged a round costs
        only the stragglers.  (The reference's
        ladder of padded tile widths exists to bound XLA's compiled
        shapes; an eager tile is exactly the unconverged set.)  Each
        restart rebuilds a fresh simplex (seed SIMPLEX_SEED + restart)
        around an unconverged fiber's best vertex.  The simplexes, their
        values and every step's arithmetic are float64 on the device;
        only the objective's trial points are in the working dtype
        (neldermead.in_working_dtype).

        Starts: ``x0`` (B, nvec), or the mapper's start vector with
        per-fiber velocities ``best_vel0``.  xatol defaults to
        ``RVST_NM_XATOL_FRAC`` (8%) of the mapper's per-dimension
        scales (the refinement owns the velocity endgame); the first
        simplex spans ``RVST_NM_SIMPLEX_SCALE`` (1) times those scales,
        a restart's the scales.  ``scheme``: neldermead's candidate
        scheme (None: ``RVST_NM_SCHEME``, read once per call, and
        handed to every shard).  Returns host x (B, nvec), fun (B,),
        converged (B,), obj_evals (the fiber-trials dispatched: nvec +
        1 per simplex set up and neldermead.nm_ncand(scheme), 2 under
        scan2 and 4 under cand4, per fiber and iteration of its tile;
        the rare shrink steps' evaluations are not counted).  Each round
        of a tile is a span ``fit.nm.round`` (:mod:`rvspecfit_torch.trace`)
        with its restart, width, iters and live_iters (neldermead.
        nm_chunk's ``stats``); the counters ``fit.nm.live_iters`` and
        ``fit.nm.tile_iters`` add up live_iters and width x iters.
        """
        scheme = nm.nm_scheme(scheme)
        chunk = int(os.environ.get('RVST_NM_CHUNK', '0')) or nm_chunk
        if self.shards:
            return self._on_shards(
                'run_neldermead', dict(best_vel0=best_vel0, x0=x0),
                mapper=mapper, priors=priors, maxrestart=maxrestart,
                fatol=fatol, xatol=xatol, maxiter=maxiter,
                nm_chunk=chunk, scheme=scheme)
        if x0 is None:
            x0 = np.tile(mapper.start_vector(0.0), (self.nfibers, 1))
            x0[:, 0] = np.asarray(best_vel0)
        x0 = np.asarray(x0, np.float64)
        b, nvec = x0.shape
        scales = mapper.scales().astype(np.float64)
        f64 = lambda a: torch.as_tensor(np.array(a, np.float64),
                                        dtype=torch.float64,
                                        device=self.device)
        if xatol is None:
            xatol = scales * float(os.environ.get('RVST_NM_XATOL_FRAC',
                                                  '0.08'))
        xatol = f64(xatol)
        sim_scale = float(os.environ.get('RVST_NM_SIMPLEX_SCALE', '1.0'))
        simplex = f64(nm.build_simplex(x0, scales * sim_scale,
                                       SIMPLEX_SEED))
        fvals = torch.zeros((b, nvec + 1), dtype=torch.float64,
                            device=self.device)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        evals, ncand = 0, nm.nm_ncand(scheme)

        def objective(idx):
            return nm.in_working_dtype(
                self._objective(mapper, priors, idx), self.dtype)

        def init(idx):
            nonlocal evals
            for t in self._tiles(idx):
                fvals[t], done[t] = nm.nm_init(objective(t), simplex[t],
                                               fatol, xatol)
                evals += t.numel() * (nvec + 1)

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
                for t in self._tiles(undone):
                    with trace.span('fit.nm.round', restart=restart,
                                    width=t.numel()) as sp:
                        stats = {}
                        s, f, d, it = nm.nm_chunk(
                            objective(t), simplex[t], fvals[t], done[t],
                            fatol, xatol, chunk, scheme, stats)
                        simplex[t], fvals[t], done[t] = s, f, d
                        sp.set(iters=it, **stats)
                    trace.count('fit.nm.live_iters', stats['live_iters'])
                    trace.count('fit.nm.tile_iters', t.numel() * it)
                    evals += t.numel() * it * ncand
                nit += chunk
        rows = torch.arange(b, device=self.device)
        ib = torch.argmin(fvals, dim=1)
        return dict(x=simplex[rows, ib].double().cpu().numpy(),
                    fun=fvals[rows, ib].double().cpu().numpy(),
                    converged=done.cpu().numpy(), obj_evals=evals)

    # -------------------------------------------------------------
    def _chisq_at(self, vel, params, vsinis, arms=None):
        """(B,) -2logL of one trial per fiber: vel (B,), params (B,
        ndim), vsinis (B,); differentiable in params and vsinis.
        ``arms`` default to every fiber's."""
        return chisq_trials_core(self.arms if arms is None else arms,
                                 self.templates, vel[:, None],
                                 params[:, None, :], vsinis[:, None],
                                 badchi=self.badchi,
                                 use_vsini=self.use_vsini,
                                 half_widths=self.half_widths)[:, 0]

    def run_polish(self, mapper, x, priors=None, steps=None, fun0=None):
        """Batched gradient polish, the ``second_minimizer`` stage.

        ``steps`` damped-Newton iterations (default
        ``RVST_POLISH_STEPS``, else 2) over the non-velocity coordinates
        [vsini?, free params] (the refinement re-measures the velocity
        right after): each solves (H + ridge) dx = -grad, ridge 1e-6
        max(|diag H|, 1e-12), with exact AD derivatives of -2logL plus
        priors and the vsini penalty; a non-finite dx is 0.  With
        ``RVST_POLISH_FREEZE_H=1`` the first step's Hessian serves every
        step (the gradient is recomputed).  The ladder [1, 0.25, 0.05]
        and the current point are evaluated in one objective call, and a
        fiber moves only when a trial is strictly better than its
        current value.

        x : (B, nvec) NM optima; fun0 : optional (B,) NM best values.
        Returns host x (B, nvec), fun (B,), moved (B,).
        """
        if steps is None:
            steps = int(os.environ.get('RVST_POLISH_STEPS', 2))
        freeze_h = os.environ.get('RVST_POLISH_FREEZE_H') == '1'
        if self.shards:
            return self._on_shards('run_polish', dict(x=x, fun0=fun0),
                                   mapper=mapper, priors=priors,
                                   steps=steps)
        x = np.asarray(x, np.float64)
        b = x.shape[0]
        fc = self._tensor(np.full(b, np.inf) if fun0 is None else fun0)
        xf, ff = self._run_mb(
            lambda arms, xt, ft: self._polish_tile(
                arms, mapper, priors, xt, ft, steps, freeze_h),
            self._tensor(x), fc)
        xf = xf.double().cpu().numpy()
        return dict(x=xf, fun=ff.double().cpu().numpy(),
                    moved=np.any(xf != x, axis=1))

    def _polish_tile(self, arms, mapper, priors, xc, fc, steps, freeze_h):
        """run_polish's steps on the fibers of ``arms``: xc (b, nvec),
        fc (b,) -> (x, fun) tensors."""
        b = xc.shape[0]
        objective = self._objective_arms(mapper, priors, arms)
        rows_p = prior_rows(mapper.specParams, priors)
        ladder = self._tensor([1.0, 0.25, 0.05])

        def scalar_obj(vel, rest):
            _, params, vsini, penalty = mapper.unpack(
                torch.cat([vel[:, None], rest], dim=1))
            chi = self._chisq_at(vel, params, vsini, arms=arms)
            for i, mu, sig in rows_p:
                chi = chi + ((params[:, i] - mu) / sig)**2
            return chi + penalty

        h = None
        for _ in range(steps):
            vel = xc[:, 0]
            f = lambda rest: scalar_obj(vel, rest)   # noqa: E731
            if h is None or not freeze_h:
                g, h = grad_hessian(f, xc[:, 1:])
            else:
                g = _gradient(f, xc[:, 1:])
            dh = torch.diagonal(h, dim1=-2, dim2=-1).abs()
            ridge = 1e-6 * torch.clamp(dh, min=1e-12)
            dx = -torch.linalg.solve_ex(h + torch.diag_embed(ridge),
                                        g[..., None])[0][..., 0]
            dx = torch.where(torch.isfinite(dx), dx, 0.0)
            cand = xc[:, None, :].repeat(1, 4, 1)           # (b, 4, nvec)
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
        return xc, fc

    # -------------------------------------------------------------
    def refine_velocities(self, best_vel, params, vsinis=None, maxiter=10):
        """Iterative velocity refinement: one full-range pass
        (min_vel..max_vel at vel_step0, to catch every CCF peak), then
        128-point window passes on the fibers whose step does not yet
        resolve their uncertainty, until all of a tile are done or
        ``maxiter`` passes ran.  Returns host (B,) best_vel, vel_err,
        best_chi, skewness, kurtosis, iterations (the passes of each
        fiber's tile)."""
        if self.shards:
            return self._on_shards('refine_velocities', dict(
                best_vel=best_vel, params=params, vsinis=vsinis),
                maxiter=maxiter)
        out = self._run_mb(
            lambda arms, v, p, w: self._refine_tile(arms, v, p, w,
                                                    maxiter),
            self._tensor(best_vel), self._tensor(params),
            self._vsinis(vsinis)).double().cpu().numpy()
        return dict(best_vel=out[:, 0], vel_err=out[:, 1],
                    best_chi=out[:, 2], skewness=out[:, 3],
                    kurtosis=out[:, 4], iterations=out[:, 5])

    def _refine_tile(self, arms, best_vel, params_t, vs_t, maxiter):
        """refine_velocities on the fibers of ``arms``: (b, 6) tensor of
        the scan statistics and the number of passes."""
        cfg = self.config
        crit_ratio, goal_width, nv_win = 5.0, 10.0, 128
        min_vel0, max_vel0 = float(cfg['min_vel']), float(cfg['max_vel'])
        min_vel_step = float(cfg['min_vel_step'])
        vel_step0 = float(cfg['vel_step0'])
        nv = int(math.ceil((max_vel0 - min_vel0) / vel_step0)) + 1
        b = best_vel.shape[0]
        best = torch.clamp(best_vel, min_vel0, max_vel0)
        full = lambda x: torch.full((b,), x, dtype=self.dtype,  # noqa: E731
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
            chi = self._scan(self._arms_at(idx, arms), grid, params_t[idx],
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
        return torch.cat([stats, full(float(it))[:, None]], dim=1)

    # -------------------------------------------------------------
    def best_models(self, best_vel, params, vsinis=None):
        """Best-fit models of every fiber and arm at the optimum
        (likelihood.models_core).

        Returns dict of per-arm {name: (B, npix)} models, raw_models,
        cont_models (continuum-only fit), and masked true chisq,
        cont_chisq, npix, red_chisq — computed from the arms this
        fitter was built with."""
        if self.shards:
            return self._on_shards('best_models', dict(
                best_vel=best_vel, params=params, vsinis=vsinis))
        mods = self._run_mb(
            lambda arms, v, p, w: models_core(
                arms, self.templates, v, p, w, use_vsini=self.use_vsini,
                half_widths=self.half_widths),
            self._tensor(best_vel), self._tensor(params),
            self._vsinis(vsinis))
        flat = [[x.double().cpu().numpy() for x in m] for m in mods]
        return self._models_finalize(flat, self.batch_arms)

    # -------------------------------------------------------------
    def hessians(self, best_vel, params, vsinis=None, priors=None,
                 parnames=None):
        """(B, ndim, ndim) exact AD Hessians of 0.5 (-2logL + priors)
        with respect to the parameters at velocities ``best_vel``
        (likelihood.hessian_core)."""
        if self.shards:
            return self._on_shards('hessians', dict(
                best_vel=best_vel, params=params, vsinis=vsinis),
                priors=priors, parnames=parnames)
        rows_p = prior_rows(parnames, priors)
        return self._run_mb(
            lambda arms, v, p, w: hessian_core(
                arms, self.templates, v, p, w, rows_p, badchi=self.badchi,
                use_vsini=self.use_vsini, half_widths=self.half_widths),
            self._tensor(best_vel), self._tensor(params),
            self._vsinis(vsinis))

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
        and models (each stage ends in a fetch to the host), the seconds
        of the spans ``fit.polish``, ``fit.refine``, ``fit.hessian`` and
        ``fit.models`` inside ``fit.tail`` (:mod:`rvspecfit_torch.trace`)."""
        with trace.span('fit.tail', fibres=self.nfibers):
            with trace.span('fit.polish') as sp_polish:
                x = np.asarray(x, np.float64)
                if polish:
                    pol = self.run_polish(mapper, x, priors=priors,
                                          fun0=fun)
                    x, fun = pol['x'], pol['fun']
                elif fun is not None:
                    fun = np.asarray(fun, np.float64)
            with trace.span('fit.refine') as sp_refine:
                vel, params, vsini = mapper.unpack_host(x)
                ref = self.refine_velocities(vel, params, vsinis=vsini)
            with trace.span('fit.hessian') as sp_hessian:
                errs, covars, bad = self.hessian_errors(
                    ref['best_vel'], params, vsinis=vsini, priors=priors,
                    parnames=parnames)
            with trace.span('fit.models') as sp_models:
                mods = self.best_models(ref['best_vel'], params,
                                        vsinis=vsini)
        return dict(x=x, fun=fun, params=params, vsini=vsini, ref=ref,
                    errs=errs, covars=covars, bad_hess=bad, mods=mods,
                    phases=dict(polish=sp_polish.seconds,
                                refine=sp_refine.seconds,
                                hessian=sp_hessian.seconds,
                                models=sp_models.seconds))

    def run_tail_async(self, mapper, x, fun=None, parnames=None,
                       priors=None, polish=True):
        """:meth:`run_tail` on a worker thread, on a CUDA stream of its
        own that starts after the calling thread's work so far
        (device.Background); returns ``collect()``, which joins it and
        returns run_tail's dict (its ``phases`` measured on the worker),
        or raises its error, on every call.

        The tail owns a snapshot of the fitter (:meth:`_snapshot`): the
        host arms' arrays and the device tensors as they are at the
        call, so that nothing done afterwards to this fitter, its
        arrays or its tensors reaches the tail (the reference's tail
        reads the arms at collect time, from a fitter that its driver
        has already given the next file's arms)."""
        snap = self._snapshot()
        x = np.array(x, np.float64)
        fun = None if fun is None else np.array(fun, np.float64)
        job = Background(lambda: snap.run_tail(
            mapper, x, fun=fun, parnames=parnames, priors=priors,
            polish=polish), self.device, name='rvst-tail')
        return job.result

    def _snapshot(self):
        """A copy of this fitter that shares no data with it: the host
        BatchArms' arrays copied, the device tensors cloned (on the
        calling thread's current stream, before any later write to
        them), and its shards snapshotted too (on the same shard
        threads, parallel/mesh.ShardPools, which live as long as any
        fitter that holds them)."""
        snap = copy.copy(self)
        snap.batch_arms = [_copy_batch_arm(a) for a in self.batch_arms]
        snap.arms = [map_tensors(a, torch.clone) for a in self.arms]
        snap.templates = dict(self.templates)
        snap.half_widths = dict(self.half_widths)
        if self.shards:
            snap.shards = [sh._snapshot() for sh in self.shards]
        return snap

    def _on_shards(self, name, per_fiber, **shared):
        """Method ``name`` of every shard fitter (parallel/mesh) on its
        own thread, each with its rows of the ``per_fiber`` arguments
        (host arrays or tensors with a leading fiber axis, or None) and
        the ``shared`` ones; the results concatenated in fiber order
        (:func:`_concat_shards`).  A shard's work goes on the calling
        thread's current stream of the shard's device."""
        futures = []
        for sh, pool in zip(self.shards, self.shard_pools):
            kw = {k: _rows(v, sh.fiber_lo, sh.fiber_lo + sh.nfibers,
                           sh.device) for k, v in per_fiber.items()}
            stream = torch.cuda.current_stream(sh.device) \
                if sh.device.type == 'cuda' else None
            futures.append(pool.submit(_on_stream, stream,
                                       getattr(sh, name), **kw, **shared))
        return _concat_shards([f.result() for f in futures], self.device)

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


def _gradient(f, x):
    """Per-fiber gradient (B, n) at x (B, n) of f: (B, n) -> (B,) whose
    fibers are independent (one backward of f.sum())."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        return torch.autograd.grad(f(x).sum(), x)[0]


def _copy_batch_arm(a):
    """A BatchArm with copies of ``a``'s host arrays."""
    return BatchArm(a.name, a.lam.copy(), a.flux.copy(), a.ivar.copy(),
                    badmask=a.badmask.copy(),
                    resolution=None if a.resolution is None
                    else np.array(a.resolution), setup=a.setup)


def _rows(x, lo, hi, device):
    """Rows [lo, hi) of a per-fiber argument: None stays None, a tensor
    moves to ``device``, anything else becomes a host array."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[lo:hi].to(device)
    return np.asarray(x)[lo:hi]


def _on_stream(stream, fn, *args, **kwargs):
    """fn(*args, **kwargs) with ``stream`` (None: none) as the current
    stream."""
    if stream is None:
        return fn(*args, **kwargs)
    with torch.cuda.stream(stream):
        return fn(*args, **kwargs)


def _concat_shards(parts, device):
    """The shards' results as one: tensors moved to ``device`` and
    concatenated along the fiber axis, host arrays concatenated, counts
    (ints) added, and dicts, lists and tuples of them element by
    element."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts], dim=0)
    if isinstance(first, np.ndarray):
        return np.concatenate(parts, axis=0)
    if isinstance(first, dict):
        return {k: _concat_shards([p[k] for p in parts], device)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat_shards(list(z), device)
                           for z in zip(*parts))
    if isinstance(first, (int, np.integer)):
        return sum(parts)
    return first


def _concat_tiles(parts):
    """Per-tile outputs (tensors, or lists, tuples and dicts of them)
    concatenated along the leading fiber axis."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=0)
    if isinstance(first, dict):
        return {k: _concat_tiles([p[k] for p in parts]) for k in first}
    return type(first)(_concat_tiles(list(z)) for z in zip(*parts))
