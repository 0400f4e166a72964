"""The fused, batched spectral likelihood.

Counterpart of rvspecfit_tpu/fit/likelihood.py (template_stage,
chisq_trials_core, scan_core, FusedChisq, get_chisq_continuum), with
the AD Hessian (:func:`hessian_core`) and the best-fit models
(:func:`models_core`) that the single-object and batched fits share,
written with the fiber axis explicit instead of vmapped:

    parameters -> grid interpolation -> vsini broadening -> spline
    coefficients -> Doppler evaluation (kernel A) -> resolution ->
    continuum-marginalized chi-square -> out-of-grid penalties

Semantics kept from the reference (and its reference, cited there):
the outside-grid penalty ``outside * badchi``; templates that are
non-finite or > 1e100 outside the grid get 1000 * badchi; a non-finite
chi-square of a finite template outside the grid contributes the
penalty only; inside the grid it is +inf.

:class:`FusedChisq` is the single-object likelihood: its arms carry a
fiber axis of length 1, which broadcasts against any trial batch, so
T trials go through :func:`chisq_trials_core` as one fiber with K = T
(kernel A per-row) and P parameter vectors at V velocities through
:func:`scan_core` as P fibers (kernel A shared, one template stage
per vector).

``fast_interp`` (an option of :class:`FusedChisq` and a keyword of the
cores) evaluates each template at its nearest pixel, one gather of its
knot values (ops/spline.nearest_eval_index), in place of the cubic
spline: the spline construction is skipped and kernel A is not called
(the reference has no Pallas kernel for it either).
"""
from __future__ import annotations

import numpy as np
import torch

from rvspecfit_torch.fit.spec_data import ArmState, SpecData
from rvspecfit_torch.ops import basis as basis_mod
from rvspecfit_torch.ops import chisq as chisq_mod
from rvspecfit_torch.ops import spline as spline_mod
from rvspecfit_torch.ops import vsini as vsini_mod
from rvspecfit_torch.ops.resolution import BandedMatrix
from rvspecfit_torch.ops.spline_eval import spline_eval_index

SPEED_OF_LIGHT = 299792.458  # km/s
MAX_TEMPLATE_VALUE = 1e100


def overlap_check(tm, arm_lam, min_vel, max_vel):
    """The template grid must cover the arm at every velocity
    considered."""
    t0, t1 = tm.geom.x0, tm.geom.x_last
    a0, a1 = float(arm_lam[0]), float(arm_lam[-1])
    for vel in (min_vel, max_vel):
        corr = np.sqrt((1 + vel / SPEED_OF_LIGHT)
                       / (1 - vel / SPEED_OF_LIGHT))
        if t0 * corr > a0 or t1 * corr < a1:
            raise RuntimeError(
                f'Template wavelengths ({t0},{t1}) do not cover the '
                f'data ({a0},{a1}) at velocities {min_vel}..{max_vel}')


def doppler_u(arm, geom, vels):
    """(R,) velocities -> (R, npix) fractional template indices."""
    shift = spline_mod.doppler_index_shift(geom, vels)[:, None]
    if geom.log_step:
        return arm.idx0 + shift
    return arm.idx0 + shift * arm.lam_over_step


def doppler_eval(arm, geom, coeffs, vels, rows_per_coeff=1,
                 fast_interp=False):
    """The templates at the arm's pixels Doppler-shifted by ``vels``
    (R,): kernel A on spline coefficients (R / rows_per_coeff, 4, n-1),
    or with ``fast_interp`` the nearest knot of raw values
    (R / rows_per_coeff, n).  Returns (R, npix)."""
    u = doppler_u(arm, geom, vels)
    if not fast_interp:
        return spline_eval_index(geom, coeffs, u,
                                 rows_per_coeff=rows_per_coeff)
    p = coeffs.shape[0]
    val = spline_mod.nearest_eval_index(geom, coeffs, u.reshape(p, -1))[0]
    return val.reshape(u.shape)


def template_stage(tm, params, vsinis, use_vsini, half_width,
                   fast_interp=False):
    """Interpolate + broaden + spline-construct templates for T trials.

    params (T, ndim), vsinis (T,) -> (coeffs (T, 4, n-1), outside (T,),
    crap (T,), finite (T,)); with ``fast_interp`` the spline
    construction is skipped and the first item is the broadened knot
    values (T, n).
    """
    spec_t, outside = tm.eval_batch(params)
    isfin = torch.isfinite(spec_t)
    finite_t = isfin.all(-1)
    maxabs = torch.where(isfin, spec_t, 0.0).abs().amax(-1)
    # garbage-template threshold, clamped into the dtype's range
    max_val = min(MAX_TEMPLATE_VALUE,
                  float(torch.finfo(spec_t.dtype).max) / 4)
    crap = (outside > 0) & (~finite_t | (maxabs > max_val))
    spec_safe = torch.where(finite_t[:, None], spec_t, 1.0)
    if use_vsini:
        kern = vsini_mod.rotation_kernel(vsinis.to(spec_safe.dtype),
                                         tm.log_step, half_width)
        spec_safe = vsini_mod.convolve_kernel_same(spec_safe, kern)
    if fast_interp:
        return spec_safe, outside, crap, finite_t
    coeffs = spline_mod.spline_coeffs(tm.geom, spec_safe)
    return coeffs, outside, crap, finite_t


def template_stages(templates, params, vsinis, use_vsini, half_widths,
                    fast_interp=False):
    """template_stage per setup, computed once per distinct
    TemplateModel (several arms often share one template library)."""
    cache, out = {}, {}
    for s, tm in templates.items():
        key = (id(tm), half_widths.get(s))
        if key not in cache:
            cache[key] = template_stage(tm, params, vsinis, use_vsini,
                                        half_widths.get(s), fast_interp)
        out[s] = cache[key]
    return out


def _arm_contribution(arm, val, outside, crap, finite_t, badchi,
                      outside_penalty):
    """-2logL contribution of one arm: val (B, K, npix) template
    evaluations; outside/crap/finite broadcast against (B, K)."""
    if arm.band is not None:
        val = BandedMatrix(arm.band.offsets,
                           arm.band.bands[:, None]).matvec(val)
    chi = chisq_mod.chisq_continuum_marg_batch(
        arm.dvec[:, None, :], val * arm.espec_inv[:, None, :], arm.polys,
        arm.polys_prod, arm.log_espec_sum[:, None])
    penalty = outside * badchi if outside_penalty else 0.0
    salvage = torch.where((outside > 0) & finite_t, penalty, torch.inf)
    return torch.where(crap, 1000.0 * badchi,
                       torch.where(torch.isfinite(chi), chi + penalty,
                                   salvage))


def chisq_trials_core(arms, templates, vels, params, vsinis, *, badchi,
                      use_vsini, half_widths, outside_penalty=True,
                      fast_interp=False):
    """-2logL of K trial points for each of B fibers.

    arms : list of ArmState with fiber axis B; templates : setup ->
    TemplateModel; vels, vsinis : (B, K); params : (B, K, ndim).
    Returns (B, K).  Every trial has its own template (kernel A,
    per-row mode; or the nearest-pixel gather with ``fast_interp``).
    """
    b, k = vels.shape
    stage = template_stages(templates, params.reshape(b * k, -1),
                            vsinis.reshape(-1), use_vsini, half_widths,
                            fast_interp)
    total = torch.zeros_like(vels)
    for arm in arms:
        coeffs, outside, crap, finite_t = stage[arm.setup]
        geom = templates[arm.setup].geom
        val = doppler_eval(arm, geom, coeffs, vels.reshape(-1),
                           fast_interp=fast_interp)
        total = total + _arm_contribution(
            arm, val.view(b, k, -1), outside.view(b, k),
            crap.view(b, k), finite_t.view(b, k), badchi, outside_penalty)
    return total


def scan_core(arms, templates, vels, params, vsinis, *, badchi, use_vsini,
              half_widths, outside_penalty=True, fast_interp=False):
    """-2logL over V velocities at one parameter point per fiber.

    vels : (B, V); params : (B, ndim); vsinis : (B,) -> (B, V).  The
    template stage runs once per fiber and its coefficient row serves
    all V velocities (kernel A, shared mode; or the nearest-pixel
    gather with ``fast_interp``).
    """
    b, v = vels.shape
    stage = template_stages(templates, params, vsinis, use_vsini,
                            half_widths, fast_interp)
    total = torch.zeros_like(vels)
    for arm in arms:
        coeffs, outside, crap, finite_t = stage[arm.setup]
        geom = templates[arm.setup].geom
        val = doppler_eval(arm, geom, coeffs, vels.reshape(-1),
                           rows_per_coeff=v, fast_interp=fast_interp)
        total = total + _arm_contribution(
            arm, val.view(b, v, -1), outside[:, None], crap[:, None],
            finite_t[:, None], badchi, outside_penalty)
    return total


def grad_hessian(f, x):
    """Per-fiber gradient (B, n) and Hessian (B, n, n) at x (B, n) of
    f: (B, n) -> (B,) whose fibers are independent: one backward of
    f.sum() with the graph kept, then one backward of each gradient
    column summed over fibers (Hessian row j)."""
    n = x.shape[1]
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        g, = torch.autograd.grad(f(x).sum(), x, create_graph=True)
        rows = [torch.autograd.grad(g[:, j].sum(), x,
                                    retain_graph=j < n - 1)[0]
                for j in range(n)]
    return g.detach(), torch.stack(rows, dim=1)


def hessian_core(arms, templates, vels, params, vsinis, prior_rows,
                 **core):
    """(B, ndim, ndim) AD Hessians of 0.5 (-2logL + priors) in the
    parameters at one point per fiber: vels, vsinis (B,), params
    (B, ndim); prior_rows [(index, mean, sigma)]; ``core`` the keyword
    arguments of :func:`chisq_trials_core`."""
    def half_chisq(p):
        chi = chisq_trials_core(arms, templates, vels[:, None],
                                p[:, None, :], vsinis[:, None], **core)[:, 0]
        for i, mu, sig in prior_rows:
            chi = chi + ((p[:, i] - mu) / sig)**2
        return 0.5 * chi

    return grad_hessian(half_chisq, params)[1]


def models_core(arms, templates, vels, params, vsinis, *, use_vsini,
                half_widths, fast_interp=False):
    """Best-fit models at one point per fiber: vels, vsinis (B,), params
    (B, ndim).  Per arm (model, raw model, continuum-only model), each a
    (B, npix) tensor: raw is the template after the resolution matrix,
    model it times its continuum fit, and the continuum-only model the
    fit of the continuum basis times a flat template."""
    stage = template_stages(templates, params, vsinis, use_vsini,
                            half_widths, fast_interp)
    out = []
    for arm in arms:
        geom = templates[arm.setup].geom
        val = doppler_eval(arm, geom, stage[arm.setup][0], vels,
                           fast_interp=fast_interp)
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
        out.append((models[0], val, models[1]))
    return out


class FusedChisq:
    """The likelihood of one object's datasets.

    specdata : list of SpecData (name = template setup); templates :
    setup -> TemplateModel, all on one device, whose dtype the arms
    take; config : min_vel, max_vel (and max_vsini with ``use_vsini``);
    options : npoly (default 5), rbf_continuum (default True);
    resol_mats : optional {name: BandedMatrix} per-call resolution,
    exclusive with a SpecData's own; espec_systematic : optional float
    or {name: float} added to the errors in quadrature; use_vsini :
    whether trials carry a vsini to broaden with; outside_penalty :
    include the outside-grid penalty.  The option ``fast_interp``
    evaluates each template at its nearest pixel (no spline, no kernel
    A) in every call: trials, scans, Hessians and models.
    """

    def __init__(self, specdata, templates, config, options=None,
                 resol_mats=None, espec_systematic=None, use_vsini=False,
                 outside_penalty=True):
        if isinstance(specdata, SpecData):
            specdata = [specdata]
        options = options or {}
        self.fast_interp = bool(options.get('fast_interp', False))
        self.npoly = options.get('npoly') or 5
        self.rbf = options.get('rbf_continuum', True)
        self.config = config
        self.use_vsini = bool(use_vsini)
        self.outside_penalty = bool(outside_penalty)
        self.specdata = list(specdata)
        self.templates = {}
        for sd in self.specdata:
            if sd.name not in templates:
                raise KeyError(f'no template model for setup {sd.name!r}')
            self.templates[sd.name] = templates[sd.name]
        geom0 = next(iter(self.templates.values())).geom
        self.device, self.dtype = geom0.h.device, geom0.h.dtype
        self.arms = []
        for sd in self.specdata:
            sysval = espec_systematic
            if isinstance(espec_systematic, dict):
                sysval = espec_systematic[sd.name]
            rm = None if resol_mats is None else resol_mats.get(sd.name)
            self.arms.append(ArmState.build(
                sd, templates[sd.name].geom, npoly=self.npoly, rbf=self.rbf,
                espec_systematic=sysval, resol_matrix=rm,
                device=self.device, dtype=self.dtype))
            overlap_check(self.templates[sd.name], sd.lam,
                          config['min_vel'], config['max_vel'])
        self.badchi = float(10 * sum(a.npix for a in self.arms))
        self.half_widths = {}
        if self.use_vsini:
            for s, tm in self.templates.items():
                self.half_widths[s] = vsini_mod.kernel_half_width(
                    float(config['max_vsini']), tm.log_step)

    def tensor(self, x):
        """``x`` on the likelihood's device in its dtype (a tensor is
        cast, keeping its graph)."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.array(x, np.float64), dtype=self.dtype,
                               device=self.device)

    def _core_args(self):
        return dict(badchi=self.badchi, use_vsini=self.use_vsini,
                    half_widths=self.half_widths,
                    outside_penalty=self.outside_penalty,
                    fast_interp=self.fast_interp)

    def _chisq_trials(self, vels, params, vsinis):
        """Tensors vels (T,), params (T, ndim), vsinis (T,) -> (T,)
        -2logL, differentiable in all three."""
        return chisq_trials_core(self.arms, self.templates, vels[None],
                                 params[None], vsinis[None],
                                 **self._core_args())[0]

    def chisq_trials(self, vels, params, vsinis=None, chunk=None):
        """-2logL (T,) tensor at T trial points: vels (T,), params
        (T, ndim), vsinis (T,) or None.  ``chunk`` bounds the trials of
        one call; the last chunk is padded to the same size."""
        vels = self.tensor(vels).reshape(-1)
        params = self.tensor(params).reshape(vels.shape[0], -1)
        vsinis = torch.zeros_like(vels) if vsinis is None \
            else self.tensor(vsinis).reshape(-1)
        t = vels.shape[0]
        if chunk is None or t <= chunk:
            return self._chisq_trials(vels, params, vsinis)
        outs = []
        for i in range(0, t, chunk):
            n = min(chunk, t - i)
            sl = slice(i, i + n)
            v, p, w = vels[sl], params[sl], vsinis[sl]
            if n < chunk:
                pad = chunk - n
                v = torch.cat([v, v.new_zeros(pad)])
                p = torch.cat([p, p[-1:].expand(pad, -1)])
                w = torch.cat([w, w.new_zeros(pad)])
            outs.append(self._chisq_trials(v, p, w)[:n])
        return torch.cat(outs)

    def chisq_one(self, vel, params, vsini=None):
        """-2logL at one point, as a float."""
        return float(self.chisq_trials(
            [vel], np.asarray(params, np.float64)[None],
            None if vsini is None else [vsini])[0])

    def scan(self, vel_grid, params, vsinis=None):
        """-2logL (P, V) tensor of P parameter vectors (P, ndim) at the
        velocities vel_grid (V,), vsinis (P,) or None: one template stage
        per vector, shared by its V velocities."""
        params = self.tensor(np.atleast_2d(np.asarray(params, np.float64)))
        p = params.shape[0]
        vels = self.tensor(vel_grid).reshape(1, -1).expand(p, -1)
        vsinis = params.new_zeros(p) if vsinis is None \
            else self.tensor(vsinis).reshape(p)
        return scan_core(self.arms, self.templates, vels.contiguous(),
                         params, vsinis, **self._core_args())

    def hessian(self, vel, params, vsini=None, prior_rows=()):
        """(ndim, ndim) AD Hessian of 0.5 (-2logL + priors) in the
        parameters at one point (:func:`hessian_core`)."""
        return hessian_core(
            self.arms, self.templates, self.tensor([vel]),
            self.tensor(np.asarray(params, np.float64)[None]),
            self.tensor([0.0 if vsini is None else vsini]), prior_rows,
            **self._core_args())[0]

    def full_output(self, vel, params, vsini=None):
        """Chi-square, best-fit models and per-arm true chi-squares at
        one point: dict of chisq, logl, models and raw_models (lists of
        (npix,) host arrays per dataset), chisq_array, red_chisq_array
        and npix_array (masked, against the SpecData's own errors)."""
        params = np.asarray(params, np.float64)
        mods = models_core(
            self.arms, self.templates, self.tensor([vel]),
            self.tensor(params[None]),
            self.tensor([0.0 if vsini is None else vsini]),
            use_vsini=self.use_vsini, half_widths=self.half_widths,
            fast_interp=self.fast_interp)
        chisq = self.chisq_one(vel, params, vsini)
        host = lambda t: t[0].detach().double().cpu().numpy()
        ret = dict(chisq=chisq, logl=-0.5 * chisq,
                   models=[host(m) for m, _, _ in mods],
                   raw_models=[host(r) for _, r, _ in mods],
                   chisq_array=[], red_chisq_array=[], npix_array=[])
        for sd, model in zip(self.specdata, ret['models']):
            dev = (model - sd.spec) / sd.espec
            mask = ~sd.badmask
            true_chi = float((dev[mask]**2).sum())
            npixg = int(mask.sum())
            ret['chisq_array'].append(true_chi)
            ret['npix_array'].append(npixg)
            ret['red_chisq_array'].append(true_chi / max(npixg, 1))
        return ret


def get_chisq_continuum(specdata, options=None):
    """Continuum-only fit quality per dataset: each spectrum fitted by
    the continuum basis times a flat template (resolution-convolved
    where the dataset has one), in float64 on the host.  Returns dict
    of chisq_array and redchisq_array (numpy)."""
    options = options or {}
    npoly = options.get('npoly') or 5
    rbf = options.get('rbf_continuum', True)
    chisq_array = np.zeros(len(specdata))
    redchisq_array = np.zeros(len(specdata))
    to = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    for i, sd in enumerate(specdata):
        polys = to(basis_mod.continuum_basis(sd.lam, npoly, rbf=rbf))
        templ = torch.ones(len(sd.spec), dtype=torch.float64)
        if sd.resolution is not None:
            templ = BandedMatrix(sd.resolution.offsets, to(
                sd.resolution.host_bands())).matvec(templ)
        _, coef = chisq_mod.chisq_continuum_marg(
            to(sd.spec / sd.espec), templ / to(sd.espec), polys,
            to(np.log(sd.espec).sum()), with_coeffs=True)
        model = (coef @ (polys * templ[None, :])).numpy()
        dev = (model - sd.spec) / sd.espec
        mask = ~sd.badmask
        chisq_array[i] = (dev[mask]**2).sum()
        redchisq_array[i] = chisq_array[i] / max(mask.sum(), 1)
    return dict(chisq_array=chisq_array, redchisq_array=redchisq_array)
