"""The fused, batched spectral likelihood.

Counterpart of rvspecfit_tpu/fit/likelihood.py (template_stage,
chisq_trials_core, scan_core), written with the fiber axis explicit
instead of vmapped:

    parameters -> grid interpolation -> vsini broadening -> spline
    coefficients -> Doppler evaluation (kernel A) -> resolution ->
    continuum-marginalized chi-square -> out-of-grid penalties

Semantics kept from the reference (and its reference, cited there):
the outside-grid penalty ``outside * badchi``; templates that are
non-finite or > 1e100 outside the grid get 1000 * badchi; a non-finite
chi-square of a finite template outside the grid contributes the
penalty only; inside the grid it is +inf.
"""
from __future__ import annotations

import numpy as np
import torch

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


def template_stage(tm, params, vsinis, use_vsini, half_width):
    """Interpolate + broaden + spline-construct templates for T trials.

    params (T, ndim), vsinis (T,) -> (coeffs (T, 4, n-1), outside (T,),
    crap (T,), finite (T,)).
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
    coeffs = spline_mod.spline_coeffs(tm.geom, spec_safe)
    return coeffs, outside, crap, finite_t


def template_stages(templates, params, vsinis, use_vsini, half_widths):
    """template_stage per setup, computed once per distinct
    TemplateModel (several arms often share one template library)."""
    cache, out = {}, {}
    for s, tm in templates.items():
        key = (id(tm), half_widths.get(s))
        if key not in cache:
            cache[key] = template_stage(tm, params, vsinis, use_vsini,
                                        half_widths.get(s))
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
                      use_vsini, half_widths, outside_penalty=True):
    """-2logL of K trial points for each of B fibers.

    arms : list of ArmState with fiber axis B; templates : setup ->
    TemplateModel; vels, vsinis : (B, K); params : (B, K, ndim).
    Returns (B, K).  Every trial has its own template (kernel A,
    per-row mode).
    """
    b, k = vels.shape
    stage = template_stages(templates, params.reshape(b * k, -1),
                            vsinis.reshape(-1), use_vsini, half_widths)
    total = torch.zeros_like(vels)
    for arm in arms:
        coeffs, outside, crap, finite_t = stage[arm.setup]
        geom = templates[arm.setup].geom
        val = spline_eval_index(geom, coeffs,
                                doppler_u(arm, geom, vels.reshape(-1)))
        total = total + _arm_contribution(
            arm, val.view(b, k, -1), outside.view(b, k),
            crap.view(b, k), finite_t.view(b, k), badchi, outside_penalty)
    return total


def scan_core(arms, templates, vels, params, vsinis, *, badchi, use_vsini,
              half_widths, outside_penalty=True):
    """-2logL over V velocities at one parameter point per fiber.

    vels : (B, V); params : (B, ndim); vsinis : (B,) -> (B, V).  The
    template stage runs once per fiber and its coefficient row serves
    all V velocities (kernel A, shared mode).
    """
    b, v = vels.shape
    stage = template_stages(templates, params, vsinis, use_vsini,
                            half_widths)
    total = torch.zeros_like(vels)
    for arm in arms:
        coeffs, outside, crap, finite_t = stage[arm.setup]
        geom = templates[arm.setup].geom
        val = spline_eval_index(geom, coeffs,
                                doppler_u(arm, geom, vels.reshape(-1)),
                                rows_per_coeff=v)
        total = total + _arm_contribution(
            arm, val.view(b, v, -1), outside[:, None], crap[:, None],
            finite_t[:, None], badchi, outside_penalty)
    return total
