"""Velocity x parameter grid scans and their posterior moments.

Counterpart of rvspecfit_tpu/fit/find_best.py.  The reference tiles
every parameter vector over the velocity grid and runs each (velocity,
vector) pair as its own trial; here each vector's template stage runs
once and serves all its velocities (FusedChisq.scan: kernel A in
shared mode).  The function computed is the same.  :func:`scan_stats`
gives the minimum and moments of these scans and of the batched fit's
(fit/batch.py).
"""
from __future__ import annotations

import numpy as np
import torch


def quadratic_interp_min(vel_grid, chisq, i):
    """The grid minimum at index ``i`` refined by a parabola through 3
    points; the grid point where the parabola is not convex, at the
    grid's edge, or where its vertex leaves the bracket."""
    if i == 0 or i == len(vel_grid) - 1:
        return float(vel_grid[i])
    a2, a1, _ = np.polyfit(vel_grid[i - 1:i + 2], chisq[i - 1:i + 2], 2)
    if a2 <= 0:
        return float(vel_grid[i])
    val = -a1 / 2 / a2
    if not (vel_grid[i - 1] < val < vel_grid[i + 1]):
        return float(vel_grid[i])
    return float(val)


def scan_stats(vels, mask, chi, quadratic=True):
    """Minimum + posterior moments of (B, V) velocity scans.

    Returns ((B, 5) [best_vel, vel_err, best_chi, skewness, kurtosis],
    probs (B, V)); uniform grids per fiber, masked entries ignored;
    with ``quadratic`` the minimum is refined by a parabola, falling
    back to the grid point at an edge, where the parabola is not convex
    or where its vertex leaves the bracket (the rule of
    :func:`quadratic_interp_min`).
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
    good = interior & (denom > 0) & (offset.abs() < 1) & quadratic
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
    return torch.stack([best_vel, err, best_chi, skew, kurt], dim=1), probs


def find_best(fused, vel_grid, params_list, vsini=None, quadratic=True,
              chunk=16384):
    """Chi-square over (velocity grid) x (parameter vectors).

    fused : likelihood.FusedChisq; vel_grid : (V,); params_list :
    (P, ndim); vsini : scalar for every trial, or None; ``quadratic``
    refines the velocity minimum with a parabola; ``chunk`` bounds the
    trials (vectors x velocities) of one likelihood call.

    Returns dict of best_chi, best_vel, vel_err, best_param, kurtosis,
    skewness, probs (the best vector's velocity posterior) and
    chisq_grid (V, P).
    """
    vel_grid = np.asarray(vel_grid, dtype=np.float64)
    params_list = np.atleast_2d(np.asarray(params_list, dtype=np.float64))
    nv, npar = len(vel_grid), len(params_list)
    per_call = max(1, chunk // nv)
    rows = []
    for i in range(0, npar, per_call):
        p = params_list[i:i + per_call]
        rows.append(fused.scan(vel_grid, p, None if vsini is None
                               else np.full(len(p), float(vsini)))
                    .double().cpu().numpy())
    chisq = np.concatenate(rows).T                       # (V, P)
    i1, i2 = np.unravel_index(np.argmin(chisq), chisq.shape)
    st, probs = scan_stats(torch.from_numpy(vel_grid[None]),
                           torch.ones((1, nv), dtype=torch.bool),
                           torch.from_numpy(chisq[:, i2][None]), quadratic)
    best_vel, err, _, skew, kurt = st[0].tolist()
    return dict(best_chi=float(chisq[i1, i2]), best_vel=best_vel,
                vel_err=err, best_param=params_list[i2], kurtosis=kurt,
                skewness=skew, probs=probs[0].numpy(), chisq_grid=chisq)
