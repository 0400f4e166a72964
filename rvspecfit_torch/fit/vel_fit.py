"""Optimization-vector mapping and Hessian errors of the
maximum-likelihood fit.

Counterpart of ParamMapper, VSiniMapper and _uncertainties_from_hessian
in rvspecfit_tpu/fit/vel_fit.py (the single-object fit ``process`` is
not ported yet).
"""
from __future__ import annotations

import itertools
import logging

import numpy as np
import scipy.linalg
import torch

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
