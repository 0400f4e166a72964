"""Delaunay (barycentric) template interpolation on the host.

The port's own copy of rvspecfit_tpu/interp/triangulation.py (the
reference's TriInterp).  Locating a point's simplex has no place on
the card: a triangulation library is fitted through the regular grid
that pipeline/library.py rasterizes from it, and this interpolator
serves to check that grid against the library's own interpolant.
"""
from __future__ import annotations

import numpy as np
import scipy.spatial


class TriInterp:
    """Barycentric linear interpolation inside Delaunay simplices."""

    def __init__(self, triang, dats, exp=True):
        self.triang = triang
        self.dats = dats
        self.exp = exp
        self.ndim = triang.ndim

    @classmethod
    def from_points(cls, points, dats, exp=True):
        return cls(scipy.spatial.Delaunay(np.asarray(points)), dats,
                   exp=exp)

    def __call__(self, p):
        """The interpolated spectrum at the (ndim,) point ``p`` (exp of
        the stored values with ``exp``), NaN outside the hull."""
        p = np.asarray(p, dtype=np.float64)
        xid = int(self.triang.find_simplex(p))
        if xid == -1:
            return np.nan
        ndim = self.ndim
        b = np.empty(ndim + 1)
        b[:ndim] = self.triang.transform[xid, :ndim, :].dot(
            p - self.triang.transform[xid, ndim, :])
        b[ndim] = 1 - b[:ndim].sum()
        spec = (self.dats[self.triang.simplices[xid]] * b[:, None]).sum(
            axis=0)
        if self.exp:
            spec = np.exp(spec)
        if spec.size == 1:
            return float(spec[0])
        return spec

    def batch(self, ps):
        return np.array([self(p) for p in np.atleast_2d(ps)])
