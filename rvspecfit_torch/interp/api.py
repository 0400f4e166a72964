"""Template model: grid interpolator + wavelength geometry.

Counterpart of rvspecfit_tpu/interp/api.py for regular-grid
libraries (the NN interpolator is not ported yet).
"""
from __future__ import annotations

import dataclasses

import torch

from rvspecfit_torch.interp import grid as grid_mod
from rvspecfit_torch.ops.spline import SplineGeometry


@dataclasses.dataclass(frozen=True)
class TemplateModel:
    """One spectral setup's template interpolator, on one device."""

    state: grid_mod.GridInterpState
    geom: SplineGeometry
    parnames: tuple
    log_ids: tuple               # parameter indices interpolated in log10

    @property
    def log_step(self):
        if not self.geom.log_step:
            raise ValueError('template grid is not log-uniform')
        return self.geom.step

    def map_params(self, params):
        """External -> interpolation space (log10 of ``log_ids``)."""
        cols = [torch.log10(torch.clamp(params[..., i], min=1e-30))
                if i in self.log_ids else params[..., i]
                for i in range(params.shape[-1])]
        return torch.stack(cols, dim=-1)

    def eval_batch(self, params):
        """(T, ndim) external params -> ((T, npix) spectra, (T,)
        outside-grid distance)."""
        return grid_mod.interp_batch(self.state, self.map_params(params))
