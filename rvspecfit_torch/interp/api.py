"""Template model: interpolator + wavelength geometry.

Counterpart of rvspecfit_tpu/interp/api.py for regular-grid libraries
(multilinear, interp/grid.py) and NN libraries (interp/nn.py); the
reference's triangulation libraries are not ported yet (ROADMAP A5).
"""
from __future__ import annotations

import dataclasses

import torch

from rvspecfit_torch.interp import grid as grid_mod
from rvspecfit_torch.ops.clip import clip
from rvspecfit_torch.ops.spline import SplineGeometry


@dataclasses.dataclass(frozen=True)
class TemplateModel:
    """One spectral setup's template interpolator, on one device."""

    state: object                # GridInterpState | nn.NNInterpolator
    geom: SplineGeometry
    parnames: tuple
    log_ids: tuple               # parameter indices interpolated in log10
    kind: str = 'grid'           # 'grid' | 'nn'
    # provenance (revision, creation_soft_version) for output headers
    extra: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def log_step(self):
        if not self.geom.log_step:
            raise ValueError('template grid is not log-uniform')
        return self.geom.step

    def map_params(self, params):
        """External -> interpolation space (log10 of ``log_ids``)."""
        cols = [torch.log10(clip(params[..., i], 1e-30))
                if i in self.log_ids else params[..., i]
                for i in range(params.shape[-1])]
        return torch.stack(cols, dim=-1)

    def eval_batch(self, params):
        """(T, ndim) external params -> ((T, npix) spectra, (T,)
        outside-grid distance: 0 inside, a smooth positive distance
        outside)."""
        mapped = self.map_params(params)
        if self.kind == 'grid':
            return grid_mod.interp_batch(self.state, mapped)
        if self.kind == 'nn':
            return self.state.interp_batch(mapped)
        raise ValueError(f'unknown interpolator kind {self.kind!r}')
