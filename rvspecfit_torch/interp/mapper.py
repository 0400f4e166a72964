"""Parameter-space mappers (external stellar parameters -> interpolation
space).

The port's own copy of rvspecfit_tpu/interp/mapper.py: selected
parameter dimensions (by default teff, index 0) are log10-transformed
before interpolation.  Works on numpy arrays (host, float64) and on
torch tensors (on their device and dtype), last axis the parameter
index.
"""
from __future__ import annotations

import numpy as np
import torch


class LogMapper:
    """log10-transform selected parameter indices."""

    def __init__(self, log_ids=(0,)):
        self.log_ids = tuple(int(i) for i in (log_ids or ()))

    def _apply(self, vec, fn_np, fn_torch):
        if isinstance(vec, torch.Tensor):
            cols = [fn_torch(vec[..., i]) if i in self.log_ids
                    else vec[..., i] for i in range(vec.shape[-1])]
            return torch.stack(cols, dim=-1)
        out = np.array(vec, dtype=np.float64)
        for i in self.log_ids:
            out[..., i] = fn_np(out[..., i])
        return out

    def forward(self, vec):
        """External params -> interpolation space."""
        return self._apply(vec, np.log10, torch.log10)

    def inverse(self, vec):
        """Interpolation space -> external params."""
        return self._apply(vec, lambda x: 10.0**x, lambda x: 10.0**x)

    def spec(self):
        """Serializable description."""
        return dict(mapper_class='LogMapper', log_ids=list(self.log_ids))


def mapper_from_spec(spec):
    """The mapper a :meth:`LogMapper.spec` dict (or None: no mapping)
    describes."""
    if spec is None:
        return LogMapper(())
    name = spec.get('mapper_class')
    if name == 'LogMapper':
        return LogMapper(tuple(spec.get('log_ids') or ()))
    raise ValueError(f'Unknown mapper {name!r}')
