"""Regular-grid multilinear template interpolation.

Counterpart of rvspecfit_tpu/interp/grid.py: n-d multilinear
interpolation on a possibly gappy rectilinear grid (``idgrid`` of
spectrum ids, -1 marks a hole), with a nearest-template fallback
outside the grid or at holes, and the ptp-scaled nearest-template
distance as the smooth out-of-grid indicator.

The spectra are accumulated as one weighted gather over all 2^ndim
cube corners (the reference's one-hot MXU matmul is a TPU device);
all arithmetic stays in the state's dtype (float64, the working dtype
on both devices, see device.py; TF32 is off for a float32 state).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from rvspecfit_torch.device import dtype_for, resolve_device


@dataclasses.dataclass(frozen=True)
class GridInterpState:
    """Template grid tensors for interpolation."""

    uvecs: tuple              # per-dimension sorted grid values
    idgrid: torch.Tensor      # (prod(lens),) long, -1 = hole
    vecs_scaled: torch.Tensor  # (nspec, ndim) template params / ptp
    ptp_inv: torch.Tensor     # (ndim,)
    dats: torch.Tensor        # (nspec, npix) stored (log-)spectra
    lens: tuple
    log_spec: bool
    strides: torch.Tensor     # (ndim,) long, of the flattened idgrid
    corners: torch.Tensor     # (2^ndim, ndim) bool, unit-cube corners

    @property
    def ndim(self):
        return len(self.lens)

    @classmethod
    def build(cls, uvecs, idgrid, vecs, dats, log_spec=True, device=None,
              dtype=None):
        """From host arrays: per-dimension grid values, the (lens...)
        id grid, (ndim, nspec) mapped parameters and (nspec, npix)
        spectra (log if ``log_spec``)."""
        vecs = np.asarray(vecs, dtype=np.float64)
        ptp = np.ptp(vecs, axis=1)
        ptp = np.where(ptp == 0, 1.0, ptp)
        return cls.from_arrays(
            uvecs=uvecs, idgrid=idgrid, vecs_scaled=(vecs / ptp[:, None]).T,
            ptp_inv=1.0 / ptp, dats=dats, lens=[len(u) for u in uvecs],
            log_spec=log_spec, device=device, dtype=dtype)

    @classmethod
    def from_arrays(cls, *, uvecs, idgrid, vecs_scaled, ptp_inv, dats,
                    lens, log_spec, device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or dtype_for(device)
        to = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                       dtype=dtype, device=device)
        lens = tuple(int(x) for x in lens)
        strides = [int(np.prod(lens[i + 1:])) for i in range(len(lens))]
        return cls(tuple(to(u) for u in uvecs),
                   torch.as_tensor(np.asarray(idgrid).reshape(-1),
                                   dtype=torch.long, device=device),
                   to(vecs_scaled), to(ptp_inv), to(dats), lens,
                   bool(log_spec),
                   torch.tensor(strides, device=device),
                   torch.tensor(list(itertools.product(
                       (False, True), repeat=len(lens))), device=device))


def interp_batch(state: GridInterpState, params):
    """(T, ndim) mapped parameters -> ((T, npix) spectra, (T,) outside).

    ``outside`` is 0 inside the grid, else the ptp-scaled distance to
    the nearest template (whose spectrum is returned); a trial with
    non-finite parameters takes template 0, as the reference does.
    """
    nt = params.shape[0]
    params = params.to(state.dats.dtype)
    finite = torch.isfinite(params).all(1)
    p_safe = torch.where(finite[:, None], params, 0.0)

    pos, frac = [], []
    inb = torch.ones(nt, dtype=torch.bool, device=params.device)
    for i, u in enumerate(state.uvecs):
        pi = torch.searchsorted(u, p_safe[:, i].contiguous(),
                                right=True) - 1
        inb = inb & (pi >= 0) & (pi < state.lens[i] - 1)
        pic = torch.clamp(pi, 0, state.lens[i] - 2)
        pos.append(pic)
        frac.append((p_safe[:, i] - u[pic]) / (u[pic + 1] - u[pic]))
    pos = torch.stack(pos, dim=1)                            # (T, ndim)
    frac = torch.stack(frac, dim=1)

    # all 2^ndim cube corners at once: flat grid ids and weights (T, C)
    flat = ((pos[:, None, :] + state.corners) * state.strides).sum(-1)
    weights = torch.where(state.corners, frac[:, None, :],
                          1.0 - frac[:, None, :]).prod(-1)
    cid = state.idgrid[flat]
    all_known = inb & (cid >= 0).all(1)

    # nearest template in the ptp-scaled metric (fallback + distance),
    # from the differences: in float32 the expanded |q|^2 - 2 q.v +
    # |v|^2 (|q|^2 ~ 100) loses ~2e-4 of the distance to cancellation,
    # which the out-of-grid penalty (distance x badchi) turns into
    # chi-square errors of order 10
    diff = (p_safe * state.ptp_inv)[:, None, :] - state.vecs_scaled
    d2 = (diff * diff).sum(-1)
    nearest = torch.argmin(d2, dim=1)
    nn_dist = torch.sqrt(d2.min(1).values)
    fallback_id = torch.where(finite, nearest, 0)

    known = all_known[:, None]
    acc = torch.einsum('tc,tcp->tp', torch.where(known, weights, 0.0),
                       state.dats[torch.where(known, cid, 0)])
    spec = torch.where(all_known[:, None], acc, state.dats[fallback_id])
    if state.log_spec:
        spec = torch.exp(spec)
    outside = torch.where(all_known, 0.0, nn_dist)
    return spec, outside
