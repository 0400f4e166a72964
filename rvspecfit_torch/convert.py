"""Carry the reference's state over into the port's objects.

Each function takes a reference object (duck-typed: its array fields
are read with ``np.asarray``, so this module imports neither jax nor
the JAX package) and returns the port's counterpart on ``device`` in
its working dtype (device.dtype_for); ``device=None`` is the card
(device.resolve_device).
"""
from __future__ import annotations

import numpy as np
import torch

from rvspecfit_torch.device import (complex_dtype_for, dtype_for,
                                    resolve_device)
from rvspecfit_torch.fit.spec_data import ArmState, SpecData
from rvspecfit_torch.interp.api import TemplateModel
from rvspecfit_torch.interp.grid import GridInterpState
from rvspecfit_torch.ops.chisq import basis_products
from rvspecfit_torch.ops.resolution import BandedMatrix
from rvspecfit_torch.ops.spline import ARRAY_FIELDS, SplineGeometry


def _np(x):
    return None if x is None else np.array(x)


def geometry(ref, device=None):
    """rvspecfit_tpu SplineGeometry -> SplineGeometry."""
    return SplineGeometry.from_arrays(
        x0=ref.x0, x_last=ref.x_last, step=ref.step, n=ref.n,
        log_step=ref.log_step, device=device,
        **{k: _np(getattr(ref, k)) for k in ARRAY_FIELDS})


def grid_state(ref, device=None):
    """rvspecfit_tpu GridInterpState -> GridInterpState."""
    return GridInterpState.from_arrays(
        uvecs=[_np(u) for u in ref.uvecs], idgrid=_np(ref.idgrid),
        vecs_scaled=_np(ref.vecs_scaled), ptp_inv=_np(ref.ptp_inv),
        dats=_np(ref.dats), lens=ref.lens, log_spec=ref.log_spec,
        device=device)


def template_model(ref, device=None):
    """rvspecfit_tpu TemplateModel (kind 'grid') -> TemplateModel."""
    device = resolve_device(device)
    if ref.kind != 'grid':
        raise ValueError(f'only grid template models are ported, got '
                         f'{ref.kind!r}')
    return TemplateModel(state=grid_state(ref.state, device),
                         geom=geometry(ref.geom, device),
                         parnames=tuple(ref.parnames),
                         log_ids=tuple(ref.log_ids))


def ccf_bank(tfft, t2fft, info, device=None):
    """Host (T, F) complex bank rFFTs + info -> device bank tuple."""
    device = resolve_device(device)
    to = lambda c: torch.as_tensor(np.asarray(c),
                                   dtype=complex_dtype_for(device),
                                   device=device)
    return to(tfft), to(t2fft), info


def banded_matrix(ref):
    """rvspecfit_tpu BandedMatrix -> BandedMatrix with float64 numpy
    bands (host, as the port's builders return them)."""
    return BandedMatrix(tuple(int(o) for o in ref.offsets),
                        np.array(ref.bands, np.float64))


def spec_data(ref):
    """rvspecfit_tpu SpecData -> SpecData (host arrays)."""
    return SpecData(ref.name, np.array(ref.lam), np.array(ref.spec),
                    np.array(ref.espec), badmask=np.array(ref.badmask),
                    resolution=None if ref.resolution is None
                    else banded_matrix(ref.resolution))


def host(tree):
    """A reference result (dicts, lists and tuples of device arrays and
    scalars) with every array as numpy."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host(v) for v in tree)
    if hasattr(tree, 'shape') and hasattr(tree, 'dtype'):
        return np.asarray(tree)
    return tree


def arm_state(ref, device=None):
    """Single-object rvspecfit_tpu ArmState -> ArmState with a fiber
    axis of length 1."""
    device = resolve_device(device)
    dtype = dtype_for(device)
    to = lambda a: None if a is None else torch.as_tensor(
        np.array(a, np.float64), dtype=dtype, device=device)
    polys = to(ref.polys)
    band = None
    if ref.band is not None:
        band = BandedMatrix(tuple(ref.band.offsets),
                            to(ref.band.bands)[None])
    return ArmState(name=ref.name, setup=ref.setup, lam=to(ref.lam),
                    dvec=to(ref.dvec)[None], espec_inv=to(ref.espec_inv)[None],
                    polys=polys, polys_prod=basis_products(polys),
                    log_espec_sum=to(ref.log_espec_sum).reshape(1),
                    idx0=to(ref.idx0), lam_over_step=to(ref.lam_over_step),
                    band=band)
