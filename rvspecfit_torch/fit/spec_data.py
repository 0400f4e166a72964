"""Spectroscopic data containers.

Counterpart of rvspecfit_tpu/fit/spec_data.py.  ``SpecData`` is one
observed spectrum of one arm (host arrays); ``ArmState`` holds the
tensors the fused likelihood reads for one arm, stacked over a leading
fiber axis (length 1 for a single object).  The device of these
tensors decides whether the likelihood runs the CUDA kernels or their
plain versions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rvspecfit_torch.device import dtype_for, resolve_device
from rvspecfit_torch.ops import basis as basis_mod
from rvspecfit_torch.ops.chisq import basis_products
from rvspecfit_torch.ops.resolution import BandedMatrix
from rvspecfit_torch.ops.spline import fractional_index


class SpecData:
    """One observed spectrum: name, wavelengths, flux, errors, mask,
    optional resolution (BandedMatrix with (noff, npix) bands)."""

    def __init__(self, name, lam, spec, espec, badmask=None,
                 resolution=None):
        self.name = str(name)
        self.lam = np.ascontiguousarray(lam, dtype=np.float64)
        self.spec = np.ascontiguousarray(spec, dtype=np.float64)
        self.espec = np.ascontiguousarray(espec, dtype=np.float64)
        self.badmask = np.zeros(len(self.spec), dtype=bool) \
            if badmask is None else np.ascontiguousarray(badmask, bool)
        self.resolution = resolution
        if not (len(self.lam) == len(self.spec) == len(self.espec)
                == len(self.badmask)):
            raise ValueError('inconsistent array lengths')


@dataclasses.dataclass(frozen=True)
class ArmState:
    """Likelihood tensors of one arm, leading fiber axis B.

    ``idx0`` are the float64-precomputed fractional template-grid
    indices of the arm pixels (``lam_over_step`` = lam/step for linear
    template grids), which make the Doppler shift a cancellation-free
    index offset (ops/spline.doppler_index_shift).
    """

    name: str
    setup: str
    lam: torch.Tensor            # (npix,)
    dvec: torch.Tensor           # (B, npix) spec/espec
    espec_inv: torch.Tensor      # (B, npix) 1/espec
    polys: torch.Tensor          # (npoly, npix) continuum basis
    polys_prod: torch.Tensor     # (npoly^2, npix) basis products
    log_espec_sum: torch.Tensor  # (B,)
    idx0: torch.Tensor           # (npix,)
    lam_over_step: torch.Tensor | None = None
    band: BandedMatrix | None = None   # bands (B, noff, npix)

    @property
    def npix(self):
        return self.lam.shape[0]

    @classmethod
    def from_host(cls, name, setup, lam, flux, espec, geom, npoly=5,
                  rbf=True, band=None, device=None, dtype=None):
        """From host arrays: lam (npix,), flux/espec (B, npix) with
        finite flux and positive errors, template geometry ``geom``,
        optional (B, noff, npix) host band data as a BandedMatrix."""
        device = resolve_device(device)
        dtype = dtype or dtype_for(device)
        to = lambda a: torch.as_tensor(np.array(a, np.float64),
                                       dtype=dtype, device=device)
        lam = np.asarray(lam, np.float64)
        flux = np.atleast_2d(flux)
        espec = np.atleast_2d(espec)
        polys = to(basis_mod.continuum_basis(lam, npoly, rbf=rbf))
        if band is not None:
            band = BandedMatrix(tuple(band.offsets), to(band.bands))
        return cls(name=str(name), setup=str(setup), lam=to(lam),
                   dvec=to(flux / espec), espec_inv=to(1.0 / espec),
                   polys=polys, polys_prod=basis_products(polys),
                   log_espec_sum=to(np.log(espec).sum(axis=1)),
                   idx0=to(fractional_index(geom, lam)),
                   lam_over_step=None if geom.log_step
                   else to(lam / geom.step),
                   band=band)

    @classmethod
    def build(cls, sd: SpecData, geom, npoly=5, rbf=True, device=None):
        """Single-object state (fiber axis of length 1) from a
        SpecData."""
        band = sd.resolution
        if band is not None:
            band = BandedMatrix(tuple(band.offsets),
                                np.asarray(band.bands)[None])
        return cls.from_host(sd.name, sd.name, sd.lam, sd.spec, sd.espec,
                             geom, npoly=npoly, rbf=rbf, band=band,
                             device=device)

    def take(self, idx):
        """The state of the fibers at ``idx`` (a long tensor)."""
        return dataclasses.replace(
            self, dvec=self.dvec[idx], espec_inv=self.espec_inv[idx],
            log_espec_sum=self.log_espec_sum[idx],
            band=None if self.band is None else self.band.take(idx))
