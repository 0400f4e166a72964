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
import itertools

import numpy as np
import torch

from rvspecfit_torch.device import dtype_for, resolve_device
from rvspecfit_torch.ops import basis as basis_mod
from rvspecfit_torch.ops.chisq import basis_products
from rvspecfit_torch.ops.resolution import BandedMatrix
from rvspecfit_torch.ops.spline import fractional_index


_objid_counter = itertools.count(1)


class SpecData:
    """One observed spectrum: name (the template setup), wavelengths,
    flux, errors, mask, optional resolution (BandedMatrix with (noff,
    npix) bands).  Hashable by identity, so it can key caches."""

    __slots__ = ('name', 'lam', 'spec', 'espec', 'badmask', 'resolution',
                 '_objid')

    def __init__(self, name, lam, spec, espec, badmask=None,
                 resolution=None):
        self.name = str(name)
        self.lam = np.ascontiguousarray(lam, dtype=np.float64)
        self.spec = np.ascontiguousarray(spec, dtype=np.float64)
        self.espec = np.ascontiguousarray(espec, dtype=np.float64)
        self.badmask = np.zeros(len(self.spec), dtype=bool) \
            if badmask is None else np.ascontiguousarray(badmask, bool)
        if resolution is not None and not isinstance(resolution,
                                                     BandedMatrix):
            raise TypeError('resolution must be a BandedMatrix')
        self.resolution = resolution
        if not (len(self.lam) == len(self.spec) == len(self.espec)
                == len(self.badmask)):
            raise ValueError('inconsistent array lengths')
        self._objid = next(_objid_counter)

    def __hash__(self):
        return self._objid

    def __eq__(self, other):
        return self is other

    def __len__(self):
        return len(self.lam)

    def __repr__(self):
        return (f'SpecData({self.name!r}, npix={len(self.lam)}, '
                f'lam=[{self.lam[0]:.1f}..{self.lam[-1]:.1f}])')


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
    def build(cls, sd: SpecData, geom, npoly=5, rbf=True,
              espec_systematic=None, resol_matrix=None, device=None,
              dtype=None):
        """Single-object state (fiber axis of length 1) from a SpecData.

        ``espec_systematic`` is added to the errors in quadrature;
        ``resol_matrix`` is a per-call resolution (BandedMatrix),
        exclusive with the SpecData's own."""
        espec = sd.espec
        if espec_systematic is not None:
            espec = np.sqrt(np.asarray(espec_systematic)**2 + espec**2)
        if resol_matrix is not None and sd.resolution is not None:
            raise ValueError('resol_params cannot be combined with a '
                             'per-SpecData resolution')
        band = resol_matrix if resol_matrix is not None else sd.resolution
        if band is not None:
            band = BandedMatrix(tuple(band.offsets),
                                band.host_bands()[None])
        return cls.from_host(sd.name, sd.name, sd.lam, sd.spec, espec,
                             geom, npoly=npoly, rbf=rbf, band=band,
                             device=device, dtype=dtype)

    def take(self, idx):
        """The state of the fibers at ``idx`` (a long tensor)."""
        return dataclasses.replace(
            self, dvec=self.dvec[idx], espec_inv=self.espec_inv[idx],
            log_espec_sum=self.log_espec_sum[idx],
            band=None if self.band is None else self.band.take(idx))
