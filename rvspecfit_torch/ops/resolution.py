"""Banded resolution-matrix convolution.

Counterpart of rvspecfit_tpu/ops/resolution.py: ``BandedMatrix`` and
its host builders, :func:`gaussian_resolution_matrix` (a Gaussian line
spread function) and :func:`banded_from_desi_resolution` (DESI's
RESOLUTION extension).  The builders return float64 numpy bands; the
fitters move them to their device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BandedMatrix:
    """Banded square matrices in row-oriented diagonal storage.

    ``bands[..., j, i]`` is M[i, i + offsets[j]]; leading axes of
    ``bands`` index a stack of matrices (e.g. one per fiber).
    Out-of-range entries are ignored.  ``bands`` is a tensor for
    :meth:`matvec`, or a host array as the builders return it.
    """

    offsets: tuple
    bands: torch.Tensor          # (..., noff, n)

    def matvec(self, x):
        """y[..., i] = sum_j bands[..., j, i] * x[..., i + offsets[j]].

        ``bands[..., j, :]`` must broadcast against ``x``.
        """
        n = x.shape[-1]
        cols = torch.arange(n, device=x.device)
        y = torch.zeros_like(x)
        for j, off in enumerate(self.offsets):
            valid = (cols + off >= 0) & (cols + off < n)
            y = y + torch.where(
                valid, self.bands[..., j, :] * torch.roll(x, -off, -1),
                0.0)
        return y

    def take(self, idx):
        """The matrices at leading-axis indices ``idx``."""
        return BandedMatrix(self.offsets, self.bands[idx])

    def host_bands(self):
        """The bands as a float64 numpy array."""
        b = self.bands
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu().double().numpy()
        return np.asarray(b, np.float64)

    def to_dense(self):
        """The (n, n) dense matrix of an unstacked (noff, n) band."""
        b = self.host_bands()
        n = b.shape[-1]
        m = np.zeros((n, n))
        rows = np.arange(n)
        for j, off in enumerate(self.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < n)
            m[rows[ok], cols[ok]] = b[j, ok]
        return m


def gaussian_resolution_matrix(lam, resol=None, width=None, thresh=5.0):
    """Banded Gaussian line-spread matrix on the host (float64).

    lam : (n,) increasing wavelengths; exactly one of ``resol`` (R =
    lambda / FWHM, scalar or (n,)) and ``width`` (Gaussian sigma in
    wavelength units, scalar or (n,)); ``thresh`` truncates the kernel
    in sigmas.  Rows are normalized to unit sum.
    """
    lam = np.asarray(lam, dtype=np.float64)
    n = lam.shape[0]
    if (resol is None) == (width is None):
        raise ValueError('specify exactly one of resol or width')
    if resol is not None:
        sigs = lam / np.asarray(resol, dtype=np.float64) / 2.35
    else:
        sigs = np.broadcast_to(np.asarray(width, dtype=np.float64), (n,))
    if not np.all(np.diff(lam) > 0):
        raise ValueError('wavelengths must be increasing')
    lo = np.searchsorted(lam, lam - thresh * sigs, 'left')
    hi = np.minimum(np.searchsorted(lam, lam + thresh * sigs, 'right'),
                    n - 1)
    pix = np.arange(n)
    w = int(min(n, max(np.max(hi - pix), np.max(pix - lo))))
    offsets = np.arange(-w, w + 1)
    cols = pix[None, :] + offsets[:, None]            # (noff, n)
    valid = (cols >= 0) & (cols < n)
    cols_c = np.clip(cols, 0, n - 1)
    ker = np.exp(-0.5 * ((lam[cols_c] - lam[None, :]) / sigs[None, :])**2)
    ker = np.where(valid, ker, 0.0)
    # ker[j, i] weighs input pixel i + offsets[j] for output pixel i:
    # row-oriented band storage
    ker = ker / ker.sum(axis=0, keepdims=True)
    return BandedMatrix(tuple(int(o) for o in offsets), ker)


def banded_from_desi_resolution(resdata):
    """A DESI resolution array (noff, npix) as a BandedMatrix.

    DESI stores scipy ``dia_matrix`` data: row k is the diagonal of
    offset W - k indexed by COLUMN (M[i, j] = resdata[k, j], j - i =
    W - k); each diagonal is rolled to row indexing.  Values rolled
    around the edge land only where the matvec masks them.
    """
    resdata = np.asarray(resdata, np.float64)
    noff = resdata.shape[0]
    w = noff // 2
    offsets = tuple(int(w - k) for k in range(noff))
    return BandedMatrix(offsets, np.stack(
        [np.roll(resdata[k], k - w) for k in range(noff)]))
