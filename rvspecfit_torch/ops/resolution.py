"""Banded resolution-matrix convolution.

Counterpart of rvspecfit_tpu/ops/resolution.py (``BandedMatrix``).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BandedMatrix:
    """Banded square matrices in row-oriented diagonal storage.

    ``bands[..., j, i]`` is M[i, i + offsets[j]]; leading axes of
    ``bands`` index a stack of matrices (e.g. one per fiber).
    Out-of-range entries are ignored.
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
