"""Rotational (vsini) broadening with an analytic limb-darkened kernel.

Counterpart of rvspecfit_tpu/ops/vsini.py, batched over trials: the
kernel of each trial has the static length 2*half_width+1 (half_width
from the configured maximum vsini), with analytically zero weights
beyond the true support, so one fixed-shape stencil serves every
trial.  vsini = 0 gives an exact delta kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SPEED_OF_LIGHT = 299792.458  # km/s


def kernel_half_width(max_vsini, log_step):
    """Static kernel half-width in pixels for a given max vsini."""
    rmax = (max_vsini / SPEED_OF_LIGHT) / log_step
    return int(math.ceil(rmax + 1)) + 1


def _primitives(x, eps):
    """Primitives of K(x) and x K(x) for the rotation profile K."""
    x = torch.clamp(x, -1.0, 1.0)
    norm = math.pi * (1.0 - eps / 3.0)
    c1 = 2.0 * (1.0 - eps) / norm
    c2 = (math.pi / 2.0) * eps / norm
    sq = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    k0 = c1 * 0.5 * (x * sq + torch.arcsin(x)) + c2 * (x - x**3 / 3.0)
    k1 = (c1 * (-1.0 / 3.0) * (1.0 - x * x) * sq
          + c2 * (x * x / 2.0 - x**4 / 4.0))
    return k0, k1


def _segment_integral(xa, xb, slope, intercept, eps):
    """Integral_{xa}^{xb} (slope x + intercept) K(x) dx, 0 if xb <= xa."""
    k0b, k1b = _primitives(xb, eps)
    k0a, k1a = _primitives(xa, eps)
    val = slope * (k1b - k1a) + intercept * (k0b - k0a)
    return torch.where(xb > xa, val, 0.0)


def rotation_kernel(vsini, log_step, half_width, eps=0.6):
    """(T,) vsini [km/s] -> (T, 2*half_width+1) normalized kernels."""
    r_true = (vsini / SPEED_OF_LIGHT) / log_step        # pixels
    r = torch.clamp(r_true, min=1e-6)[:, None]
    k = torch.arange(half_width + 1, dtype=vsini.dtype,
                     device=vsini.device)[None, :]
    w = _segment_integral(torch.clamp(k / r, -1, 1),
                          torch.clamp((k + 1) / r, -1, 1),
                          slope=-r, intercept=1.0 + k, eps=eps)
    w = w + _segment_integral(torch.clamp((k - 1) / r, -1, 1),
                              torch.clamp(k / r, -1, 1),
                              slope=r, intercept=1.0 - k, eps=eps)
    full = torch.cat([w[:, 1:].flip(-1), w], dim=-1)
    full = full / full.sum(-1, keepdim=True)
    delta = torch.zeros_like(full)
    delta[:, half_width] = 1.0
    return torch.where((r_true <= 1e-6)[:, None], delta, full)


def convolve_kernel_same(spec, kernel):
    """Row-wise 'same'-mode convolution with zero padding.

    spec (T, n), kernel (T, 2hw+1) -> (T, n), as numpy's mode='same'.
    """
    n = spec.shape[-1]
    klen = kernel.shape[-1]
    hw = (klen - 1) // 2
    padded = F.pad(spec, (hw, hw))
    out = torch.zeros_like(spec)
    for j in range(klen):
        out = out + kernel[:, j:j + 1] * padded[:, 2 * hw - j:
                                                2 * hw - j + n]
    return out
