"""Clamps with the reference's gradient.

``jnp.clip`` and ``jnp.maximum`` differentiate by multiplying the
upstream gradient by a mask (1 inside the range, 1/2 at a bound, 0
outside); ``torch.clamp`` selects instead.  The two differ where the
upstream gradient is inf or NaN: the reference's gives 0 * inf = NaN
outside the range, torch's gives 0.  The rotation kernel's gradient
meets exactly that (sqrt at 0 beyond the kernel's support), so the
differentiated paths clamp through :func:`clip` to keep the
reference's NaN pattern.
"""
from __future__ import annotations

import torch


class _Clip(torch.autograd.Function):
    """clamp(x, lo, hi) forward; g * mask backward, differentiable
    again (the mask is a constant)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        lo, hi = ctx.bounds
        w = torch.ones_like(x)
        y = x
        if lo is not None:
            w = (x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype)
            y = torch.clamp(x, min=lo)
        if hi is not None:
            w = w * ((y < hi).to(x.dtype) + 0.5 * (y == hi).to(x.dtype))
        return g * w, None, None


def clip(x, lo=None, hi=None):
    """``torch.clamp(x, lo, hi)`` whose gradient is ``jnp.clip``'s (a
    bound of None is open).  Without autograd it is torch.clamp."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, lo, hi)
    return _Clip.apply(x, lo, hi)
