"""Kernel A's adjoint's share of its roofline: the least time of the
launches in the traced window (the program's ``kernel_a_adjoint``
events: kernels/kernel_a_adjoint/work.py) over the device time of the
kernels that kernels/kernel_a_adjoint/*.json name."""
from benchlib import program_trace as pt


def read(ctx, win, dtrace):
    return pt.kernel_share(ctx, dtrace, 'kernel_a_adjoint')
