"""Kernel B's share of its roofline: the least time of the window's
calls at their own shapes (kernels/kernel_b/work.py) over the device
time of the kernels that kernels/kernel_b/*.json name."""
from benchlib import readers


def read(ctx, win, dtrace):
    return readers.kernel_share(ctx, win, dtrace, 'kernel_b')
