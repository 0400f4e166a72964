"""Percent of the traced window in which no kernel, copy or set ran on
the card (the union of the device intervals)."""


def read(ctx, win, dtrace):
    if dtrace is None or dtrace.window_s <= 0:
        return None
    return 100.0 * (1.0 - dtrace.busy_s() / dtrace.window_s)
