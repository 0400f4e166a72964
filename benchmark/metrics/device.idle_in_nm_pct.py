"""Percent of the traced window in which the card was idle (the gaps
between its device intervals) while the main thread ran a round of
Nelder-Mead (the program's ``fit.nm.round`` spans, clipped to the
window)."""
from benchlib import program_trace as pt


def read(ctx, win, dtrace):
    rounds = pt.clipped(dtrace, ('fit.nm.round',), pt.main_thread())
    if not rounds or dtrace.window_s <= 0:
        return None
    return 100.0 * pt.overlap(dtrace.idle_gaps(), rounds) / dtrace.window_s
