"""Seconds in fit/ccf.fit per object completed in the window, from
the benchmark's spans."""
from benchlib import readers


def read(ctx, win, dtrace):
    return readers.per_object(ctx, win, 'ccf')
