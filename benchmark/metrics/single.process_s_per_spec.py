"""Seconds in fit/vel_fit.process per object completed in the window,
from the benchmark's spans."""
from benchlib import readers


def read(ctx, win, dtrace):
    return readers.per_object(ctx, win, 'process')
