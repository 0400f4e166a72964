"""Seconds of Nelder-Mead (the group fit's ``phases['nm']``) per 1000
fibres, over the groups completed in the window."""
from benchlib import readers


def read(ctx, win, dtrace):
    gs = readers.groups_in(ctx, win)
    n = sum(g['nfibers'] for g in gs)
    return sum(g['nm'] for g in gs) / n * 1e3 if n else None
