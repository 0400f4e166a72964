"""Seconds of the tail (polish, refinement, Hessian errors, models:
the group fit's phases, on the thread that ran it) per 1000 fibres,
over the groups completed in the window."""
from benchlib import readers

TAIL = ('polish', 'refine', 'hessian', 'models')


def read(ctx, win, dtrace):
    gs = readers.groups_in(ctx, win)
    n = sum(g['nfibers'] for g in gs)
    return sum(g[k] for g in gs for k in TAIL) / n * 1e3 if n else None
