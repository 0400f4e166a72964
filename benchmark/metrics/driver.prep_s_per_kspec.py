"""Host seconds in survey/desi.prepare_desi_group (read, select, stack
the arms, dispatch the CCF) per 1000 spectra completed in the window,
from the benchmark's spans around it, over the groups completed in the
window."""
from benchlib import readers


def read(ctx, win, dtrace):
    return readers.per_kspec(ctx, win, 'prep')
