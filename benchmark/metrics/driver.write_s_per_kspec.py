"""Host seconds in survey/desi._write_outputs (RVTAB and RVMOD) per
1000 spectra completed in the window, from the benchmark's spans."""
from benchlib import readers


def read(ctx, win, dtrace):
    return readers.per_kspec(ctx, win, 'write')
