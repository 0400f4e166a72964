"""Seconds the driver's prep waited for the read-ahead reader
(``driver.read_wait`` spans) per 1000 fibres of the ``driver.prep``
spans, wholly inside the traced window, that hold them."""
from benchlib import program_trace as pt


def read(ctx, win, dtrace):
    preps = pt.inside(dtrace, 'driver.prep')
    if not preps:
        return None
    ids = {r.id for r in preps}
    waits = [r for r in pt.inside(dtrace, 'driver.read_wait')
             if r.parent in ids]
    return pt.per_kspec(waits, preps)
