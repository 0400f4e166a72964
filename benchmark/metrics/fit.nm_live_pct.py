"""Percent of Nelder-Mead's tile work spent on fibres not yet converged,
over the whole run: 100 x the program's counter ``fit.nm.live_iters``
(the live fibres summed over each tile's iterations) over
``fit.nm.tile_iters`` (the tiles' widths times their iterations).  A
converged fibre stays in its tile until the round ends."""
from benchlib import program_trace as pt


def read(ctx, win, dtrace):
    c = pt.counters(dtrace)
    if not c or not c.get('fit.nm.tile_iters'):
        return None
    return 100.0 * c.get('fit.nm.live_iters', 0) / c['fit.nm.tile_iters']
