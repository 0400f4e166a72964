"""Host milliseconds per Nelder-Mead iteration of a tile: the mean of
the main thread's ``fit.nm.iter`` spans that lie wholly inside the
traced window (each ends where NM reads its convergence mask, so it
holds the iteration's device work)."""
from benchlib import program_trace as pt


def read(ctx, win, dtrace):
    iters = pt.inside(dtrace, 'fit.nm.iter', pt.main_thread())
    if not iters:
        return None
    return 1e3 * sum(r.seconds for r in iters) / len(iters)
