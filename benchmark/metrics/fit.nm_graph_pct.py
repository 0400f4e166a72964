"""Percent of Nelder-Mead's objective calls served by CUDA graph
replays, over the whole run: 100 x the program's counter
``fit.nm.graph_replays`` times the objective calls one replay holds
(the scheme's ``nm_ncand``, 2 under the default scan2) over those plus
``fit.nm.eager_calls`` (the calls NM made eagerly: simplex set-ups,
restarts and shrinks).  A program without NM's graphs has neither
counter."""
from benchlib import program_trace as pt


def read(ctx, win, dtrace):
    c = pt.counters(dtrace)
    if not c or not ('fit.nm.graph_replays' in c
                     or 'fit.nm.eager_calls' in c):
        return None
    from rvspecfit_torch.fit.neldermead import nm_ncand
    served = c.get('fit.nm.graph_replays', 0) * nm_ncand()
    total = served + c.get('fit.nm.eager_calls', 0)
    return 100.0 * served / total if total else None
