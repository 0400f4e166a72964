"""Helpers the per-layer readers share: the window's spans, groups and
device intervals."""
from benchlib import spec


def spans_of_window(ctx, win, name):
    """The spans called ``name`` of the work completed in the window:
    those whose ``group`` (a group of files, or an object) completed
    there."""
    keys = set(win.keys())
    return [s for s in ctx.spans.of(name) if s[3].get('group') in keys]


def per_kspec(ctx, win, name):
    """Seconds of the window's ``name`` spans per 1000 spectra it
    completed; None without spans."""
    s = spans_of_window(ctx, win, name)
    if not s or not win.spectra():
        return None
    return sum(t1 - t0 for _, t0, t1, _ in s) / win.spectra() * 1e3


def per_object(ctx, win, name):
    """Mean seconds of the window's ``name`` spans; None without."""
    s = spans_of_window(ctx, win, name)
    return sum(t1 - t0 for _, t0, t1, _ in s) / len(s) if s else None


def groups_in(ctx, win):
    """Phases of the groups completed in the window."""
    return [ctx.phases[g] for g in win.keys() if g in ctx.phases]


def kernel_share(ctx, win, dtrace, kernel):
    """Percent of the least time of ``kernel``'s calls in the traced
    window (kernels/<kernel>/work.py) over the device time of the
    trace's kernels that its implementation files name; None without
    either."""
    if dtrace is None:
        return None
    table = spec.kernel_table(ctx.cell.bench_dir)[kernel]
    names = [n for impl in table['impls'] for n in impl['names']]
    calls = [d for t, k, d in ctx.kernel_calls
             if k == kernel and dtrace.t0 <= t <= dtrace.t1]
    dev = sum(e - s for n, s, e in dtrace.events
              if any(x in n for x in names))
    if not calls or dev <= 0:
        return None
    least = sum(table['work'].bound_s(**d)[0] for d in calls)
    return 100.0 * least / dev
