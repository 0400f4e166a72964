"""The program's own spans, events and counters (rvspecfit_torch.trace),
as the per-layer readers take them.  Spans and events are the tracer's
records, stamped in nanoseconds on the epoch clock; the traced window's
bounds are seconds on the same clock (time.time).

A program without the tracer, or a run without a device trace, has
nothing to read: every function here then returns None."""
import threading

from benchlib import spec
from benchlib.trace import union_length


def _tracer():
    try:
        from rvspecfit_torch import trace
    except ImportError:
        return None
    return trace


def records(dtrace):
    """Every span and event the program recorded, or None without a
    device trace or without the program's tracer."""
    if dtrace is None or dtrace.t0 is None or dtrace.t1 is None:
        return None
    trace = _tracer()
    return None if trace is None else trace.spans()


def counters(dtrace):
    """The program's counters over the whole run (every span's
    ``<name>.ns`` among them), or None as :func:`records`."""
    if dtrace is None:
        return None
    trace = _tracer()
    return None if trace is None else trace.counters()


def main_thread():
    return threading.main_thread().name


def inside(dtrace, name, thread=None):
    """The records called ``name`` (of ``thread``) that lie wholly
    inside the traced window; None as :func:`records`."""
    recs = records(dtrace)
    if recs is None:
        return None
    lo, hi = 1e9 * dtrace.t0, 1e9 * dtrace.t1
    return [r for r in recs if r.name == name
            and (thread is None or r.thread == thread)
            and lo <= r.t0 and r.t1 <= hi]


def clipped(dtrace, names, thread=None):
    """The records called one of ``names`` (of ``thread``) clipped to
    the traced window, as (start, end) in seconds; None as
    :func:`records`."""
    recs = records(dtrace)
    if recs is None:
        return None
    out = []
    for r in recs:
        if r.name in names and (thread is None or r.thread == thread):
            s, e = max(1e-9 * r.t0, dtrace.t0), min(1e-9 * r.t1, dtrace.t1)
            if e > s:
                out.append((s, e))
    return out


def overlap(a, b):
    """Total length of the intersection of two lists of (start, end)."""
    return union_length(a) + union_length(b) - union_length(a + b)


def per_kspec(seconds_recs, fibre_recs):
    """Seconds of ``seconds_recs`` per 1000 of the ``fibres`` that
    ``fibre_recs`` hold; None without records or fibres."""
    fibres = sum(r.attrs.get('fibres', 0) for r in fibre_recs)
    if not fibre_recs or not fibres:
        return None
    return sum(r.seconds for r in seconds_recs) / fibres * 1e3


def kernel_share(ctx, dtrace, kernel):
    """``readers.kernel_share``'s rule with the program's ``kernel``
    events as the calls: percent of the least time of the launches in
    the traced window (kernels/<kernel>/work.py, at each event's
    attributes) over the device time of the trace's kernels that the
    kernel's implementation files name; None without either."""
    calls = inside(dtrace, kernel)
    if not calls:
        return None
    table = spec.kernel_table(ctx.cell.bench_dir)[kernel]
    names = [n for impl in table['impls'] for n in impl['names']]
    dev = sum(e - s for n, s, e in dtrace.events
              if any(x in n for x in names))
    if dev <= 0:
        return None
    least = sum(table['work'].bound_s(**c.attrs)[0] for c in calls)
    return 100.0 * least / dev
