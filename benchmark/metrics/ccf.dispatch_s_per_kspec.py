"""Host seconds of the CCF's dispatch (the program's ``ccf.dispatch``
spans: continuum fits, FFTs and kernel B's launches, fit/ccf.
fit_batch_async) per 1000 of their fibres, of the spans wholly inside
the traced window."""
from benchlib import program_trace as pt


def read(ctx, win, dtrace):
    spans = pt.inside(dtrace, 'ccf.dispatch')
    return pt.per_kspec(spans, spans) if spans else None
