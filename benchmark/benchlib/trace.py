"""Spans recorded around calls into the program, and the reduction of a
torch.profiler trace of the card to busy time, kernel time by name and
idle gaps."""
import contextlib
import threading
import time

import torch


class Spans:
    """Thread-safe record of (name, start, end, attrs) on the host's
    clock (time.time, as the window's completions are stamped)."""

    def __init__(self):
        self.items = []
        self._lock = threading.Lock()

    def add(self, name, t0, t1, **attrs):
        with self._lock:
            self.items.append((name, t0, t1, attrs))

    def of(self, name):
        """The spans called ``name``."""
        with self._lock:
            return [s for s in self.items if s[0] == name]

    @contextlib.contextmanager
    def wrap(self, module, attr, name, record_args=None):
        """Replace ``module.attr`` with a wrapper that records a span
        around each call (``record_args(args, kwargs, result)`` adds
        attributes); restored on leaving."""
        real = getattr(module, attr)

        def wrapper(*args, **kwargs):
            t0 = time.time()
            out = real(*args, **kwargs)
            extra = record_args(args, kwargs, out) if record_args else {}
            self.add(name, t0, time.time(), **extra)
            return out
        setattr(module, attr, wrapper)
        try:
            yield real
        finally:
            setattr(module, attr, real)


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class DeviceTrace:
    """torch.profiler over a traced window of at most ``seconds``, kept
    as device intervals: CUDA kernels, memory copies and sets (not the
    profiler's annotations), each (name, start_s, end_s) on the host's
    clock.  A driver starts and stops it on its main thread, at the
    points its traffic allows (:meth:`due` says when to stop)."""

    def __init__(self, seconds):
        self.seconds = float(seconds)      # the most it traces
        self.events = []
        self.t0 = self.t1 = self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        self.t0 = time.time()
        self._prof = prof                  # other threads read due()

    def stop(self):
        """End the trace (on the thread that started it) and keep its
        device intervals: the raw activity records, without the
        profiler's own (slow) processing into FunctionEvents."""
        prof, self._prof = self._prof, None
        torch.cuda.synchronize()
        self.t1 = time.time()
        prof.__exit__(None, None, None)
        res = prof.profiler.kineto_results
        base = res.trace_start_ns()
        cuda = torch.autograd.DeviceType.CUDA
        self.events = [
            (e.name(), self.t0 + 1e-9 * (e.start_ns() - base),
             self.t0 + 1e-9 * (e.start_ns() + e.duration_ns() - base))
            for e in res.events()
            if e.device_type() == cuda and not e.is_user_annotation()]

    @property
    def running(self):
        return self._prof is not None

    def due(self):
        """Whether the trace has run its ``seconds``."""
        return self._prof is not None and \
            time.time() >= self.t0 + self.seconds

    @property
    def window_s(self):
        return self.t1 - self.t0

    def busy_s(self):
        return union_length([(s, e) for _, s, e in self.events])

    def by_name(self):
        out = {}
        for n, s, e in self.events:
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def idle_gaps(self):
        """Gaps between device intervals, longest first: (start, end)."""
        gaps, end = [], None
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        return sorted(gaps, key=lambda g: g[0] - g[1])
