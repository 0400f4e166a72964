"""The port's one tracer: spans, events and counters.

A span times a block of host code::

    with trace.span('fit.nm', fibres=500) as sp:
        ...
        sp.set(iters=64)
    sp.seconds                     # always measured

Every span measures its ``seconds`` and adds its nanoseconds to the
counter ``<name>.ns``, so that a whole run's time in each span can be
read without a profiler.  It is *recorded* (kept with its name,
thread, start and end on the epoch clock of ``time.time_ns``, its id,
the id of the span open on the same thread when it began, and its
attributes) only while a torch profiler records in this process:
the program traces exactly while someone profiles it, and there is no
other switch.  While recording on the thread that runs the profiler,
a span also opens ``torch.profiler.record_function(name)``, so the
profiler's own trace shows that thread's spans beside the kernels.
The start times of the profiler's (kineto's) events, and its
``trace_start_ns()``, are on the same epoch clock.

:func:`event` adds a zero-length record under the same rule.
:func:`count` adds to a named integer counter, always.  Inside
:func:`deferred` a thread's counts and events are held instead, and
:func:`replay` applies them later, as often as the work they describe
runs again (the launches a CUDA graph holds, at each of its replays).
Spans made with ``keep=True`` (the kernels' builds) are also kept,
always, in a small list of their own (:func:`kept`).

Records go to a bounded in-memory buffer (the oldest go first once it
holds :data:`MAX_RECORDS`); :func:`spans` returns a snapshot of it and
:func:`clear` empties it.  Nothing is written to disk, and nothing
here synchronizes a device.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# records the buffer holds: a traced group fit of 1000 fibres makes a
# few thousand (its kernel launches' events most), so this keeps
# several groups, and a process that runs for hours stays bounded
MAX_RECORDS = 1 << 18


class Record(collections.namedtuple(
        'Record', 'kind name thread t0 t1 id parent attrs')):
    """One span (``kind`` 'span') or event ('event'): ``t0`` and ``t1``
    are ``time.time_ns()`` stamps (equal for an event), ``id`` and
    ``parent`` (the id of the span open on the same thread at the
    start, or None) are process-wide integers, ``attrs`` a dict."""
    __slots__ = ()

    @property
    def seconds(self):
        return 1e-9 * (self.t1 - self.t0)


_records = collections.deque(maxlen=MAX_RECORDS)
_kept = collections.deque(maxlen=256)
_ids = itertools.count(1)
_local = threading.local()
_count_lock = threading.Lock()
_counters = collections.Counter()


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """A timed block (:func:`span`)."""

    __slots__ = ('name', 'attrs', 'keep', 'seconds', '_t0', '_id',
                 '_parent', '_rec', '_rf')

    def __init__(self, name, keep, attrs):
        self.name, self.keep, self.attrs = name, keep, attrs
        self.seconds = None
        self._id = self._rf = None

    def set(self, **attrs):
        """Add or replace attributes before the span ends."""
        self.attrs.update(attrs)

    def __enter__(self):
        self._rec = _autograd_profiler._is_profiler_enabled
        if self._rec or self.keep:
            stack = _stack()
            self._id = next(_ids)
            self._parent = stack[-1] if stack else None
            stack.append(self._id)
            if torch._C._autograd._profiler_enabled():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.seconds = 1e-9 * (t1 - self._t0)
        count(self.name + '.ns', t1 - self._t0)
        if self._id is not None:
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None
            stack = _stack()
            if stack and stack[-1] == self._id:
                stack.pop()
            rec = Record('span', self.name,
                         threading.current_thread().name, self._t0, t1,
                         self._id, self._parent, self.attrs)
            if self.keep:
                _kept.append(rec)
            if self._rec:
                _records.append(rec)
        return False


def span(name, keep=False, **attrs):
    """A context manager that times its block (``.seconds``, and the
    counter ``<name>.ns``) and, while
    a profiler records, records it as ``name`` with ``attrs`` (more may
    be added by ``.set(...)`` before it ends).  ``keep``: also keep it
    in :func:`kept`, whether a profiler records or not."""
    return Span(name, keep, attrs)


def event(name, **attrs):
    """A zero-length record ``name`` with ``attrs``, while a profiler
    records (held inside :func:`deferred`)."""
    held = getattr(_local, 'held', None)
    if held is not None:
        held.append(('event', name, attrs))
        return
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _stack()
    t = time.time_ns()
    _records.append(Record('event', name, threading.current_thread().name,
                           t, t, next(_ids), stack[-1] if stack else None,
                           attrs))


def count(name, n=1):
    """Add ``n`` to the counter ``name`` (always; any thread; held
    inside :func:`deferred`)."""
    held = getattr(_local, 'held', None)
    if held is not None:
        held.append(('count', name, n))
        return
    with _count_lock:
        _counters[name] += n


@contextlib.contextmanager
def deferred():
    """Hold this thread's :func:`count` and :func:`event` calls in the
    list it yields, in order, instead of applying them."""
    prev = getattr(_local, 'held', None)
    _local.held = held = []
    try:
        yield held
    finally:
        _local.held = prev


def replay(held):
    """Apply the counts and events that :func:`deferred` held (the
    events only while a profiler records, as :func:`event`)."""
    for kind, name, arg in held:
        if kind == 'count':
            count(name, arg)
        else:
            event(name, **arg)


def counters(prefix=''):
    """A snapshot of the counters whose names start with ``prefix``."""
    with _count_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset_counters(prefix=''):
    """Zero the counters whose names start with ``prefix``."""
    with _count_lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]


def spans(name=None):
    """A snapshot of the recorded spans and events (all, or those
    called ``name``), oldest first."""
    out = list(_records)
    return out if name is None else [r for r in out if r.name == name]


def kept(name=None):
    """The spans made with ``keep=True`` (all, or those called
    ``name``), oldest first, whether a profiler recorded or not."""
    out = list(_kept)
    return out if name is None else [r for r in out if r.name == name]


def clear():
    """Empty the buffer of recorded spans and events."""
    _records.clear()
