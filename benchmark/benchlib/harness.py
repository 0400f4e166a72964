"""One run of one cell: set up, measure a window, judge the answers
against the plain reference, and print the result line.

The window is closed-loop and completion-stamped on the host's clock:
the first completion after set-up opens it, the first completion at or
after ``--seconds`` later closes it, and the spectra completed after
the opening up to and including the closing one, over the time between
the two, give ``spectra_per_s``.  Work still running when it closes is
finished and dropped; no new group or object is started."""
import json
import statistics
import sys
import threading
import time

import numpy as np
import torch

from benchlib import compare, spec
from benchlib.trace import DeviceTrace, Spans

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'rvspecfit_tpu')


class WindowClosed(BaseException):
    """Raised into the program's loop to stop it starting new work once
    the window has closed (a BaseException, so no handler of the
    program's takes it for a failure of its own)."""


class Window:
    """Completion stamps and the window they open and close."""

    def __init__(self, seconds, on_open=None):
        self.seconds = float(seconds)
        self.on_open = on_open
        self.t_open = self.t_close = None
        self.done = []                 # (t, n, key) after the opening
        self._lock = threading.Lock()

    def open(self, t):
        """Open the window at ``t``, before any completion (a reading
        whose first group or object counts)."""
        with self._lock:
            self.t_open = t
            if self.on_open:
                self.on_open(t)

    def complete(self, n, key=None, t=None):
        t = time.time() if t is None else t
        with self._lock:
            if self.t_close is not None:
                return
            if self.t_open is None:
                self.t_open = t
                if self.on_open:
                    self.on_open(t)
                return
            self.done.append((t, n, key))
            if t >= self.t_open + self.seconds:
                self.t_close = t

    @property
    def closed(self):
        return self.t_close is not None

    def keys(self):
        return [k for _, _, k in self.done]

    def spectra(self):
        return sum(n for _, n, _ in self.done)

    def rate(self):
        return self.spectra() / (self.t_close - self.t_open)


class Context:
    """What a driver gets: the cell, the run's arguments, the device,
    the program's dtype, spans, and what the window's work recorded."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 dtype=torch.float64):
        self.cell, self.seed, self.seconds = cell, int(seed), seconds
        self.trace, self.device, self.t_start = bool(trace), device, t_start
        self.spans = Spans()
        self.dtype = dtype             # float32: the precision control
        self.kernel_calls = []         # (t, kernel, dims) while tracing
        self.tracing = False
        self.groups = []               # group fits (or objects) run
        self.phases = {}               # group key -> seconds per stage
        self.t_open = None

    def rng(self, stream):
        return np.random.default_rng([self.seed, stream])


def log(msg):
    """A progress line on standard error (before the compared numbers)."""
    print(f'[bench {time.strftime("%H:%M:%S")}] {msg}', file=sys.stderr,
          flush=True)


def check_device(chips):
    """Exit without a result where the run's cards are missing."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'this cell needs {chips} CUDA card(s); torch sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        sys.exit(3)


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def peak_bytes(device):
    if device.type != 'cuda':
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def run(workload, seed, seconds, trace, t_start, device=None,
        dtype=torch.float64, bench_dir=spec.BENCH_DIR, cell=None,
        open_at_start=False, per_answer=None):
    """One run; returns the result dict (the printed line's keys, then
    ``checks`` last).  ``open_at_start`` opens the window as set-up ends,
    so that the first completion counts (a reading of calibrate.py, not
    a run of the benchmark); ``per_answer``, a dict, receives each
    compared number per judged answer and the answers."""
    cell = cell or spec.Cell(workload, bench_dir)
    if device is None:
        check_device(cell.chips)
        device = torch.device('cuda', 0)
    device = torch.device(device)
    ctx = Context(cell, seed, seconds, trace, device, t_start, dtype)
    drv = cell.driver()
    state = drv.prepare(ctx)
    setup_peak = peak_bytes(device)
    log(f'set-up done at {time.time() - t_start:.1f} s, peak '
        f'{setup_peak / 1e9:.2f} GB')

    def on_open(t):
        ctx.t_open = t
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(device)

    win = Window(seconds, on_open)
    dtrace = None
    if trace and device.type == 'cuda':
        dtrace = DeviceTrace(cell.traffic['trace_seconds'])
    if open_at_start:
        win.open(time.time())
    try:
        drv.measure(ctx, state, win, dtrace)
    finally:
        if dtrace is not None and dtrace.running:
            dtrace.stop()
        ctx.tracing = False
    if not win.closed:
        raise RuntimeError('the input ran dry before the window closed: '
                           f'{len(win.done)} completions in '
                           f'{time.time() - (win.t_open or time.time()):.1f} s')
    window_peak = peak_bytes(device)
    log(f'window {win.t_close - win.t_open:.2f} s, {win.spectra()} spectra '
        f'in {len(win.done)} completions; run ended at '
        f'{time.time() - t_start:.1f} s')
    answers = drv.answers(ctx, state, win)
    ref_arms = drv.reference_arms(ctx, state)
    drv.free(ctx, state)
    for g, ph in sorted(ctx.phases.items()):
        log(f'group {g}: ' + ' '.join(f'{k}={v:.2f}' for k, v in ph.items()))
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.time()
    checks, failed, per = compare.judge(ctx, answers, ref_arms)
    if per_answer is not None:
        per_answer.update(numbers=per, answers=answers)
    log(f'reference over {len(answers)} answers took {time.time() - t_ref:.1f} s')
    correct = all(c['value'] <= c['limit'] for c in checks.values())

    result = dict(correct=bool(correct), attempted=len(answers),
                  failed=int(failed))
    if trace:
        metrics = {}
        for m in cell.metrics('per_layer'):
            val = cell.reader(m['name']).read(ctx, win, dtrace)
            if val is not None:
                metrics[m['name']] = dict(value=float(val), unit=m['unit'])
    else:
        truth_dev = drv.velocity_devs(ctx, state, win)
        e2e = dict(
            spectra_per_s=win.rate(),
            peak_device_gb=window_peak / 1e9,
            rv_abs_dev_kms=float(statistics.median(truth_dev)),
            setup_s=ctx.t_open - t_start)
        metrics = {m['name']: dict(value=float(e2e[m['name']]),
                                   unit=m['unit'])
                   for m in cell.metrics('end_to_end')}
    result['metrics'] = metrics
    result['device'] = dict(
        platform='gpu' if device.type == 'cuda' else device.type,
        kind=torch.cuda.get_device_name(device) if device.type == 'cuda'
        else 'cpu', count=cell.chips,
        memory_peak_bytes=max(setup_peak, window_peak))
    if dtrace is not None:
        result['device'].update(busy_s=dtrace.busy_s(),
                                window_s=dtrace.window_s)
        result['breakdown'] = breakdown(ctx, dtrace)
    result['checks'] = checks
    return result


def breakdown(ctx, dtrace, n=10):
    """The device operations with the most time, and the longest idle
    gaps named by the host span that held the gap's middle."""
    ops = sorted(dtrace.by_name().items(), key=lambda kv: -kv[1])[:n]
    gaps = []
    for s, e in dtrace.idle_gaps()[:n]:
        mid = 0.5 * (s + e)
        held = [nm for nm, t0, t1, _ in ctx.spans.items if t0 <= mid <= t1]
        gaps.append([held[-1] if held else 'host', e - s])
    return dict(device_ops=[[k[:120], v] for k, v in ops], idle_gaps=gaps)


def emit(result):
    """The compared numbers on standard error, then the result line."""
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=True))
    sys.stdout.flush()
