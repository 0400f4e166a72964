"""The readers of the program's own spans, events and counters
(benchlib/program_trace.py and the metrics that use it): each gives the
expected number on hand-built records and counters and a stub device
trace, and None outside the window or without the program's tracer;
kernel A's count of intervals from a launch's shapes never exceeds the
exact count on a cell's grids; and the cell finds the new metrics by
name."""
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

from benchlib import generator, program_trace, spec
from conftest import ROOT

from rvspecfit_torch import trace

NS = 1_000_000_000
T0 = 1_800_000_000.0            # the window's start, epoch seconds
WORKLOAD = 'desi_petal_norot.tile500'
NEW = ('device.idle_in_nm_pct', 'fit.nm_ms_per_iter', 'fit.nm_live_pct',
       'driver.main_wait_pct', 'driver.read_wait_s_per_kspec',
       'ccf.dispatch_s_per_kspec', 'kernel_a_roofline',
       'kernel_a_adjoint_roofline')


class StubTrace:
    """A DeviceTrace's reading side over [T0, T0 + 10] s."""

    def __init__(self, events, t0=T0, t1=T0 + 10.0):
        self.t0, self.t1, self.events = t0, t1, events

    @property
    def window_s(self):
        return self.t1 - self.t0

    def idle_gaps(self):
        gaps, end = [], None
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        return gaps


_ids = iter(range(1, 10**6))


def rec(name, t0, t1=None, thread='MainThread', parent=None, kind='span',
        **attrs):
    """A program record at t0..t1 seconds after T0."""
    t1 = t0 if t1 is None else t1
    return trace.Record(kind, name, thread, round((T0 + t0) * NS),
                        round((T0 + t1) * NS), next(_ids), parent, attrs)


@pytest.fixture
def records(monkeypatch):
    """Hand the readers these records, and these counters (none by
    default), as the program's."""
    def use(recs, counts=None):
        monkeypatch.setattr(trace, 'spans', lambda name=None: list(recs))
        monkeypatch.setattr(trace, 'counters',
                            lambda prefix='': dict(counts or {}))
    return use


def reader(name):
    return spec.load_module(os.path.join(spec.BENCH_DIR, 'metrics',
                                         name + '.py'))


CTX = types.SimpleNamespace(cell=types.SimpleNamespace(
    bench_dir=spec.BENCH_DIR))


def read(name, dtrace):
    return reader(name).read(CTX, None, dtrace)


def test_nm_rounds(records):
    # device busy on [0, 1], [2, 3], [6, 10]: idle [1, 2] and [3, 6]
    dt = StubTrace([('k', T0, T0 + 1), ('k', T0 + 2, T0 + 3),
                    ('k', T0 + 6, T0 + 10)])
    records([rec('fit.nm.round', -1.0, 1.5, width=500, iters=64,
                 live_iters=20000),             # starts before the window
             rec('fit.nm.round', 2.5, 4.5, width=500, iters=64,
                 live_iters=16000),
             rec('fit.nm.round', 5.0, 5.5, width=100, iters=36,
                 live_iters=1800),
             rec('fit.nm.round', 5.5, 5.7, width=50),   # ended by an error
             rec('fit.nm.round', 4.0, 9.0, thread='rvst-tail', width=5,
                 iters=1, live_iters=5)])       # not the main thread
    # idle inside the main thread's rounds: [1, 1.5], [3, 4.5], [5, 5.7]
    # (the round an error ended still held the thread)
    assert read('device.idle_in_nm_pct', dt) == pytest.approx(
        100 * 2.7 / 10)


def test_nm_iterations(records):
    dt = StubTrace([('k', T0, T0 + 10)])
    records([rec('fit.nm.iter', -0.1, 0.05, live=500),  # starts before
             rec('fit.nm.iter', 0.05, 0.2, live=500),
             rec('fit.nm.iter', 0.2, 0.3, live=499),
             rec('fit.nm.iter', 0.3, 0.35, live=40),
             rec('fit.nm.iter', 9.9, 10.2, live=12),    # ends past it
             rec('fit.nm.iter', 1.0, 3.0, thread='rvst-tail', live=1)])
    assert read('fit.nm_ms_per_iter', dt) == pytest.approx(
        1e3 * 0.3 / 3)


def test_nm_live_share_is_the_whole_runs(records):
    dt = StubTrace([])
    records([], {'fit.nm.live_iters': 20800, 'fit.nm.tile_iters': 38800,
                 'fit.nm.iter.ns': 5})
    assert read('fit.nm_live_pct', dt) == pytest.approx(
        100 * 20800 / 38800)
    records([], {'fit.nm.tile_iters': 0})
    assert read('fit.nm_live_pct', dt) is None


def test_driver_waits_and_dispatch(records):
    dt = StubTrace([('k', T0, T0 + 10)])
    prep = rec('driver.prep', 1.0, 3.0, thread='rvst-prep', files=2,
               fibres=1000)
    early = rec('driver.prep', -3.0, -1.0, thread='rvst-prep', files=2,
                fibres=1000)
    records([early, prep,
             rec('driver.read_wait', -2.5, -2.0, thread='rvst-prep',
                 parent=early.id),
             rec('driver.read_wait', 1.0, 1.25, thread='rvst-prep',
                 parent=prep.id),
             rec('driver.read_wait', 1.5, 1.75, thread='rvst-prep',
                 parent=prep.id),
             rec('ccf.dispatch', 1.8, 2.8, thread='rvst-prep', fibres=1000),
             rec('ccf.dispatch', 9.5, 10.5, thread='rvst-prep',
                 fibres=1000)],                 # not wholly inside
            {'driver.group.ns': 40 * NS, 'driver.prep_wait.ns': NS // 2,
             'driver.write_wait.ns': 5 * NS // 2, 'driver.prep.ns': NS})
    assert read('driver.main_wait_pct', dt) == pytest.approx(7.5)
    assert read('driver.read_wait_s_per_kspec', dt) == pytest.approx(0.5)
    assert read('ccf.dispatch_s_per_kspec', dt) == pytest.approx(1.0)


def test_kernel_rooflines(records):
    table = spec.kernel_table()
    a = dict(rows=4000, npix=2751, nm1=6214, rows_per_coeff=1,
             form='float64')
    s = dict(rows=1000 * 401, npix=2751, nm1=6214, rows_per_coeff=401,
             form='float64')
    adj = dict(rows=1000, npix=2751, nm1=6214, form='float64')
    least_a = table['kernel_a']['work'].bound_s(**a)[0] \
        + table['kernel_a']['work'].bound_s(**s)[0]
    least_adj = table['kernel_a_adjoint']['work'].bound_s(**adj)[0]
    dt = StubTrace([
        ('void spline_rows_kernel<double>(...)', T0 + 1, T0 + 1.25),
        ('void spline_shared_kernel<double>(...)', T0 + 2, T0 + 2.5),
        ('void spline_adjoint_kernel<double>(...)', T0 + 3, T0 + 3.25),
        ('void ccf_chisq_f64_kernel(...)', T0 + 4, T0 + 5)])
    records([rec('kernel_a', 0.9, kind='event', **a),
             rec('kernel_a', 1.9, kind='event', **s),
             rec('kernel_a', 11.0, kind='event', **a),   # after the window
             rec('kernel_a_adjoint', 2.9, kind='event', **adj)])
    assert read('kernel_a_roofline', dt) == pytest.approx(
        100 * least_a / 0.75)
    assert read('kernel_a_adjoint_roofline', dt) == pytest.approx(
        100 * least_adj / 0.25)


def test_kernel_a_work_is_the_byte_model():
    work = spec.kernel_table()['kernel_a']['work']
    # 4000 rows of 1024 px in float64, each pixel its own interval:
    # 8 bytes in and out, 32 of coefficients a point
    s, by = work.bound_s(4000, 1024, 4095)
    assert by == 'bytes' and s == pytest.approx(4000 * 1024 * 48 / 3.35e12)
    assert work.bound_s(4000, 1024, 4095, form='float32')[0] == \
        pytest.approx(s / 2)
    assert work.intervals(401 * 3, 1024, 500, rows_per_coeff=401) == 1500
    adj = spec.kernel_table()['kernel_a_adjoint']['work']
    assert adj.bound_s(1000, 1024, 4095)[0] == pytest.approx(
        (2 * 8 * 1000 * 1024 + 32 * 1000 * 4095) / 3.35e12)


@pytest.mark.parametrize('name', NEW)
def test_none_outside_the_window_or_without_records(records, name):
    """Records outside the window, and no counters."""
    records([rec('fit.nm.round', 20.0, 21.0, width=5, iters=2,
                 live_iters=5),
             rec('driver.group', 20.0, 30.0, files=2, fibres=10),
             rec('driver.prep', 20.0, 21.0, fibres=10),
             rec('ccf.dispatch', 20.0, 21.0, fibres=10),
             rec('kernel_a', 20.0, kind='event', rows=1, npix=9, nm1=9),
             rec('kernel_a_adjoint', 20.0, kind='event', rows=1, npix=9,
                 nm1=9),
             rec('fit.nm.iter', 20.0, 20.1, live=5)])
    dt = StubTrace([('void spline_rows_kernel<double>', T0, T0 + 1),
                    ('void spline_adjoint_kernel<double>', T0, T0 + 1)])
    assert read(name, dt) is None
    assert read(name, None) is None


@pytest.mark.parametrize('name', NEW)
def test_none_from_a_program_without_the_tracer(monkeypatch, name):
    import rvspecfit_torch
    monkeypatch.delattr(rvspecfit_torch, 'trace')
    monkeypatch.setitem(sys.modules, 'rvspecfit_torch.trace', None)
    assert program_trace.records(StubTrace([])) is None
    assert program_trace.counters(StubTrace([])) is None
    assert read(name, StubTrace([('void spline_rows_kernel<double>', T0,
                                  T0 + 1)])) is None


def _exact_intervals_ms(u, nm1, rpc):
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.spline_bound_ms(u, nm1, rpc)


@pytest.mark.parametrize('arm', ['b', 'r', 'z'])
def test_kernel_a_shape_count_is_at_most_the_exact_one(arm):
    """On the desi_petal_norot arms and templates, queries at
    velocities within +-500 km/s: the shape count's bound is at most
    chip_smoke.spline_bound_ms's exact one, per row and shared."""
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, 'configs',
                                      'desi_petal_norot.json'))
    a = cfg['arms'][arm]
    t = cfg['templates']
    st = t['setups'][a['setup']]
    tl = generator.template_lam(st['lam0'], st['lam1'], t['step'],
                                t['deltav'])
    assert tl.size == t['npix'][a['setup']]
    lam = generator.arm_lam(a)
    nm1 = tl.size - 1
    lstep = math.log(tl[1] / tl[0])
    work = spec.kernel_table()['kernel_a']['work']
    rng = np.random.default_rng(7)
    for vels, rpc in ((rng.uniform(-500, 500, 64), 1),
                      (np.tile(np.linspace(-500, 500, 401), 3), 401)):
        beta = vels / generator.C_KMS
        dop = np.sqrt((1 + beta) / (1 - beta))
        u = (np.log(lam)[None, :] - np.log(dop)[:, None]
             - math.log(tl[0])) / lstep
        assert u.min() > 0 and u.max() < nm1
        exact = _exact_intervals_ms(torch.as_tensor(u), nm1, rpc)
        shape = 1e3 * work.bound_s(u.shape[0], u.shape[1], nm1, rpc)[0]
        assert shape <= exact * (1 + 1e-12), (arm, rpc)


def test_the_new_metrics_are_found_by_name():
    """The new per-layer metrics are entries of BENCHMARK.json for this
    cell, moving spectra_per_s, each read by its own file."""
    b = spec.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    entries = {m['name']: m for m in b['per_layer']}
    for n in NEW:
        assert entries[n]['workloads'] == [WORKLOAD]
        assert entries[n]['moves'] == 'spectra_per_s'
    cell = spec.Cell(WORKLOAD)
    found = [m['name'] for m in cell.metrics('per_layer')]
    assert set(NEW) <= set(found)
    for n in NEW:
        assert callable(cell.reader(n).read)
