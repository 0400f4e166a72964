"""The port's tracer (rvspecfit_torch/trace.py) on the CPU: it records
only while a torch profiler records, on every thread of the DESI
driver, with parents linked within each thread and stamps on the
profiler's clock; the main thread's spans reach the profiler's own
trace; the buffer is bounded; the counters and kept spans work without
a profiler; and tracing changes no result."""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rvspecfit_torch import trace, utils
from rvspecfit_torch.survey import desi

from test_torch_desi import write_coadd
from test_torch_overlap import SWITCHES, tail_inputs  # noqa: F401

PHASES = ('ccf', 'nm', 'polish', 'refine', 'hessian', 'models')


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('trace_coadds')
    out = []
    for k in range(4):
        path = str(root / f'coadd-t{k}.fits')
        write_coadd(path, 60 + k)
        out.append(path)
    return out


def _proc_many(files, outdir, lib, monkeypatch):
    """proc_many over 4 coadds at coalesce 2 with the overlaps on: the
    group fits' results (materialized) and the wall interval."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    fits = []
    real = desi._run_group_fit

    def run(*args, **kwargs):
        fits.append(real(*args, **kwargs))
        return fits[-1]
    monkeypatch.setattr(desi, '_run_group_fit', run)
    cfg = utils.read_config(None, {'template_lib': lib})
    desi.proc_many(files, str(outdir), config=cfg, options={'npoly': 5},
                   coalesce=2, device='cpu')
    return [dict(f.items()) for f in fits]


@pytest.fixture(scope='module')
def traced(files, desi_library, tmp_path_factory):
    """One run with no profiler and one under a CPU profiler started on
    the main thread: (fits off, fits on, spans, profiler stamps,
    annotation names)."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp('trace_runs')
    try:
        trace.clear()
        off = _proc_many(files, root / 'off', desi_library, mp)
        assert trace.spans() == []
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.__enter__()
        try:
            on = _proc_many(files, root / 'on', desi_library, mp)
        finally:
            t_stop = time.time_ns()
            prof.__exit__(None, None, None)
        res = prof.profiler.kineto_results
        names = {e.name() for e in res.events() if e.is_user_annotation()}
        recs = trace.spans()
        trace.clear()
    finally:
        mp.undo()
    return off, on, recs, (res.trace_start_ns(), t_stop), names


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_without_a_profiler_nothing_is_recorded_and_phases_stay(traced):
    off, _, _, _, _ = traced
    assert len(off) == 2
    for fit in off:
        assert tuple(fit['phases']) == PHASES
        assert all(v > 0 for v in fit['phases'].values())


def test_under_a_profiler_every_thread_records_its_spans(traced):
    _, on, recs, _, _ = traced
    assert len(on) == 2
    threads = lambda name: {r.thread.split('_')[0]  # noqa: E731
                            for r in _by_name(recs, name)}
    assert threads('driver.group') == {'MainThread'}
    assert len(_by_name(recs, 'driver.group')) == 2
    assert threads('fit.group') == threads('fit.nm.round') == {'MainThread'}
    assert threads('driver.prep_wait') == {'MainThread'}
    assert 'rvst-prep' in threads('driver.prep')
    # the first group's CCF is dispatched by its fit, the second's by
    # the prep thread
    assert threads('ccf.dispatch') == {'MainThread', 'rvst-prep'}
    assert threads('driver.read_wait') == {'rvst-prep'}
    assert threads('driver.read') == {'rvst-reader'}
    assert threads('fit.tail') == {'rvst-tail'}
    assert threads('driver.finish') == {'rvst-writer'}
    assert threads('driver.write') == {'rvst-writer'}
    assert threads('fit.nm.iter') == {'MainThread'}
    for r in _by_name(recs, 'fit.nm.round'):
        a = r.attrs
        assert a['iters'] > 0
        assert 0 < a['live_iters'] <= a['width'] * a['iters']
        # its iterations, each with the live fibres it began with
        its = [i for i in _by_name(recs, 'fit.nm.iter') if i.parent == r.id]
        assert len(its) == a['iters']
        assert sum(i.attrs['live'] for i in its) == a['live_iters']
    for r in _by_name(recs, 'driver.prep'):
        assert r.attrs['fibres'] == 8 and r.attrs['files'] == 2
    # the phases are the spans' seconds
    nm = _by_name(recs, 'fit.nm')
    assert sorted(f['phases']['nm'] for f in on) == \
        pytest.approx(sorted(r.seconds for r in nm), rel=1e-12)


def test_parents_link_within_each_thread(traced):
    _, _, recs, (t_start, t_stop), _ = traced
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert t_start <= r.t0 <= r.t1 <= t_stop, r
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.thread == r.thread
            assert p.t0 <= r.t0 and r.t1 <= p.t1
    parent = lambda r: by_id[r.parent].name  # noqa: E731
    assert {parent(r) for r in _by_name(recs, 'fit.nm.iter')} == \
        {'fit.nm.round'}
    assert {parent(r) for r in _by_name(recs, 'fit.nm.round')} == {'fit.nm'}
    assert {parent(r) for r in _by_name(recs, 'fit.nm')} == {'fit.group'}
    assert {parent(r) for r in _by_name(recs, 'fit.group')} == \
        {'driver.group'}
    assert {parent(r) for r in _by_name(recs, 'driver.prep_wait')} == \
        {'driver.group'}
    assert {(r.thread, parent(r)) for r in _by_name(recs, 'ccf.dispatch')} \
        == {('MainThread', 'fit.ccf_collect'), ('rvst-prep', 'driver.prep')}
    assert {parent(r) for r in _by_name(recs, 'driver.read_wait')} == \
        {'driver.prep'}
    assert {parent(r) for r in _by_name(recs, 'fit.polish')} == {'fit.tail'}
    assert {parent(r) for r in _by_name(recs, 'driver.write')} == \
        {'driver.finish'}


def test_main_thread_spans_are_profiler_annotations(traced):
    _, _, _, _, names = traced
    assert {'driver.group', 'fit.group', 'fit.nm', 'fit.nm.round',
            'driver.prep'} <= names
    # other threads' spans are the tracer's alone
    assert 'fit.tail' not in names and 'driver.finish' not in names


def test_tracing_changes_no_result(traced):
    off, on, _, _, _ = traced
    for a, b in zip(off, on):
        for k in ('params', 'errs', 'vsini'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a['nm']['x'], b['nm']['x'])
        np.testing.assert_array_equal(a['nm']['fun'], b['nm']['fun'])


def test_nm_optima_are_bit_equal_with_the_profiler_on(tail_inputs):  # noqa: F811
    make, pmap = tail_inputs['make'], tail_inputs['pmap']
    vel0 = np.zeros(make().nfibers)
    want = make().run_neldermead(pmap, vel0, nm_chunk=16, maxiter=64)
    with profile(activities=[ProfilerActivity.CPU]):
        got = make().run_neldermead(pmap, vel0, nm_chunk=16, maxiter=64)
    rounds = trace.spans('fit.nm.round')
    trace.clear()
    assert rounds and sum(r.attrs['iters'] for r in rounds) > 0
    for k in ('x', 'fun', 'converged'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['obj_evals'] == want['obj_evals']


def test_buffer_stays_at_its_bound():
    trace.clear()
    n = trace.MAX_RECORDS
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n + 10):
            trace.event('tick', i=i)
    recs = trace.spans()
    trace.clear()
    assert len(recs) == n
    assert recs[0].attrs['i'] == 10 and recs[-1].attrs['i'] == n + 9
    assert all(r.kind == 'event' and r.t0 == r.t1 for r in recs[:3])


def test_span_measures_seconds_and_records_nothing_off():
    trace.clear()
    with trace.span('outer', a=1) as sp:
        sp.set(b=2)
        trace.event('inside')
    assert sp.seconds >= 0 and sp.attrs == dict(a=1, b=2)
    assert trace.spans() == []


def test_span_open_when_the_profiler_stops_is_recorded():
    trace.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    with trace.span('across') as sp:
        torch.ones(3).sum()
        prof.__exit__(None, None, None)
    assert [r.name for r in trace.spans()] == ['across']
    assert trace.spans()[0].seconds == sp.seconds
    trace.clear()


def test_worker_thread_spans_are_recorded_with_their_thread():
    trace.clear()

    def work():
        with trace.span('job'):
            with trace.span('step'):
                pass
    with profile(activities=[ProfilerActivity.CPU]):
        th = threading.Thread(target=work, name='rvst-test')
        th.start()
        th.join()
    job, = trace.spans('job')
    step, = trace.spans('step')
    trace.clear()
    assert job.thread == step.thread == 'rvst-test'
    assert step.parent == job.id and job.parent is None


def test_counters_count_and_reset_without_a_profiler():
    trace.reset_counters('test.')
    for _ in range(3):
        trace.count('test.a')
    trace.count('test.b', 5)
    assert trace.counters('test.') == {'test.a': 3, 'test.b': 5}
    trace.reset_counters('test.a')
    assert trace.counters('test.') == {'test.b': 5}
    trace.reset_counters('test.')
    assert trace.counters('test.') == {}


def test_spans_total_their_nanoseconds_without_a_profiler():
    trace.reset_counters('test.total')
    secs = []
    for _ in range(3):
        with trace.span('test.total') as sp:
            time.sleep(0.001)
        secs.append(sp.seconds)
    ns = trace.counters('test.total')['test.total.ns']
    assert ns == pytest.approx(1e9 * sum(secs), abs=3)
    assert ns >= 3_000_000 and trace.spans() == []


def test_nm_counts_its_tile_work_without_a_profiler(tail_inputs):  # noqa: F811
    make, pmap = tail_inputs['make'], tail_inputs['pmap']
    trace.reset_counters('fit.nm.')
    res = make().run_neldermead(pmap, np.zeros(make().nfibers), nm_chunk=16,
                                maxiter=64)
    c = trace.counters('fit.nm.')
    assert trace.spans() == []
    assert 0 < c['fit.nm.live_iters'] <= c['fit.nm.tile_iters']
    assert c['fit.nm.iter.ns'] > 0 and c['fit.nm.round.ns'] > 0
    assert res['obj_evals'] > 0


def test_kept_spans_are_kept_without_a_profiler():
    with trace.span('test.kept', keep=True, kernel='k') as sp:
        sp.set(ptxas='0 registers')
    rec = trace.kept('test.kept')[-1]
    assert rec.attrs == dict(kernel='k', ptxas='0 registers')
    assert rec.seconds == sp.seconds
    assert trace.spans() == []


def test_threads_lose_no_count_and_no_record():
    """16 threads (more than the cores) count and record at once, with
    the interpreter switching threads as often as it can."""
    trace.reset_counters('stress.')
    trace.clear()
    nthreads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n):
                trace.count('stress.n')
                with trace.span('stress.span', k=k):
                    trace.event('stress.event', i=i)
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(nthreads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    recs = trace.spans()
    trace.clear()
    assert trace.counters('stress.n') == {'stress.n': nthreads * n}
    assert trace.counters('stress.span.ns')['stress.span.ns'] >= 0
    assert len(recs) == 2 * nthreads * n
    spans = {r.id: r for r in recs if r.kind == 'span'}
    assert len(spans) == nthreads * n
    # every event's parent is its own thread's span
    for r in recs:
        if r.kind == 'event':
            assert spans[r.parent].thread == r.thread
