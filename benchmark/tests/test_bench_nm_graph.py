"""The reader of fit.nm_graph_pct: the share of Nelder-Mead's objective
calls that CUDA graph replays served, from the program's whole-run
counters; None from a program without those counters; and its entry in
BENCHMARK.json."""
import os

import pytest

from benchlib import spec
from conftest import ROOT

from rvspecfit_torch import trace

NAME = 'fit.nm_graph_pct'
WORKLOAD = 'desi_petal_norot.tile500'


class StubTrace:
    t0, t1, events = 1.8e9, 1.8e9 + 10.0, []


def _read(monkeypatch, counts, dtrace=StubTrace()):
    monkeypatch.setattr(trace, 'counters',
                        lambda prefix='': dict(counts))
    return spec.load_module(os.path.join(
        spec.BENCH_DIR, 'metrics', NAME + '.py')).read(None, None, dtrace)


@pytest.mark.parametrize('scheme,ncand', [('scan2', 2), ('cand4', 4)])
def test_replays_serve_ncand_calls_each(monkeypatch, scheme, ncand):
    monkeypatch.setenv('RVST_NM_SCHEME', scheme)
    counts = {'fit.nm.graph_replays': 990, 'fit.nm.eager_calls': 20,
              'fit.nm.graph_captures': 3, 'fit.nm.tile_iters': 5}
    assert _read(monkeypatch, counts) == pytest.approx(
        100 * 990 * ncand / (990 * ncand + 20))
    counts.pop('fit.nm.eager_calls')
    assert _read(monkeypatch, counts) == 100.0
    # eager calls alone: NM ran without a graph
    assert _read(monkeypatch, {'fit.nm.eager_calls': 7}) == 0.0


@pytest.mark.parametrize('counts', [
    {}, {'fit.nm.tile_iters': 38800, 'fit.nm.live_iters': 20800},
    {'fit.nm.graph_replays': 0, 'fit.nm.eager_calls': 0}])
def test_none_without_the_counters(monkeypatch, counts):
    """The parent's program counts neither (the CPU's neither)."""
    assert _read(monkeypatch, counts) is None


def test_none_without_a_device_trace(monkeypatch):
    assert _read(monkeypatch, {'fit.nm.graph_replays': 5}, None) is None


def test_the_entry_is_found_by_name():
    b = spec.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    entry = [m for m in b['per_layer'] if m['name'] == NAME]
    assert entry == [dict(name=NAME, unit='%', better='higher',
                          source='program_counter', layer='group fit',
                          moves='spectra_per_s', workloads=[WORKLOAD])]
    cell = spec.Cell(WORKLOAD)
    assert NAME in [m['name'] for m in cell.metrics('per_layer')]
    assert callable(cell.reader(NAME).read)
