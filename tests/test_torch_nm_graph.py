"""Nelder-Mead's padded tiles and its graph's split step on the CPU
(fit/nm_graph.py): the reference's ladder of tile widths, padded tiles
against unpadded ones, the graph's iteration with its shrink done apart
against neldermead._step, the tracer's held counts and events, and the
graph counters, which stay zero on the CPU.  The graphs themselves are
tested on the card (tests/test_torch_kernels_cuda.py)."""
import numpy as np
import pytest
import torch

import synth
from rvspecfit_torch import convert, trace
from rvspecfit_torch.fit import neldermead as nm
from rvspecfit_torch.fit import nm_graph, vel_fit
from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
from rvspecfit_tpu.interp.api import TemplateModel
from rvspecfit_tpu.interp.grid import GridInterpState
from rvspecfit_tpu.ops.spline import SplineGeometry

SCHEMES = ['scan2', 'cand4']
CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2, second_minimizer=False)
NFIB = 5
FATOL = 5e-2


def _reference_tiles(idx, mb):
    """rvspecfit_tpu/fit/batch.py's ladder and tiles_of, as written
    there (numpy): [(sel, sel_p)]."""
    ladder = sorted({mb} | {w for w in (mb // 2, mb // 4)
                            if w >= 32}, reverse=True)
    u = idx.size
    w, best_cost = mb, None
    for cand in ladder:
        ntiles = -(-u // cand)
        cost = ntiles * cand + 0.25 * mb * (ntiles - 1)
        if best_cost is None or cost < best_cost:
            best_cost, w = cost, cand
    out = []
    for lo in range(0, u, w):
        sel = idx[lo:lo + w]
        sel_p = sel if sel.size == w else np.concatenate(
            [sel, np.repeat(sel[-1:], w - sel.size)])
        out.append((sel, sel_p))
    return ladder, out


@pytest.mark.parametrize('mb,u', [
    (500, 1000), (500, 999), (500, 501), (500, 300), (500, 260),
    (500, 250), (500, 200), (500, 126), (500, 125), (500, 100), (500, 1),
    (100, 70), (100, 30), (127, 40), (64, 17), (8, 8), (8, 3), (1, 1)])
def test_ladder_and_tiles_follow_the_reference_rule(mb, u):
    """At fit_microbatch 500 the widths are 500, 250 and 125; every
    tiling is the reference's, fiber for fiber, pads included."""
    if mb == 500:
        assert nm_graph.ladder(mb) == [500, 250, 125]
    idx = np.random.RandomState(u).permutation(2 * u)[:u]
    ladder, want = _reference_tiles(idx, mb)
    assert nm_graph.ladder(mb) == ladder
    got = nm_graph.tiles(torch.as_tensor(idx), nm_graph.ladder(mb))
    assert len(got) == len(want)
    for (sel, n), (ref, ref_p) in zip(got, want):
        assert n == ref.size
        np.testing.assert_array_equal(sel.numpy(), ref_p)


@pytest.mark.parametrize('mb', [None, 500, 100])
@pytest.mark.parametrize('b', [1, 5, 32, 64, 65, 128, 129, 200, 256, 257,
                               499, 500, 501, 1000, 4000])
def test_top_width_rounds_the_group_as_the_reference(b, mb):
    """The widest tile is the microbatch, or else the reference's
    rounding of a group of ``b`` fibers (rvspecfit_tpu/survey/desi.py's
    fit_microbatch: the first of 64, 128, 256 and 500 that holds the
    group, else 500), so that every group size lands on one of four
    ladders."""
    want = mb
    if want is None:
        for want in (64, 128, 256, 500):
            if want >= b:
                break
    assert nm_graph.top_width(b, mb) == want
    assert nm_graph.ladder(nm_graph.top_width(b)) in (
        [64, 32], [128, 64, 32], [256, 128, 64], [500, 250, 125])


@pytest.fixture(scope='module')
def toy():
    """A 4x4x3x2 grid at 512 px and NFIB fibers of 300 px, with its
    mapper (as tests/test_torch_nm_scheme.py)."""
    lam, uvecs, idgrid, vecs, specs, parnames = synth.make_template_grid(
        4, 4, 3, 2, npix=512)
    state = GridInterpState.build(uvecs, idgrid, vecs, specs,
                                  log_spec=True)
    geom = SplineGeometry.from_knots(lam, log_step=True)
    tm = convert.template_model(
        TemplateModel(kind='grid', state=state, geom=geom,
                      parnames=parnames, log_ids=(0,)), device='cpu')
    rng = np.random.RandomState(5)
    dlam = np.linspace(4600, 5400, 300)
    flux = np.zeros((NFIB, dlam.size))
    ivar = np.zeros((NFIB, dlam.size))
    for i in range(NFIB):
        _, spec, espec = synth.observed_spectrum(
            rng.uniform(-200, 200), rng.uniform(5000, 7000), 3.0, -1.0,
            0.5, npix=dlam.size, snr=30.0, seed=60 + i)
        flux[i] = spec
        ivar[i] = 1.0 / espec**2
    arms = [BatchArm('config1', dlam, flux, ivar)]
    mapper = vel_fit.ParamMapper(
        tm.parnames, dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5),
        [], None, False)
    return arms, {'config1': tm}, mapper


def _fitter(toy, fibers=None):
    arms, templates, _ = toy
    if fibers is not None:
        arms = [BatchArm(a.name, a.lam, a.flux[fibers], a.ivar[fibers])
                for a in arms]
    return BatchedFitter(arms, templates, CONFIG, options={'npoly': 5})


def _start(bf, mapper):
    """Set-up simplexes, values and mask of every fiber, and xatol."""
    x0 = np.tile(mapper.start_vector(0.0), (bf.nfibers, 1))
    scales = mapper.scales()
    simplex = torch.as_tensor(nm.build_simplex(x0, scales,
                                               vel_fit.SIMPLEX_SEED))
    xatol = torch.as_tensor(scales * 0.08)
    fun = bf._objective(mapper, None, torch.arange(bf.nfibers))
    fvals, done = nm.nm_init(fun, simplex, FATOL, xatol)
    return simplex, fvals, done, xatol


@pytest.mark.parametrize('scheme', SCHEMES)
def test_padded_tile_gives_the_unpadded_result(toy, scheme):
    """Fibers 1..3 as a tile of 3, and as a tile of 8 padded with
    converged copies of fiber 3: the same 40 iterations of every real
    fiber in float64, and the pad rows unmoved."""
    bf = _fitter(toy)
    mapper = toy[2]
    simplex, fvals, done, xatol = _start(bf, mapper)
    real = torch.arange(1, 4)
    (sel, n), = nm_graph.tiles(real, [8])
    assert n == 3 and sel.tolist() == [1, 2, 3, 3, 3, 3, 3, 3]
    want = nm.nm_chunk(bf._objective(mapper, None, real), simplex[real],
                       fvals[real], done[real], FATOL, xatol, 40, scheme)
    pad_done = done[sel]
    pad_done[n:] = True
    got = nm.nm_chunk(bf._objective(mapper, None, sel), simplex[sel],
                      fvals[sel], pad_done, FATOL, xatol, 40, scheme)
    assert want[3] == got[3] > 0
    for w, g in zip(want[:3], got[:3]):
        torch.testing.assert_close(g[:n], w, rtol=1e-13, atol=0)
    torch.testing.assert_close(got[0][n:], simplex[sel[n:]], rtol=0, atol=0)
    torch.testing.assert_close(got[1][n:], fvals[sel[n:]], rtol=0, atol=0)


def test_groups_padded_to_the_ladder_give_each_fibers_own_result(toy):
    """run_neldermead on NFIB fibers (tiles of 32, padded with copies
    of their last fiber) gives every fiber what it gets alone (a tile of
    32 as well, 31 of its rows pads): no pad row is written back over a
    real one."""
    mapper = toy[2]
    together = _fitter(toy).run_neldermead(mapper, np.zeros(NFIB),
                                           maxiter=96, maxrestart=2,
                                           nm_chunk=16)
    for i in range(NFIB):
        alone = _fitter(toy, [i]).run_neldermead(mapper, np.zeros(1),
                                                 maxiter=96, maxrestart=2,
                                                 nm_chunk=16)
        np.testing.assert_allclose(together['x'][i], alone['x'][0],
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(together['fun'][i], alone['fun'][0],
                                   rtol=1e-13)
        assert together['converged'][i] == alone['converged'][0]


@pytest.mark.parametrize('scheme', SCHEMES)
@pytest.mark.parametrize('shrink', [False, True])
def test_split_step_takes_the_steps_decisions(toy, scheme, shrink):
    """The graph's iteration (IterationGraph._body, here run eagerly on
    the CPU) and, where its flags say a live fiber shrinks, the shrink
    redone apart (IterationGraph.shrink) give neldermead._step's
    simplexes, values and mask exactly, on a padded tile of 8; with
    ``shrink`` two fibers' stored values are lowered by 1e6, so that no
    candidate beats their worst vertex and they shrink."""
    bf = _fitter(toy)
    mapper = toy[2]
    simplex, fvals, done, xatol = _start(bf, mapper)
    kw = bf._objective_kw()
    from rvspecfit_torch.fit.batch import trial_objective
    g = nm_graph.IterationGraph(
        8, bf.arms, lambda arms: nm.in_working_dtype(trial_objective(
            arms, mapper, None, **kw), bf.dtype),
        mapper.nvec, scheme, FATOL)
    (sel, n), = nm_graph.tiles(torch.arange(NFIB), [8])
    g.load(bf.arms, sel, n, simplex, fvals, done, xatol)
    assert not g.state[2][:n].any() and g.state[2][n:].all()
    if shrink:
        g.state[1][[0, 3]] -= 1e6
    for _ in range(3):
        want = nm._step(g.fun, *[t.clone() for t in g.state], FATOL,
                        g.xatol, scheme)
        g._body(g.state, g.saved, g.proposed, g.flags)
        live_shrink, live = g.flags.tolist()
        if shrink:
            assert live_shrink == 1 and g.proposed[2][[0, 3]].all()
        if live_shrink:
            live = g.shrink()
        for w, got in zip(want, g.state):
            assert torch.equal(got, w)
        assert live == int((~want[2]).sum())
        shrink = False


@pytest.mark.parametrize('corrupt', [False, True])
def test_check_holds_replayed_answers_to_the_eager_objective(toy,
                                                             corrupt):
    """BatchedFitter.check_neldermead evaluates the objective at NM's
    optima, once, on every device; where NM replayed graphs it passes on
    the values NM found, and raises where one is not the objective's
    there (raised by 1e-6 of itself, above the square root of float64's
    unit roundoff); an eager NM's answer (the CPU's) is not compared."""
    bf = _fitter(toy)
    mapper = toy[2]
    res = bf.run_neldermead(mapper, np.zeros(NFIB), maxiter=16,
                            maxrestart=1)
    assert res['replayed'] is False
    calls = []
    real = bf._objective_arms
    bf._objective_arms = lambda *a: calls.append(1) or real(*a)
    bf.check_neldermead(mapper, res)
    assert calls == [1]
    calls.clear()
    res = dict(res, replayed=True)
    if corrupt:
        res['fun'] = res['fun'].copy()
        res['fun'][3] *= 1 + 1e-6
        with pytest.raises(RuntimeError, match='fiber 3'):
            bf.check_neldermead(mapper, res)
    else:
        bf.check_neldermead(mapper, res)
    assert calls == [1]


def test_groups_of_any_size_share_one_ladder(toy, monkeypatch):
    """Without a microbatch, groups of 2, 3 and NFIB fibers tile NM's
    rounds at the one ladder [64, 32] (so on the card they replay the
    same graphs)."""
    seen = []
    real = nm_graph.tiles

    def tiles(idx, widths):
        seen.append(list(widths))
        return real(idx, widths)
    monkeypatch.setattr(nm_graph, 'tiles', tiles)
    for fibers in ([0, 1], [1, 2, 4], None):
        seen.clear()
        bf = _fitter(toy, fibers)
        assert bf.microbatch is None
        bf.run_neldermead(toy[2], np.zeros(bf.nfibers), maxiter=8,
                          maxrestart=1, nm_chunk=4)
        assert seen and all(w == [64, 32] for w in seen)


def test_new_counters_stay_zero_on_the_cpu(toy):
    """On the CPU NM runs eagerly and counts no graph work: no
    captures, replays or eager calls (the set-ups are eager by nature
    there); the tile work counts the pad rows."""
    trace.reset_counters('fit.nm.')
    res = _fitter(toy).run_neldermead(toy[2], np.zeros(NFIB), maxiter=32,
                                      maxrestart=1, nm_chunk=8)
    c = trace.counters('fit.nm.')
    for name in ('graph_captures', 'graph_replays', 'eager_calls'):
        assert c.get(f'fit.nm.{name}', 0) == 0
    assert c['fit.nm.tile_iters'] % 32 == 0
    assert c['fit.nm.live_iters'] <= c['fit.nm.tile_iters']
    assert res['obj_evals'] == NFIB * (toy[2].nvec + 1) \
        + 2 * c['fit.nm.tile_iters']


def test_deferred_counts_and_events_are_replayed():
    """trace.deferred holds a thread's counts and events in order (the
    events whether a profiler records or not); trace.replay applies
    them, the events only while a profiler records."""
    trace.reset_counters('test.deferred')
    with trace.deferred() as held:
        trace.count('test.deferred.a', 2)
        trace.event('test.deferred.ev', rows=3)
    assert held == [('count', 'test.deferred.a', 2),
                    ('event', 'test.deferred.ev', {'rows': 3})]
    assert trace.counters('test.deferred') == {}
    trace.count('test.deferred.b')
    assert trace.counters('test.deferred') == {'test.deferred.b': 1}
    trace.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        trace.replay(held)
        trace.replay(held)
    assert trace.counters('test.deferred.a') == {'test.deferred.a': 4}
    evs = trace.spans('test.deferred.ev')
    assert [e.attrs for e in evs] == [{'rows': 3}] * 2
    trace.replay(held)
    assert len(trace.spans('test.deferred.ev')) == 2
