"""Fiber sharding of the port's BatchedFitter (rvspecfit_torch/parallel/
mesh.py), the cases of tests/test_mesh.py on a mesh of the CPU named
twice: every stage of a sharded fitter equals the unsharded one, fiber
by fiber, with an uneven split (5 fibers over 2 shards) and with
fit_microbatch tiles inside the shards; auto_shard does nothing on one
device, under a multi-process world or with RVST_NO_MESH=1; and every
shard's thread enters its device first; a sharded group fit's
deferred tail runs on the shards' threads after the driver has let the
fitter go."""
import gc
import threading

import numpy as np
import pytest
import torch

from rvspecfit_tpu import simulation as rsim
from rvspecfit_torch import convert
from rvspecfit_torch import device as device_mod
from rvspecfit_torch.fit import batch, vel_fit
from rvspecfit_torch.parallel import distributed
from rvspecfit_torch.parallel import mesh as pmesh
from rvspecfit_torch.pipeline import library
from rvspecfit_torch.survey import desi

from test_torch_tail import CONFIG, START, _desi_group

NFIB = 5
MESH = ('cpu', 'cpu')
# shards are tiles of the whole fit's fibers: the CPU's float64
# arithmetic is the same up to the summation order of batched products
RTOL = 1e-9


@pytest.fixture(scope='module')
def setup():
    """5 fibers x 3 arms x 100 px on a 3x3x3x2 grid, the mapper and NM
    starts near the truth."""
    rtm = rsim.build_template_model(3, 3, 3, 2, npix=512)
    arms_data, truth = rsim.make_exposure(NFIB, npix_arm=100, seed=7)
    tm = convert.template_model(rtm, device='cpu')
    arms = [batch.BatchArm(n, *a) for n, a in arms_data.items()]
    pmap = vel_fit.ParamMapper(tm.parnames, START, [], None, False)
    x0 = np.tile(pmap.start_vector(0.0), (NFIB, 1))
    x0[:, 0] = truth['vel'] + 5.0
    return dict(arms=arms, templates={n: tm for n in arms_data},
                pmap=pmap, x0=x0, truth=truth, parnames=tm.parnames)


def _fitter(setup, mesh=None, microbatch=None):
    bf = batch.BatchedFitter(setup['arms'], setup['templates'], CONFIG,
                             options={'npoly': 5}, microbatch=microbatch)
    if mesh is not None:
        pmesh.shard_fitter(bf, pmesh.make_mesh(mesh))
    return bf


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_sharded_chisq_matches_unsharded(setup):
    bf, sh = _fitter(setup), _fitter(setup, MESH)
    assert [(s.fiber_lo, s.nfibers) for s in sh.shards] == [(0, 3), (3, 2)]
    assert sh.nfibers == NFIB and all(s.device == torch.device('cpu')
                                      for s in sh.shards)
    par = np.tile([6000.0, 3.0, -1.0, 0.5], (NFIB, 4, 1))
    vels = np.tile(np.linspace(-300, 300, 4), (NFIB, 1))
    want = bf.chisq(vels, par).numpy()
    _close(sh.chisq(vels, par).numpy(), want)
    v_s, p_s, w_s = pmesh.shard_trials(sh, vels, par)
    assert w_s is None and v_s.dtype == torch.float64
    _close(sh.chisq(v_s, p_s).numpy(), want)


@pytest.mark.parametrize('microbatch', [None, 2])
def test_sharded_neldermead_matches_unsharded(setup, microbatch):
    """The batched NM (straggler compaction per shard) gives the same
    optima through the shards, also with microbatch tiles inside
    them; the objective trials add up."""
    kw = dict(x0=setup['x0'], nm_chunk=32, maxiter=256)
    want = _fitter(setup).run_neldermead(setup['pmap'], **kw)
    got = _fitter(setup, MESH, microbatch).run_neldermead(setup['pmap'],
                                                          **kw)
    _close(got['x'], want['x'])
    np.testing.assert_array_equal(got['converged'], want['converged'])
    assert got['obj_evals'] > NFIB * (want['x'].shape[1] + 1)


def test_sharded_scan_and_refine(setup):
    bf, sh = _fitter(setup), _fitter(setup, MESH)
    params = np.tile([6000.0, 3.0, -1.0, 0.5], (NFIB, 1))
    grid = np.arange(-1000, 1000, 5.0)
    want = bf.scan_velocities(grid, params)
    got = sh.scan_velocities(grid, params)
    for k in want:
        _close(got[k], want[k])
    grids = np.tile(np.arange(-300, 300, 10.0), (NFIB, 1))
    _close(sh.scan_chisq(grids, params, vchunk=16),
           bf.scan_chisq(grids, params))
    ok = np.abs(got['best_vel'] - setup['truth']['vel']) < 50
    assert ok.sum() >= NFIB - 1
    ref_w = bf.refine_velocities(want['best_vel'], params)
    ref_g = sh.refine_velocities(want['best_vel'], params)
    for k in ('best_vel', 'vel_err', 'best_chi', 'skewness', 'kurtosis'):
        _close(ref_g[k], ref_w[k])


def test_sharded_polish_and_hessian_match_unsharded(setup):
    """Gradient polish, AD Hessian errors, models and the whole tail
    through the shards (uneven: 3 + 2 fibers)."""
    bf, sh = _fitter(setup), _fitter(setup, MESH)
    pmap, x0 = setup['pmap'], setup['x0']
    pol_w, pol_g = bf.run_polish(pmap, x0, steps=2), sh.run_polish(
        pmap, x0, steps=2)
    for k in ('x', 'fun'):
        _close(pol_g[k], pol_w[k])
    np.testing.assert_array_equal(pol_g['moved'], pol_w['moved'])
    vel, par, _ = pmap.unpack_host(pol_w['x'])
    names = list(setup['parnames'])
    err_w, cov_w, bad_w = bf.hessian_errors(vel, par, parnames=names)
    err_g, cov_g, bad_g = sh.hessian_errors(vel, par, parnames=names)
    _close(err_g, err_w)
    _close(cov_g, cov_w)
    np.testing.assert_array_equal(bad_g, bad_w)
    tail_w = bf.run_tail(pmap, x0, parnames=names)
    tail_g = sh.run_tail(pmap, x0, parnames=names)
    for k in ('x', 'params', 'errs'):
        _close(tail_g[k], tail_w[k])
    for name, m in tail_w['mods']['models'].items():
        _close(tail_g['mods']['models'][name], m)
        _close(tail_g['mods']['chisq'][name], tail_w['mods']['chisq'][name])


def test_auto_shard(setup, monkeypatch):
    """auto_shard: None on one device and with RVST_NO_MESH=1, a mesh
    over the devices it is given; its default devices are every card of
    the host, or the rank's one card under a multi-process world."""
    bf = _fitter(setup)
    assert pmesh.auto_shard(bf) is None and bf.shards is None
    monkeypatch.setenv('RVST_NO_MESH', '1')
    assert pmesh.auto_shard(bf, devices=list(MESH)) is None
    assert bf.shards is None
    monkeypatch.delenv('RVST_NO_MESH')
    mesh = pmesh.auto_shard(bf, devices=list(MESH))
    assert mesh == (torch.device('cpu'),) * 2 and len(bf.shards) == 2
    with pytest.raises(ValueError, match='already sharded'):
        pmesh.shard_fitter(bf, mesh)

    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    monkeypatch.setattr(distributed, 'local_rank', lambda: None)
    assert pmesh.local_devices('cuda:1') == [torch.device('cuda', i)
                                             for i in range(4)]
    assert pmesh.local_devices('cpu') == [torch.device('cpu')]
    monkeypatch.setattr(distributed, 'local_rank', lambda: 1)
    assert pmesh.local_devices('cuda:1') == [torch.device('cuda', 1)]
    assert pmesh.shard_bounds(10, 8) == [(0, 2), (2, 4), (4, 5), (5, 6),
                                         (6, 7), (7, 8), (8, 9), (9, 10)]


def test_deferred_tail_of_a_sharded_group_fit(desi_library, monkeypatch):
    """survey/desi._run_group_fit with the tail deferred (the drivers'
    default) and the fitter sharded over the mesh: the driver drops the
    fitter when it returns, and the tail, started only after that, still
    runs on the shards' threads and gives the unsharded fit; the
    threads end once the tail's fit is dropped too."""
    cfg = dict(CONFIG, second_minimizer=True, template_lib=desi_library)
    data, _ = _desi_group()
    templates = {s: library.load_template_model(s, cfg, device='cpu')
                 for s in data}
    arms = [batch.BatchArm(s, *d, setup=s) for s, d in data.items()]
    want = desi._run_group_fit(arms, templates, cfg, {'npoly': 5},
                               defer=False)

    gate, pools = threading.Event(), []
    real_tail, real_shard = batch.BatchedFitter.run_tail, pmesh.auto_shard

    def gated(self, *args, **kwargs):
        assert gate.wait(60)
        return real_tail(self, *args, **kwargs)

    def shard(bf):
        mesh = real_shard(bf, devices=list(MESH))
        pools.extend(bf.shard_pools)
        return mesh
    monkeypatch.setattr(batch.BatchedFitter, 'run_tail', gated)
    monkeypatch.setattr(desi.pmesh, 'auto_shard', shard)
    lazy = desi._run_group_fit(arms, templates, cfg, {'npoly': 5},
                               defer=True)
    assert isinstance(lazy, desi._LazyFit) and len(pools) == 2
    gc.collect()
    gate.set()
    got = lazy.materialize()
    for k in ('params', 'errs', 'x'):
        _close(got[k], want[k])
    _close(got['ref']['best_vel'], want['ref']['best_vel'])
    np.testing.assert_array_equal(got['bad_hess'], want['bad_hess'])
    for name, m in want['mods']['models'].items():
        _close(got['mods']['models'][name], m)
    del lazy, got
    gc.collect()
    assert all(p._shutdown for p in pools)


def test_shard_threads_enter_their_device_first(setup, monkeypatch):
    """Each shard's host thread runs device.enter_device on its device
    before any work, and enter_device sets a CUDA device as the
    thread's current one (torch.cuda.set_device mocked)."""
    entered, worked = [], []
    monkeypatch.setattr(pmesh, 'enter_device', lambda d: entered.append(
        (threading.current_thread().name, torch.device(d))))
    sh = _fitter(setup, MESH)
    real = batch.BatchedFitter.chisq

    def chisq(self, *args, **kwargs):
        if self.shards is None:
            worked.append(threading.current_thread().name)
        return real(self, *args, **kwargs)
    monkeypatch.setattr(batch.BatchedFitter, 'chisq', chisq)
    par = np.tile([6000.0, 3.0, -1.0, 0.5], (NFIB, 1, 1))
    sh.chisq(np.zeros((NFIB, 1)), par)
    assert sorted(worked) == sorted(n for n, _ in entered)
    assert len(set(worked)) == 2 and all(
        d == torch.device('cpu') for _, d in entered)

    calls = []
    monkeypatch.setattr(torch.cuda, 'set_device', calls.append)
    t = threading.Thread(target=device_mod.enter_device, args=('cuda:1',))
    t.start()
    t.join()
    device_mod.enter_device('cpu')
    assert calls == [torch.device('cuda', 1)]


def test_model_on_moves_a_template_model_once(setup):
    """A shard's template model on another device: every tensor moved,
    made once per model and device (the library cache), the model
    itself where it already is; modules are copied and moved, the
    original left where it was."""
    from rvspecfit_torch.device import map_tensors
    from rvspecfit_torch.pipeline import library
    tm = next(iter(setup['templates'].values()))
    assert library.model_on(tm, 'cpu') is tm
    meta = library.model_on(tm, 'meta')
    assert library.model_on(tm, torch.device('meta')) is meta
    assert meta.geom.h.device.type == 'meta' and meta.parnames == \
        tm.parnames and meta.state.dats.device.type == 'meta'
    assert all(t.device.type == 'meta' for t in meta.state.uvecs
               if isinstance(t, torch.Tensor))
    assert tm.state.dats.device.type == 'cpu'
    lin = torch.nn.Linear(3, 2)
    moved = map_tensors((lin, [lin.weight]), lambda t: t.to('meta'))
    assert moved[0].weight.device.type == 'meta'
    assert lin.weight.device.type == 'cpu' and moved[1][0] is lin.weight
    library.clear_cache()
