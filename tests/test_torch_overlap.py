"""The drivers' overlaps in the port, on the CPU (rvspecfit_torch/
survey/desi.proc_many, survey/weave.proc_many, fit/ccf.fit_batch_async,
fit/batch.BatchedFitter.run_tail_async, device.Background): each
equals the serial path; the deferred tail owns its arms; a tail error
gives the serial per-file retry; a failed write raises through the
writer; a queue is never read ahead; every worker thread enters its
device first; and the kernel libraries build once when two threads
ask at once.  The DESI cases mirror tests/test_desi.py's
test_desi_pipeline_prep_matches_serial and
test_desi_defer_tail_matches_sync."""
import os
import subprocess
import threading
import types

import numpy as np
import pytest
import torch

from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.survey import desi as rdesi
from rvspecfit_torch import convert, utils
from rvspecfit_torch import device as device_mod
from rvspecfit_torch.fit import batch, ccf, vel_fit
from rvspecfit_torch.io import fitsio
from rvspecfit_torch.ops import cuda_build
from rvspecfit_torch.pipeline import library
from rvspecfit_torch.survey import desi, weave

from test_torch_desi import NFIB, write_coadd
from test_torch_tail import CONFIG, START, _desi_group
from test_torch_weave import write_pair

SWITCHES = ('RVST_PIPELINE_PREP', 'RVST_DEFER_TAIL', 'RVST_ASYNC_WRITE')
NSEL = NFIB - 1        # write_coadd masks its last fiber


def _serial(monkeypatch, on=False):
    for k in SWITCHES:
        if on:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, '0')


def _status(path):
    with open(path) as fp:
        return [ln.split() for ln in fp.read().strip().splitlines()]


def _same_outputs(got_dir, want_dir, bases, atol=1e-8):
    """RVTAB columns and RVMOD models of each file equal (atol)."""
    for base in bases:
        got = fitsio.read(os.path.join(got_dir, f'rvtab-{base}.fits'))
        want = fitsio.read(os.path.join(want_dir, f'rvtab-{base}.fits'))
        g, w = got['RVTAB'].data, want['RVTAB'].data
        assert list(g) == list(w)
        for k in w:
            if w[k].dtype.kind in 'fc':
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                           err_msg=f'{base}:{k}')
            else:
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f'{base}:{k}')
        gm = fitsio.read(os.path.join(got_dir, f'rvmod-{base}.fits'))
        wm = fitsio.read(os.path.join(want_dir, f'rvmod-{base}.fits'))
        for s in ('B', 'R', 'Z'):
            np.testing.assert_allclose(
                np.asarray(gm[f'{s}_MODEL'].data, float),
                np.asarray(wm[f'{s}_MODEL'].data, float), rtol=0,
                atol=atol, err_msg=f'{base}:{s}')


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('overlap_coadds')
    out = []
    for k in range(4):
        path = str(root / f'coadd-o{k}.fits')
        write_coadd(path, 40 + k)
        out.append(path)
    return out


def _run(files, outdir, lib, status=None, coalesce=2, **kw):
    cfg = utils.read_config(None, {'template_lib': lib})
    desi.proc_many(files, str(outdir), config=cfg, options={'npoly': 5},
                   status_fname=status, coalesce=coalesce, device='cpu',
                   **kw)


# ------------------------------------------------------------------
# fit_batch_async and run_tail_async

def test_fit_batch_async_equals_fit_batch(desi_library):
    cfg = dict(CONFIG, template_lib=desi_library)
    data, _ = _desi_group()
    arms = desi._ccf_args([batch.BatchArm(s, *d, setup=s)
                           for s, d in data.items()])
    want = ccf.fit_batch(arms, cfg, device='cpu')
    collect = ccf.fit_batch_async(arms, cfg, device='cpu')
    for got in (collect(), collect()):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope='module')
def tail_inputs():
    """5 fibers x 3 arms x 100 px on a 3x3x3x2 grid, and their NM
    optima; ``make()`` builds a fitter on copies of the arrays."""
    rtm = rsim.build_template_model(3, 3, 3, 2, npix=512)
    arms_data, truth = rsim.make_exposure(NFIB, npix_arm=100, seed=9)
    tm = convert.template_model(rtm, device='cpu')
    make = lambda: batch.BatchedFitter(  # noqa: E731
        [batch.BatchArm(n, lam, fl.copy(), iv.copy())
         for n, (lam, fl, iv) in arms_data.items()],
        {n: tm for n in arms_data}, CONFIG, options={'npoly': 5})
    pmap = vel_fit.ParamMapper(tm.parnames, START, [], None, False)
    x0 = np.tile(pmap.start_vector(0.0), (NFIB, 1))
    x0[:, 0] = truth['vel'] + 5.0
    nmres = make().run_neldermead(pmap, x0=x0, nm_chunk=32, maxiter=128)
    kw = dict(fun=nmres['fun'], parnames=list(tm.parnames), polish=True)
    want = make().run_tail(pmap, nmres['x'], **kw)
    return dict(make=make, pmap=pmap, x=nmres['x'], kw=kw, want=want,
                arms_data=arms_data)


def _equal_tails(got, want):
    assert set(got) == set(want) and set(got['phases']) == set(
        want['phases'])
    for k, v in want.items():
        if k == 'phases':
            continue
        if isinstance(v, dict):
            for k2, v2 in v.items():
                if isinstance(v2, dict):
                    for name in v2:
                        np.testing.assert_array_equal(got[k][k2][name],
                                                      v2[name])
                else:
                    np.testing.assert_array_equal(got[k][k2], v2)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_run_tail_async_equals_run_tail(tail_inputs, monkeypatch):
    """collect() gives run_tail's dict exactly, on every call, from a
    worker thread that entered the fitter's device first."""
    entered = []
    monkeypatch.setattr(device_mod, 'enter_device', lambda d: entered.append(
        (threading.current_thread().name, torch.device(d))))
    t = tail_inputs
    collect = t['make']().run_tail_async(t['pmap'], t['x'], **t['kw'])
    first = collect()
    _equal_tails(first, t['want'])
    assert collect() is first
    assert entered == [('rvst-tail', torch.device('cpu'))]


def test_deferred_tail_owns_its_arms(tail_inputs, monkeypatch):
    """The race the reference's deferred tail has: the fitter's arms are
    swapped for the next group's and overwritten in place (host arrays
    and device tensors) after the dispatch and before the tail starts;
    the tail's results do not change.  A tail that fails raises at
    every collect()."""
    t = tail_inputs
    gate = threading.Event()
    real = batch.BatchedFitter.run_tail

    def gated(self, *args, **kwargs):
        assert gate.wait(60)
        return real(self, *args, **kwargs)
    monkeypatch.setattr(batch.BatchedFitter, 'run_tail', gated)
    bf = t['make']()
    collect = bf.run_tail_async(t['pmap'], t['x'], **t['kw'])
    old_host, old_dev = bf.batch_arms, bf.arms
    nxt = t['make']()
    bf.batch_arms, bf.arms = nxt.batch_arms[::-1], nxt.arms[::-1]
    for a in old_host:
        a.flux[:] = 1.0
        a.ivar[:] = 4.0
        a.badmask[:] = True
    for a in old_dev:
        a.dvec.zero_()
        a.espec_inv.fill_(3.0)
    gate.set()
    _equal_tails(collect(), t['want'])

    def broken(self, *args, **kwargs):
        raise RuntimeError('tail failed')
    monkeypatch.setattr(batch.BatchedFitter, 'run_tail', broken)
    collect = t['make']().run_tail_async(t['pmap'], t['x'], **t['kw'])
    for _ in range(2):
        with pytest.raises(RuntimeError, match='tail failed'):
            collect()


# ------------------------------------------------------------------
# the DESI driver: overlapped against serial

def test_overlapped_proc_many_equals_serial(files, desi_library, tmp_path,
                                            monkeypatch):
    """4 coadds at coalesce 2 with the overlaps on (the defaults) and
    with the three switches at 0: RVTAB and RVMOD equal (atol 1e-8),
    the same status lines in input order with completion stamps that
    do not go back; the overlapped run prepared the second group on the
    prep thread, ran the tails on tail threads and wrote on the writer
    thread, which entered the device first."""
    where = {}

    def spy(name, fn):
        def run(*args, **kwargs):
            where.setdefault(name, set()).add(
                threading.current_thread().name.split('_')[0])
            return fn(*args, **kwargs)
        return run
    monkeypatch.setattr(desi, '_prepare_one',
                        spy('prepare', desi._prepare_one))
    monkeypatch.setattr(desi, '_finish_one', spy('write', desi._finish_one))
    monkeypatch.setattr(batch.BatchedFitter, 'run_tail',
                        spy('tail', batch.BatchedFitter.run_tail))
    monkeypatch.setattr(desi, 'enter_device', spy('enter', lambda d: None))
    runs = {}
    for key, on in (('serial', False), ('overlap', True)):
        _serial(monkeypatch, on)
        where.clear()
        status = str(tmp_path / f'status-{key}.txt')
        _run(files, tmp_path / key, desi_library, status=status)
        runs[key] = (_status(status), dict(where))
    lines_s, where_s = runs['serial']
    lines_o, where_o = runs['overlap']
    assert [ln[:3] for ln in lines_o] == [ln[:3] for ln in lines_s] == \
        [[f, 'SUCCESS', str(NSEL)] for f in files]
    stamps = [float(ln[4]) for ln in lines_o]
    assert stamps == sorted(stamps)
    assert all(v == {'MainThread'} for v in where_s.values())
    assert where_s.keys() == {'prepare', 'write', 'tail'}
    assert where_o['prepare'] == {'MainThread', 'rvst-prep'}
    assert where_o['tail'] == {'rvst-tail'}
    assert where_o['write'] == where_o['enter'] == {'rvst-writer'}
    _same_outputs(tmp_path / 'overlap', tmp_path / 'serial',
                  [f'o{k}' for k in range(4)])


@pytest.mark.parametrize('fails', ['group', 'always'])
def test_tail_error_gives_the_serial_per_file_retry(files, desi_library,
                                                    tmp_path, monkeypatch,
                                                    fails):
    """A tail that fails for the coalesced group: each member is fitted
    alone and written (SUCCESS), or, where its tail fails again, gets a
    crash log and a FAILURE line, with the overlaps on exactly as with
    them off."""
    real = batch.BatchedFitter.run_tail

    def run_tail(self, *args, **kwargs):
        if fails == 'always' or self.nfibers > NSEL:
            raise RuntimeError('tail failed')
        return real(self, *args, **kwargs)
    monkeypatch.setattr(batch.BatchedFitter, 'run_tail', run_tail)
    monkeypatch.chdir(tmp_path)
    runs = {}
    for key, on in (('serial', False), ('overlap', True)):
        _serial(monkeypatch, on)
        status = str(tmp_path / f'status-{key}.txt')
        _run(files[:2], tmp_path / key, desi_library, status=status)
        runs[key] = [ln[:3] for ln in _status(status)]
    code, n = ('SUCCESS', str(NSEL)) if fails == 'group' else ('FAILURE',
                                                               '0')
    assert runs['overlap'] == runs['serial'] == [[f, code, n]
                                                 for f in files[:2]]
    crashes = [p for p in os.listdir(tmp_path) if p.startswith('crash_')]
    assert bool(crashes) == (fails == 'always')
    if fails == 'group':
        _same_outputs(tmp_path / 'overlap', tmp_path / 'serial',
                      ['o0', 'o1'])


@pytest.mark.parametrize('coalesce', [1, 2])
def test_throw_exceptions_raises_through_the_writer(files, desi_library,
                                                    tmp_path, monkeypatch,
                                                    coalesce):
    def broken(*args, **kwargs):
        raise RuntimeError('disk full')
    monkeypatch.setattr(desi, '_finish_one', broken)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='disk full'):
        _run(files[:1], tmp_path / 'out', desi_library, coalesce=coalesce,
             throw_exceptions=True)


def test_queue_is_never_read_ahead(tmp_path, monkeypatch):
    """A queue's item is claimed only as it is fitted and never read
    ahead; a static list's next file is read while a file fits, and the
    fit gets what was read."""
    events = []

    def queue():
        for f in ('coadd-a.fits', 'coadd-b.fits', 'coadd-c.fits'):
            events.append(('claim', f))
            yield f

    def fit_one(f, tab, mod, *args, prehdus=None, defer_finish=False,
                **kw):
        events.append(('fit', f, prehdus))
        return (1, lambda: None) if defer_finish else 1

    def read(f):
        events.append(('read', f))
        return f'hdus of {f}'
    monkeypatch.setattr(desi, 'proc_desi_wrapper', fit_one)
    monkeypatch.setattr(desi.fitsio, 'read', read)
    model = types.SimpleNamespace(geom=types.SimpleNamespace(
        h=torch.zeros(1)))
    kw = dict(config={}, templates={'desi_b': model})
    desi.proc_many(queue(), str(tmp_path), **kw)
    assert events == [e for f in ('coadd-a.fits', 'coadd-b.fits',
                                  'coadd-c.fits')
                      for e in (('claim', f), ('fit', f, None))]
    events.clear()
    desi.proc_many(['coadd-a.fits', 'coadd-b.fits'], str(tmp_path), **kw)
    assert ('read', 'coadd-b.fits') in events
    assert ('read', 'coadd-a.fits') not in events
    assert events[-1] == ('fit', 'coadd-b.fits', 'hdus of coadd-b.fits')
    assert ('fit', 'coadd-a.fits', None) in events


# ------------------------------------------------------------------
# WEAVE's prefetch

def test_weave_prefetch_equals_serial(desi_library, tmp_path, monkeypatch):
    """Two pairs with and without the next pair's read ahead: the same
    tables; with the prefetch the second pair's files are read on the
    reader thread."""
    from test_torch_weave import ARMS
    cfg = utils.read_config(None, {'template_lib': desi_library})
    templates, banks = {}, {}
    for s in ARMS:
        templates[f'weave_{s}'] = library.load_template_model(
            f'desi_{s}', cfg, device='cpu')
        tfft, t2fft, _, info = ccf.get_ccf_info(f'desi_{s}', cfg,
                                                device='cpu')
        banks[f'weave_{s}'] = (tfft, t2fft, info)
    groups = [write_pair(tmp_path, seed=s, nfib=2)[0] for s in (7, 8)]
    readers = []
    real = weave._read_pair
    monkeypatch.setattr(weave, '_read_pair', lambda names: readers.append(
        threading.current_thread().name) or real(names))
    tabs = {}
    for prefetch in (False, True):
        readers.clear()
        outdir = str(tmp_path / f'out{prefetch}')
        weave.proc_many(groups, outdir, cfg, options={'npoly': 8},
                        templates=templates, banks=banks, device='cpu',
                        throw_exceptions=True, prefetch=prefetch)
        tabs[prefetch] = [fitsio.read(weave.output_path(g, outdir))[
            'WEAVE_RV'].data for g in groups]
        assert sorted(readers) == (['MainThread', 'rvst-reader']
                                   if prefetch else ['MainThread'] * 2)
    for got, want in zip(tabs[True], tabs[False]):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------
# thread safety of the kernel builds

def test_two_threads_build_a_kernel_library_once(tmp_path, monkeypatch):
    """cuda_build.load from two threads at once: one nvcc run, one
    library, both threads get it (nvcc and ctypes mocked)."""
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('// kernel\n')
    monkeypatch.setattr(cuda_build, 'CSRC', csrc)
    monkeypatch.setattr(cuda_build, 'BUILD', tmp_path / '_build')
    cuda_build._load.cache_clear()
    runs = []
    started = threading.Event()

    def nvcc(cmd, **kwargs):
        runs.append(cmd)
        started.set()
        threading.Event().wait(0.3)       # the other thread asks now
        out = cmd[cmd.index('-o') + 1]
        with open(out, 'w') as fp:
            fp.write('lib')
        return subprocess.CompletedProcess(cmd, 0, '', '')
    monkeypatch.setattr(cuda_build.subprocess, 'run', nvcc)
    monkeypatch.setattr(cuda_build.ctypes, 'CDLL', lambda path: path)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        cuda_build.load('k'))) for _ in range(2)]
    threads[0].start()
    assert started.wait(10)
    threads[1].start()
    for t in threads:
        t.join()
    cuda_build._load.cache_clear()
    assert len(runs) == 1 and len(got) == 2 and got[0] == got[1]
    assert os.listdir(tmp_path / '_build') == [os.path.basename(got[0])]


# ------------------------------------------------------------------
# against the reference's driver at its own defaults

@pytest.mark.slow
def test_overlapped_main_matches_reference_main(files, desi_library,
                                                tmp_path, monkeypatch):
    """The port's ``main`` and the reference's, both at their defaults
    (overlaps on), on one coadd: TARGETID, SUCCESS and RVS_WARN equal,
    velocities within 1e-6 km/s, parameters and errors within rtol 1e-6
    (the tolerances of test_torch_desi's serial parity)."""
    _serial(monkeypatch, on=True)
    monkeypatch.chdir(tmp_path)
    fname = files[0]
    desi.main([fname, '--output_dir', str(tmp_path / 'port'),
               '--templ_lib', desi_library, '--device', 'cpu',
               '--throw_exceptions'])
    rdesi.main([fname, '--output_dir', str(tmp_path / 'ref'),
                '--templ_lib', desi_library, '--throw_exceptions'])
    got = fitsio.read(str(tmp_path / 'port' / 'rvtab-o0.fits'))['RVTAB'].data
    want = fitsio.read(str(tmp_path / 'ref' / 'rvtab-o0.fits'))['RVTAB'].data
    assert list(got) == list(want)
    for k in ('TARGETID', 'SUCCESS', 'RVS_WARN'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got['VRAD'], want['VRAD'], rtol=0, atol=1e-6)
    for k in ('TEFF', 'LOGG', 'FEH', 'ALPHAFE', 'VRAD_ERR', 'TEFF_ERR',
              'LOGG_ERR', 'FEH_ERR', 'ALPHAFE_ERR'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
