"""The port's WEAVE driver (rvspecfit_torch/survey/weave.py).

Host functions against the reference's (WCS wavelengths, the file
check, the telluric error inflation), the port's proc_weave and
proc_many on a tiny in-memory red + blue pair on the CPU (columns, RV
recovery, status lines), and the command line.  The port's ``main``
against the reference's needs the reference's fit programs, which
compile for minutes on the CPU: that test is marked slow."""
import os

import numpy as np
import pytest
import torch

from conftest import DESI_ARMS
from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.io import fitsio as rfits
from rvspecfit_tpu.survey import weave as rweave
from rvspecfit_torch import utils
from rvspecfit_torch.fit import ccf
from rvspecfit_torch.io import fitsio
from rvspecfit_torch.pipeline import library
from rvspecfit_torch.survey import weave

from test_weave import weave_setup  # noqa: F401

C_KMS = 299792.458
NFIB = 3
# the WEAVE arms inside the desi_library's blue and red setups
ARMS = {'b': DESI_ARMS['b'], 'r': DESI_ARMS['r']}


@pytest.mark.parametrize('header', [
    dict(CRVAL1=4.62e-7, CD1_1=7e-11, CRPIX1=1.0, CUNIT1='m'),
    dict(CRVAL1=462.0, CDELT1=0.07, CRPIX1=3.0, CUNIT1='nm'),
    dict(CRVAL1=4620.0, CD1_1=0.7, CRPIX1=1.5, CUNIT1='Angstrom'),
    dict(CRVAL1=4.62e-7, CD1_1=7e-11)])
def test_wcs_wavelengths_match_reference(header):
    np.testing.assert_array_equal(weave.wcs_wavelengths(header, 50),
                                  rweave.wcs_wavelengths(header, 50))


def _fits(names):
    return fitsio.FITSFile([fitsio.HDU(name=n) for n in names])


@pytest.mark.parametrize('names', [['', 'RED_DATA', 'RED_IVAR', 'FIBTABLE'],
                                   ['', 'RED_DATA', 'FIBTABLE']])
def test_valid_file_matches_reference(names):
    assert weave.valid_file(_fits(names)) == rweave.valid_file(_fits(names))


def test_telluric_inflation_is_the_references():
    """The reference inflates in place inside proc_weave
    (rvspecfit_tpu/survey/weave.py:115-123): the same bands, and the
    same ivar, on a grid crossing two of them."""
    assert weave.TELLURIC_BANDS == rweave.TELLURIC_BANDS
    rng = np.random.RandomState(0)
    wave = np.linspace(6800.0, 8400.0, 300)
    flux = rng.uniform(-2.0, 5.0, (4, 300))
    ivar = rng.uniform(0.0, 3.0, (4, 300))
    want = ivar.copy()
    telluric = np.zeros(300, bool)
    for lo, hi in rweave.TELLURIC_BANDS:
        telluric |= (wave >= lo) & (wave < hi)
    want[:, telluric] = 1.0 / 100.0 / np.maximum(flux[:, telluric],
                                                 1.0)**2
    got = weave.telluric_ivar(wave, flux, ivar)
    np.testing.assert_array_equal(got, want)
    assert telluric.any() and (got[:, ~telluric] == ivar[:, ~telluric]).all()


def write_pair(root, seed, nfib=NFIB, npix=380, programs=None):
    """A WEAVE RED + BLUE file pair in tests/test_weave.py's layout on
    the ARMS grids, written with the port's fitsio: (file names, truth
    velocities)."""
    rng = np.random.RandomState(seed)
    vel = rng.uniform(-250, 250, nfib)
    programs = programs or ['GA_LRhighlat'] * nfib
    fnames = []
    for s, cam in (('r', 'RED'), ('b', 'BLUE')):
        l0, l1 = ARMS[s]
        wave = np.linspace(l0, l1, npix)
        flux = np.zeros((nfib, npix), np.float32)
        ivar = np.zeros((nfib, npix), np.float32)
        for i in range(nfib):
            sp = rsim.fake_spectrum(wave / (1 + vel[i] / C_KMS), 6200.0,
                                    3.0, -0.7, 0.4,
                                    wresol=5000 / 2000 / 2.35)
            esp = sp / 60.0
            flux[i] = sp + rng.normal(size=npix) * esp
            ivar[i] = 1.0 / esp**2
        cd = wave[1] - wave[0]
        hd = [('CAMERA', f'WEAVE{cam}', ''), ('OBID', 'test_ob.01', ''),
              ('CRVAL1', wave[0] * 1e-10, ''), ('CD1_1', cd * 1e-10, ''),
              ('CRPIX1', 1.0, ''), ('CUNIT1', 'm', '')]
        fib = [('TARGID', np.array([f'"star_{i}"' for i in range(nfib)])),
               ('TARGCAT', np.array(programs))]
        fname = str(root / f'pair{seed}_{cam}.fits')
        fitsio.write(fname, [
            dict(kind='image', data=None, header=hd),
            dict(kind='image', data=flux, name=f'{cam}_DATA', header=hd),
            dict(kind='image', data=ivar, name=f'{cam}_IVAR'),
            dict(kind='table', data=fib, name='FIBTABLE')])
        fnames.append(fname)
    return ','.join(fnames), vel


@pytest.fixture(scope='module')
def weave_models(desi_library):
    """The desi_library's b and r setups as weave_b and weave_r, in
    memory on the CPU."""
    cfg = utils.read_config(None, {'template_lib': desi_library})
    templates, banks = {}, {}
    for s in ARMS:
        templates[f'weave_{s}'] = library.load_template_model(
            f'desi_{s}', cfg, device='cpu')
        tfft, t2fft, _, info = ccf.get_ccf_info(f'desi_{s}', cfg,
                                                device='cpu')
        banks[f'weave_{s}'] = (tfft, t2fft, info)
    return cfg, templates, banks


def reference_columns(parnames, setups):
    """The WEAVE_RV columns of the reference's proc_weave
    (rvspecfit_tpu/survey/weave.py:197-208), in order."""
    cols = ['brickname', 'target_id', 'vrad', 'vrad_err', 'vsini']
    for p in parnames:
        cols += [p, p + '_err']
    cols.append('chisq_tot')
    for s in setups:
        cols += [f'chisq_{s}', f'chisq_c_{s}', f'sn_{s}']
    return cols


def test_proc_many_fits_a_pair_and_writes_status(weave_models, tmp_path):
    """proc_many on a 3-fiber pair: the reference's columns, TARGID
    without quotes, OBID as the brick, RV recovery within max(10 km/s,
    5 sigma), SUCCESS; then SKIPPED without overwrite, and EMPTY when
    no fiber belongs to the programs."""
    cfg, templates, banks = weave_models
    grp, vel = write_pair(tmp_path, seed=5)
    outdir = str(tmp_path / 'out')
    status = str(tmp_path / 'status.txt')
    kw = dict(options={'npoly': 8}, templates=templates, banks=banks,
              device='cpu', throw_exceptions=True)
    weave.proc_many([grp], outdir, cfg, status_fname=status, **kw)
    ofname = weave.output_path(grp, outdir)
    tab = fitsio.read(ofname)['WEAVE_RV'].data
    assert list(tab) == reference_columns(templates['weave_b'].parnames,
                                          ['b', 'r'])
    np.testing.assert_array_equal(np.char.strip(tab['target_id']),
                                  [f'star_{i}' for i in range(NFIB)])
    assert set(np.char.strip(tab['brickname'])) == {'testob01'}
    assert (np.abs(tab['vrad'] - vel)
            < np.maximum(10.0, 5 * tab['vrad_err'])).all()
    assert np.isfinite(tab['teff_err']).all() and (tab['sn_b'] > 30).all()
    line = open(status).read().split()
    assert line[:3] == [ofname, 'SUCCESS', str(NFIB)]

    weave.proc_many([grp], outdir, cfg, status_fname=status,
                    overwrite=False, **kw)
    assert open(status).read().split()[:3] == [ofname, 'SKIPPED', '0']
    other, _ = write_pair(tmp_path, seed=6, programs=['WL_other'] * NFIB)
    weave.proc_many([other], outdir, cfg, status_fname=status, **kw)
    assert open(status).read().split()[1] == 'EMPTY'
    assert not os.path.exists(weave.output_path(other, outdir))


def test_proc_weave_stripes_fibers_and_raises_on_ccf_failure(
        weave_models, tmp_path, monkeypatch):
    """Fiber striping over threads keeps the reference's split, and a
    CCF failure raises (the reference starts at default parameters)."""
    cfg, templates, banks = weave_models
    grp, _ = write_pair(tmp_path, seed=7, nfib=4,
                        programs=['GA_LRdisc', 'x', 'GA_LRhighlat',
                                  'GA_LRdisc'])
    kw = dict(options={'npoly': 5}, templates=templates, banks=banks,
              device='cpu')
    out = weave.proc_weave(grp, cfg, threadid=1, nthreads=2, **kw)
    xids = np.array([0, 2, 3])
    stripe = np.linspace(0, 2, 3, False).astype(int)
    np.testing.assert_array_equal(np.char.strip(out['target_id']),
                                  [f'star_{i}' for i in xids[stripe == 1]])

    def broken(*args, **kwargs):
        raise RuntimeError('CCF kernel failed')
    monkeypatch.setattr(ccf, 'fit_batch', broken)
    with pytest.raises(RuntimeError, match='CCF kernel failed'):
        weave.proc_weave(grp, cfg, **kw)
    status = str(tmp_path / 'status.txt')
    weave.proc_many([grp], str(tmp_path / 'out'), cfg, status_fname=status,
                    **kw)
    assert open(status).read().split()[1] == 'FAILED'


def test_main_needs_the_card_and_refuses_left_out_options(monkeypatch,
                                                          tmp_path):
    """Without a card main raises, also with the plot options and in a
    world (whose barrier and shutdown still run); the options that
    used to be refused are ported and reach proc_many; no input files
    exit through the parser."""
    from rvspecfit_torch.parallel import distributed
    calls = {}
    monkeypatch.setattr(distributed, 'init_distributed',
                        lambda coord=None, n=None, p=None: (0, 2))
    monkeypatch.setattr(distributed, 'barrier',
                        lambda name=None, timeout_ms=None:
                        calls.setdefault('barrier', name))
    monkeypatch.setattr(distributed, 'shutdown',
                        lambda *a: calls.setdefault('shutdown', True))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        weave.main(['a.fits,b.fits', '--output_dir', str(tmp_path)])
    for opt in (['--doplot'], ['--coordinator', 'h:1'],
                ['--figure_dir', 'f']):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            weave.main(['a.fits,b.fits', '--output_dir', str(tmp_path)]
                       + opt)
    assert calls == {'barrier': 'rvstorch_weave_fit_done',
                     'shutdown': True}
    monkeypatch.setattr(weave, 'proc_many', lambda files, outdir, config,
                        **kw: calls.update(proc=kw))
    weave.main(['a.fits,b.fits', '--device', 'cpu', '--doplot',
                '--figure_dir', str(tmp_path / 'f')])
    assert calls['proc']['fig_prefix'] == str(tmp_path / 'f' / 'fig')
    with pytest.raises(SystemExit):
        weave.main(['--device', 'cpu'])


def test_weave_coordinator_wiring(monkeypatch, tmp_path):
    """--coordinator maps the world's rank and size onto threadid and
    nthreads unless they are given, and the world's barrier and
    shutdown run afterwards (the reference's
    tests/test_cli.py::test_weave_coordinator_wiring)."""
    from rvspecfit_torch.parallel import distributed
    calls = {}
    monkeypatch.setattr(distributed, 'init_distributed',
                        lambda coord=None, n=None, p=None:
                        calls.setdefault('init', coord) and None
                        or (1, 3))
    monkeypatch.setattr(distributed, 'barrier',
                        lambda name=None, timeout_ms=None:
                        calls.setdefault('barrier', name))
    monkeypatch.setattr(distributed, 'shutdown',
                        lambda *a: calls.setdefault('shutdown', True))
    monkeypatch.setattr(weave, 'proc_many',
                        lambda files, outdir, config, **kw:
                        calls.setdefault('proc', kw))
    flist = tmp_path / 'in.txt'
    flist.write_text('a.fits,b.fits\n')
    weave.main(['--input_file', str(flist), '--output_dir', str(tmp_path),
                '--coordinator', 'localhost:1234', '--device', 'cpu'])
    assert calls['init'] == 'localhost:1234'
    assert calls['proc']['threadid'] == 1
    assert calls['proc']['nthreads'] == 3
    assert calls['barrier'] == 'rvstorch_weave_fit_done'
    assert calls['shutdown'] is True

    # explicit threadid/nthreads win over the world indices
    calls.clear()
    weave.main(['--input_file', str(flist), '--output_dir', str(tmp_path),
                '--coordinator', 'localhost:1234', '--device', 'cpu',
                '--threadid', '2', '--nthreads', '5'])
    assert calls['proc']['threadid'] == 2
    assert calls['proc']['nthreads'] == 5


def test_proc_weave_writes_a_plot_per_fiber(weave_models, tmp_path):
    """``fig_prefix``: one PNG per fitted fiber, named after its target
    id as the reference names it."""
    cfg, templates, banks = weave_models
    grp, _ = write_pair(tmp_path, seed=8, nfib=2)
    out = weave.proc_weave(grp, cfg, options={'npoly': 5},
                           templates=templates, banks=banks, device='cpu',
                           fig_prefix=str(tmp_path / 'fig'))
    assert len(out['vrad']) == 2
    for i in range(2):
        png = tmp_path / f'fig_star_{i}.png'
        assert png.read_bytes()[:4] == b'\x89PNG'


@pytest.mark.slow
def test_main_matches_reference_main(weave_setup, tmp_path, monkeypatch):  # noqa: F811
    """The port's ``main`` against the reference's on test_weave.py's
    synthetic pair and library (the reference unsharded): the same
    columns and targets; velocities within 1e-6 km/s, parameters and
    errors within rtol 1e-6 (the tolerances of the DESI driver's
    parity)."""
    lib, fnames, _ = weave_setup
    monkeypatch.setenv('RVST_NO_MESH', '1')
    monkeypatch.chdir(tmp_path)
    grp = ','.join(fnames)
    common = [grp, '--templ_lib', lib, '--npoly', '8']
    weave.main(common + ['--output_dir', str(tmp_path / 'port'),
                         '--device', 'cpu'])
    rweave.main(common + ['--output_dir', str(tmp_path / 'ref')])
    name = os.path.basename(weave.output_path(grp, '.'))
    got = fitsio.read(str(tmp_path / 'port' / name))['WEAVE_RV'].data
    want = rfits.read(str(tmp_path / 'ref' / name))['WEAVE_RV'].data
    assert list(got) == list(want)
    np.testing.assert_array_equal(got['target_id'], want['target_id'])
    np.testing.assert_allclose(got['vrad'], want['vrad'], rtol=0, atol=1e-6)
    for k in ('teff', 'logg', 'feh', 'alpha', 'vsini', 'vrad_err',
              'teff_err', 'logg_err', 'feh_err', 'alpha_err', 'sn_b',
              'sn_r'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
