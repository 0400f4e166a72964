"""The port's offline template pipeline (rvspecfit_torch/pipeline:
read_grid, mask_grid, make_interpol, regularize_grid, make_nd,
make_ccf's writer) against the reference's, stage by stage, on one
small synthetic FITS grid (3 x 3 x 3 x 2 templates at 2000 px), in
float64 on the CPU.  Both packages run each stage on the same inputs;
the host stages give the same arrays, the CCF bank (whose continua
the port fits through ops/continuum) agrees at rtol 1e-8."""
import os
import shutil
import sqlite3

import numpy as np
import pytest

from rvspecfit_tpu import serializer as rserializer
from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.pipeline import make_ccf as rmake_ccf
from rvspecfit_tpu.pipeline import make_interpol as rmake_interpol
from rvspecfit_tpu.pipeline import make_nd as rmake_nd
from rvspecfit_tpu.pipeline import mask_grid as rmask_grid
from rvspecfit_tpu.pipeline import read_grid as rread_grid
from rvspecfit_tpu.pipeline import regularize_grid as rregularize_grid
from rvspecfit_torch import serializer, simulation
from rvspecfit_torch.io import fitsio
from rvspecfit_torch.pipeline import (make_ccf, make_interpol, make_nd,
                                      mask_grid, read_grid,
                                      regularize_grid)

GRID = dict(teff=np.linspace(4000.0, 10000.0, 3),
            logg=np.linspace(0.5, 5.0, 3), feh=np.linspace(-2.0, 0.0, 3),
            alpha=np.linspace(0.0, 1.0, 2))
KEYWORDS = dict(teff='PHXTEFF', logg='PHXLOGG', feh='PHXM_H',
                alpha='PHXALPHA')
SETUP = 'offl'
# DESI's build options (surveys/desi/make_desi.sh), on the grid's range
INTERPOL_ARGS = ['--setup', SETUP, '--lambda0', '4600', '--lambda1', '5400',
                 '--resol_func', 'x/1.55', '--step', '0.5']
CCF_ARGS = ['--setup', SETUP, '--lambda0', '4600', '--lambda1', '5400',
            '--step', '0.5', '--vsinis', '0,300', '--every', '2']


def write_grid(root, ntemplates=None):
    """The synthetic grid as FITS templates under ``root/specs`` (the
    first ``ntemplates`` of it, in order) with PHOENIX keywords, and
    ``root/wave.fits``, written with the port's FITS module."""
    os.makedirs(os.path.join(root, 'specs'), exist_ok=True)
    lam = np.linspace(4500.0, 5500.0, 2000)
    combos = [dict(zip(GRID, c)) for c in
              np.array(np.meshgrid(*GRID.values(), indexing='ij'))
              .reshape(4, -1).T]
    for i, p in enumerate(combos[:ntemplates]):
        fitsio.write(os.path.join(root, 'specs', f'xx_{i:05d}.fits'),
                     [dict(kind='image',
                           data=simulation.fake_spectrum(lam, **p),
                           header=[(KEYWORDS[k], float(v), '')
                                   for k, v in p.items()])])
    fitsio.write(os.path.join(root, 'wave.fits'),
                 [dict(kind='image', data=lam)])
    return lam


def assert_same(got, want, rtol=0.0, skip=()):
    """Nested equality of two loaded artifacts, arrays within ``rtol``
    (0: exactly, with the same dtype)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            if k not in skip:
                assert_same(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b, rtol)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        if rtol:
            np.testing.assert_allclose(got, want, rtol=rtol,
                                       atol=rtol * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.fixture(scope='module')
def grid(tmp_path_factory):
    """(grid directory, database) of the whole grid, catalogued by the
    reference."""
    root = str(tmp_path_factory.mktemp('offline_grid'))
    write_grid(root)
    db = os.path.join(root, 'files.db')
    rread_grid.makedb(root, dbfile=db, mask='specs/*fits')
    return root, db


def _rows(db):
    with sqlite3.connect(db) as conn:
        return (conn.execute('select * from files order by id').fetchall(),
                conn.execute('select * from grid_parameters').fetchall(),
                conn.execute("select sql from sqlite_master order by name")
                .fetchall())


def test_makedb_update_and_get_spec_match_reference(tmp_path):
    """makedb of part of the grid, then --update with the rest: the
    same tables, indexes and ids; get_spec returns the same arrays."""
    root = str(tmp_path)
    write_grid(root, ntemplates=20)
    dbs = {}
    for key, mod in (('port', read_grid), ('ref', rread_grid)):
        dbs[key] = os.path.join(root, f'{key}.db')
        mod.main(['--prefix', root, '--templdb', dbs[key],
                  '--glob_mask', 'specs/*fits'])
    write_grid(root)
    for key, mod in (('port', read_grid), ('ref', rread_grid)):
        mod.makedb(root, dbfile=dbs[key], mask='specs/*fits', update=True)
    got, want = _rows(dbs['port']), _rows(dbs['ref'])
    assert got == want and len(got[0]) == 54
    assert [r[-2] for r in got[0]] == list(range(54))
    for row in got[0][::13]:
        par = dict(zip(GRID, row[1:5]))
        kw = dict(dbfile=dbs['port'], prefix=root,
                  wavefile=os.path.join(root, 'wave.fits'))
        for a, b in zip(read_grid.get_spec(par, **kw),
                        rread_grid.get_spec(par, **dict(
                            kw, dbfile=dbs['ref']))):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('toair', [False, True])
@pytest.mark.parametrize('resol', ['x/1.55', '2000'])
def test_rebinner_matches_reference(toair, resol):
    """The sparse LSF rebinner: the same CSC matrix, elementwise within
    1e-15 relative; and apply_rebinner, rebin and vacuum_to_air."""
    lam_in = np.linspace(4500.0, 5500.0, 2000)
    lam_out = make_interpol.make_output_grid(4600.0, 5400.0, 0.5, True)
    np.testing.assert_array_equal(
        lam_out, rmake_interpol.make_output_grid(4600.0, 5400.0, 0.5, True))
    func = make_interpol.Resolution(resol_func=resol)
    got = read_grid.make_rebinner(lam_in, lam_out, func, resolution0=1e5,
                                  toair=toair)
    want = rread_grid.make_rebinner(lam_in, lam_out, func,
                                    resolution0=1e5, toair=toair)
    assert got.format == want.format == 'csc' and got.shape == want.shape
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-15, atol=0)
    spec = simulation.fake_spectrum(lam_in, 6000.0, 3.0, -1.0, 0.3)
    np.testing.assert_allclose(read_grid.apply_rebinner(got, spec),
                               rread_grid.apply_rebinner(want, spec),
                               rtol=1e-15)
    np.testing.assert_array_equal(
        read_grid.rebin(lam_in, spec, lam_out, 3000.0),
        rread_grid.rebin(lam_in, spec, lam_out, 3000.0))
    np.testing.assert_array_equal(read_grid.vacuum_to_air(lam_in),
                                  rread_grid.vacuum_to_air(lam_in))
    for mod in (read_grid, rread_grid):
        with pytest.raises(ValueError):
            mod.make_rebinner(lam_in, lam_out, lambda x: 1e6 + 0 * x,
                              resolution0=1e5)
        with pytest.raises(ValueError):
            mod.make_rebinner(lam_in, lam_out, func)


def test_mask_grid_matches_reference(tmp_path):
    """--phoenix into a copy, then --where and --unmask in place: the
    same bad column as tests/test_cli.py::test_mask_grid, on both."""
    rows = [(f'f{i}.fits', t, g, f, a, i, False)
            for i, (t, g, f, a) in enumerate([
                (4000.0, 3.0, -1.0, -0.4), (6000.0, 3.0, -1.0, -0.4),
                (3100.0, 3.0, -0.5, 1.2), (5000.0, 4.0, 0.0, 0.2)])]
    bad = {}
    for key, mod in (('port', mask_grid), ('ref', rmask_grid)):
        db, out = str(tmp_path / f'{key}.db'), str(tmp_path / f'{key}_m.db')
        with sqlite3.connect(db) as conn:
            conn.execute('CREATE TABLE files (filename varchar, teff real, '
                         'logg real, feh real, alpha real, id int, '
                         'bad bool)')
            conn.executemany('INSERT INTO files VALUES (?,?,?,?,?,?,?)',
                             rows)
        mod.main(['--templdb', db, '--output', out, '--phoenix'])
        with sqlite3.connect(db) as conn:
            assert not conn.execute('SELECT sum(bad) FROM files'
                                    ).fetchone()[0]
        bad[key] = [_bad(out)]
        mod.main(['--templdb', out, '--where', 'teff>5500'])
        bad[key].append(_bad(out))
        mod.main(['--templdb', out, '--unmask', '--where', 'teff>5500'])
        bad[key].append(_bad(out))
    assert bad['port'] == bad['ref']
    assert bad['port'][0] == {'f0.fits': 1, 'f1.fits': 0, 'f2.fits': 1,
                              'f3.fits': 0}
    assert bad['port'][1]['f1.fits'] == 1 and bad['port'][2]['f1.fits'] == 0
    assert mask_grid.PHOENIX_RULES == rmask_grid.PHOENIX_RULES


def _bad(db):
    with sqlite3.connect(db) as conn:
        return dict(conn.execute('SELECT filename, bad FROM files'))


@pytest.mark.parametrize('float_bits,nthreads', [(32, 2), (64, 1)])
def test_make_interpol_matches_reference(grid, tmp_path, float_bits,
                                         nthreads):
    """specs_{setup}.h5 from both CLIs with DESI's options (the port's
    in float32 through its spawn pool): every key equal but cmdline
    and git_rev; the specs in the asked float type."""
    root, db = grid
    common = INTERPOL_ARGS + [
        '--templdb', db, '--templprefix', root, '--float_bits',
        str(float_bits), '--wavefile', os.path.join(root, 'wave.fits')]
    make_interpol.main(common + ['--oprefix', str(tmp_path / 'port'),
                                 '--nthreads', str(nthreads)])
    rmake_interpol.main(common + ['--oprefix', str(tmp_path / 'ref')])
    name = make_interpol.SPECS_H5_NAME % SETUP
    got = serializer.load_dict_from_hdf5(str(tmp_path / 'port' / name))
    want = rserializer.load_dict_from_hdf5(str(tmp_path / 'ref' / name))
    assert_same(got, want, skip=('cmdline', 'git_rev'))
    assert got['specs'].dtype == np.dtype(f'float{float_bits}')
    assert got['specs'].shape[0] == 54
    assert got['cmdline'].startswith('rvstorch_make_interpol --setup')
    assert make_interpol.SPECS_H5_NAME == rmake_interpol.SPECS_H5_NAME


def test_fetch_all_parameters_checks_the_database(grid, tmp_path):
    root, db = grid
    for mod in (make_interpol, rmake_interpol):
        with pytest.raises(RuntimeError, match='3 parameters|grid param'):
            mod.fetch_all_parameters(db, ('teff', 'logg', 'feh'))
        with pytest.raises(RuntimeError, match='does not exist'):
            mod.fetch_all_parameters(str(tmp_path / 'none.db'), GRID)
    got = make_interpol.fetch_all_parameters(db, tuple(GRID))
    want = rmake_interpol.fetch_all_parameters(db, tuple(GRID))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_regularize_grid_matches_reference(tmp_path):
    """converter on tests/test_regularize.py's holey grid: the same
    filled grid, spectra within 1e-12."""
    rng = np.random.RandomState(0)
    lam = np.exp(np.linspace(np.log(4800), np.log(5200), 300))
    vec, specs = [], []
    for t in np.linspace(4500, 8000, 4):
        for g in np.linspace(1.0, 4.0, 3):
            for f in np.linspace(-2.0, 0.0, 4):
                for a in np.linspace(0.0, 1.0, 3):
                    if rng.uniform() < 0.15:
                        continue
                    vec.append([t, g, f, a])
                    specs.append(np.log(rsim.fake_spectrum(
                        lam, t, g, f, a, wresol=2.0)))
    specs = np.array(specs)
    src = str(tmp_path / 'specs_in.h5')
    rserializer.save_dict_to_hdf5(src, dict(
        vec=np.array(vec).T, specs=specs, lam=lam,
        parnames=['teff', 'logg', 'feh', 'alpha'],
        lognorms=np.zeros(len(specs)), log_step=True, log_spec=True,
        log_ids=[0], mapper_class='LogMapper', git_rev='t', revision='',
        cmdline='', file_ids=np.arange(len(specs)), dbfile=''))
    args = ['--input', src, '--fehs=-2,-1,0', '--alphas', '0,0.5,1',
            '--window', '4']
    regularize_grid.main(args + ['--output', str(tmp_path / 'port.h5')])
    rregularize_grid.main(args + ['--output', str(tmp_path / 'ref.h5')])
    got = serializer.load_dict_from_hdf5(str(tmp_path / 'port.h5'))
    want = rserializer.load_dict_from_hdf5(str(tmp_path / 'ref.h5'))
    assert_same(got, want, skip=('specs',))
    assert_same(got['specs'], want['specs'], rtol=1e-12)
    assert got['vec'].shape == (4, 12 * 9)     # 12 (teff, logg) x 3 x 3
    assert regularize_grid.find_best_overlaps(30, 12) \
        == rregularize_grid.find_best_overlaps(30, 12)


@pytest.fixture(scope='module')
def specs_dir(grid, tmp_path_factory):
    """A directory holding the reference's specs_{setup}.h5 of the
    grid (float32, DESI's options)."""
    root, db = grid
    out = str(tmp_path_factory.mktemp('offline_specs'))
    rmake_interpol.main(INTERPOL_ARGS + [
        '--templdb', db, '--templprefix', root, '--oprefix', out,
        '--wavefile', os.path.join(root, 'wave.fits')])
    return out


@pytest.mark.parametrize('regular', [True, False])
def test_make_nd_matches_reference(specs_dir, tmp_path, regular):
    """interp_{setup}.h5 and interpdat_{setup}.npy of both CLIs from one
    specs file, a regular grid with -1 holes or a triangulation with
    its jittered vertices and padded corners: equal but cmdline and
    git_rev."""
    dirs = {}
    for key, mod in (('port', make_nd), ('ref', rmake_nd)):
        dirs[key] = str(tmp_path / key)
        os.makedirs(dirs[key])
        shutil.copy(os.path.join(specs_dir, make_interpol.SPECS_H5_NAME
                                 % SETUP), dirs[key])
        mod.main(['--prefix', dirs[key], '--setup', SETUP]
                 + (['--regulargrid'] if regular else []))
    name = make_nd.INTERPOL_H5_NAME % SETUP
    got = serializer.load_dict_from_hdf5(os.path.join(dirs['port'], name))
    want = rserializer.load_dict_from_hdf5(os.path.join(dirs['ref'], name))
    assert_same(got, want, skip=('cmdline', 'git_rev'))
    assert got['cmdline'].startswith('rvstorch_make_nd')
    dat = make_nd.INTERPOL_DAT_NAME % SETUP
    assert_same(np.load(os.path.join(dirs['port'], dat)),
                np.load(os.path.join(dirs['ref'], dat)))
    if regular:
        assert got['interpolation_type'] == 'regulargrid'
        assert got['idgrid'].shape == (3, 3, 3, 2)
    else:
        vec = serializer.load_dict_from_hdf5(os.path.join(
            specs_dir, make_interpol.SPECS_H5_NAME % SETUP))['vec']
        vec[0] = np.log10(vec[0])
        jitter = np.abs(got['vec'][:, :54] - vec)
        assert got['vec'].shape == (4, 54 + 16)
        assert 0 < jitter.max() <= make_nd.PERTURBATION_AMPLITUDE
    assert (make_nd.INTERPOL_H5_NAME, make_nd.INTERPOL_DAT_NAME) == (
        rmake_nd.INTERPOL_H5_NAME, rmake_nd.INTERPOL_DAT_NAME)
    np.testing.assert_array_equal(
        make_nd.getedgevertices(got['vec']),
        rmake_nd.getedgevertices(want['vec']))


def test_make_ccf_matches_reference(specs_dir, tmp_path):
    """The three CCF files of both CLIs with DESI's --vsinis 0,300 (the
    port's continua on the CPU): rFFTs and models within rtol 1e-8;
    info equal but cmdline and git_rev, vsini 0 recorded as 0.0 with
    vsini_is_none False."""
    for key, mod, extra in (('port', make_ccf, ['--cpu']),
                            ('ref', rmake_ccf, [])):
        mod.main(CCF_ARGS + ['--prefix', specs_dir, '--oprefix',
                             str(tmp_path / key)] + extra)
    paths = {key: str(tmp_path / key) for key in ('port', 'ref')}
    info = {key: (serializer if key == 'port' else rserializer)
            .load_dict_from_hdf5(os.path.join(
                p, make_ccf.get_ccf_info_name(SETUP))) for key, p in
            paths.items()}
    assert_same(info['port'], info['ref'], skip=('cmdline', 'git_rev'))
    assert info['port']['cmdline'].startswith('rvstorch_make_ccf')
    assert info['port']['vsinis'] == [0.0] * 27 + [300.0] * 27
    assert not any(info['port']['vsini_is_none'])
    with np.load(os.path.join(paths['port'], make_ccf.get_ccf_dat_name(
            SETUP))) as g, np.load(os.path.join(
                paths['ref'], rmake_ccf.get_ccf_dat_name(SETUP))) as r:
        assert set(g) == set(r) == {'fft', 'fft2'}
        for k in r:
            assert g[k].shape == (54, 1025)
            assert_same(g[k], r[k], rtol=1e-8)
    mod = make_ccf.get_ccf_mod_name(SETUP)
    assert_same(np.load(os.path.join(paths['port'], mod)),
                np.load(os.path.join(paths['ref'], mod)), rtol=1e-8)
