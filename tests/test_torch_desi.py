"""The port's DESI driver (rvspecfit_torch/survey/desi.py).

Host stages against the reference's own numpy functions on the same
inputs (fiber selection, arm building, resolution bands, S/N, warning
bits, column registry, status lines, writers, the empty-selection
files of ``main``), then the driver end to end on the CPU
(``--device cpu``) against the desi_library fixture.  The parity of
the fitted values with the reference's driver needs the reference's
fit programs, which compile for minutes on the CPU: that test is
marked slow."""
import os
import types

import numpy as np
import pytest
import torch

from conftest import DESI_ARMS
from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.io import fitsio as rfits
from rvspecfit_tpu.ops import continuum as rcont
from rvspecfit_tpu.survey import desi as rdesi
from rvspecfit_torch import utils
from rvspecfit_torch.io import fitsio
from rvspecfit_torch.pipeline import library
from rvspecfit_torch.survey import desi

C_KMS = 299792.458
NFIB = 5
TID0 = 39620000000
# provenance cards that name the software and the time of the run
PROVENANCE = ('RVS_VER', 'RVS_DATE', 'DEPNAM', 'DEPVER', 'RVS_CMD')


# ------------------------------------------------------------------
# synthetic inputs

def _gauss_band(sigma_pix, width, npix):
    """dia-convention banded Gaussian resolution matrix (offsets
    +w2..-w2) whose dense columns sum to 1."""
    w2 = width // 2
    offs = np.arange(w2, -w2 - 1, -1)
    band = np.exp(-0.5 * (offs / sigma_pix)**2)[:, None] * \
        np.ones((width, npix))
    dense = np.zeros((npix, npix))
    for k, o in enumerate(offs):
        idx = np.arange(max(0, -o), min(npix, npix - o))
        dense[idx + o, idx] = band[k, idx]
    dense /= dense.sum(axis=0, keepdims=True)
    out = np.zeros((width, npix))
    for k, o in enumerate(offs):
        idx = np.arange(max(0, -o), min(npix, npix - o))
        out[k, idx] = dense[idx + o, idx]
    return out


def write_coadd(fname, seed, nfib=NFIB, resolution=False):
    """DESI-style coadd: 3 arms x 400 px, FIBERMAP, SCORES,
    EXP_FIBERMAP.  Without ``resolution`` the last fiber is fully
    masked and fiber 1 has NaN pixels; with it every fiber is smeared
    by its own Gaussian LSF, given as width-11 RESOLUTION bands.
    Returns the truth."""
    rng = np.random.RandomState(seed)
    truth = dict(vel=rng.uniform(-300, 300, nfib),
                 teff=rng.uniform(4800, 9000, nfib),
                 logg=rng.uniform(1.5, 4.5, nfib),
                 feh=rng.uniform(-1.5, -0.3, nfib),
                 alpha=rng.uniform(0.2, 0.8, nfib))
    sigmas = np.linspace(1.25, 1.6, nfib)
    hdus = [dict(kind='image', data=None,
                 header=[('TILEID', 80605, ''), ('SPGRP', 'cumulative', '')])]
    for s, (l0, l1) in DESI_ARMS.items():
        npix = 400
        wave = np.linspace(l0, l1, npix)
        flux = np.zeros((nfib, npix), np.float32)
        ivar = np.zeros((nfib, npix), np.float32)
        mask = np.zeros((nfib, npix), np.int32)
        res = np.zeros((nfib, 11, npix), np.float32)
        for i in range(nfib):
            sp = rsim.fake_spectrum(
                wave / (1 + truth['vel'][i] / C_KMS), truth['teff'][i],
                truth['logg'][i], truth['feh'][i], truth['alpha'][i],
                wresol=sigmas[i] if resolution else 5000.0 / 2000.0 / 2.35)
            esp = sp / 80.0
            flux[i] = sp + rng.normal(size=npix) * esp
            ivar[i] = 1.0 / esp**2
            res[i] = _gauss_band(sigmas[i] / (wave[1] - wave[0]), 11, npix)
        if not resolution:
            mask[nfib - 1, :] = 1
            flux[1, 100:110] = np.nan
        su = s.upper()
        hdus += [dict(kind='image', data=wave, name=f'{su}_WAVELENGTH'),
                 dict(kind='image', data=flux, name=f'{su}_FLUX'),
                 dict(kind='image', data=ivar, name=f'{su}_IVAR'),
                 dict(kind='image', data=mask, name=f'{su}_MASK')]
        if resolution:
            hdus.append(dict(kind='image', data=res,
                             name=f'{su}_RESOLUTION'))
    tids = np.arange(nfib, dtype=np.int64) + TID0
    hdus.append(dict(kind='table', name='FIBERMAP', data=[
        ('TARGETID', tids),
        ('TARGET_RA', rng.uniform(0, 360, nfib)),
        ('TARGET_DEC', rng.uniform(-30, 30, nfib)),
        ('FIBER', np.arange(nfib, dtype=np.int32)),
        ('OBJTYPE', np.array(['TGT'] * nfib)),
        ('FIBERSTATUS', np.zeros(nfib, np.int32)),
        ('DESI_TARGET', np.full(nfib, 2**60, np.int64))]))
    snr = np.full(nfib, 80.0)
    if not resolution:
        snr[nfib - 1] = -1e9
    hdus.append(dict(kind='table', name='SCORES', data=[
        ('MEDIAN_CALIB_SNR_' + s.upper(), snr) for s in DESI_ARMS]))
    hdus.append(dict(kind='table', name='EXP_FIBERMAP', data=[
        ('TARGETID', np.repeat(tids, 2)),
        ('EXPID', np.tile(np.array([101, 102], np.int64), nfib))]))
    fitsio.write(fname, hdus)
    return truth


def _fibermap(variant):
    """A 12-fiber FIBERMAP carrying the target column of ``variant``."""
    n = 12
    rng = np.random.RandomState(3)
    fm = dict(
        TARGETID=np.arange(n, dtype=np.int64) + TID0,
        FIBERSTATUS=np.array([0, 8, 1, 2**20, 0, 0, 4, 0, 0, 8 | 2**20,
                              0, 0], np.int32),
        OBJTYPE=np.array(['TGT', 'TGT', 'TGT', 'TGT', 'SKY', 'TGT',
                          'TGT', 'BAD', 'TGT', 'TGT', 'TGT', 'TGT ']),
        EXPID=np.array([100, 101, 102, 103, 104, 105] * 2, np.int64))
    bits = np.array([1 << 61, 1 << 33, 1, 1 << 61 | 1 << 35, 1 << 32,
                     2, 1 << 3, 1 << 61, 1 << 9, 1 << 34, 1 << 8, 0],
                    np.int64)
    col = dict(main='DESI_TARGET', sv3='SV3_DESI_TARGET',
               cmx='CMX_TARGET', coadd='DESI_TARGET')[variant]
    fm[col] = bits
    if variant == 'coadd':
        fm['COADD_FIBERSTATUS'] = fm.pop('FIBERSTATUS')
    return fm, rng.uniform(-5, 50, n)


def _redrock(path):
    tids = np.arange(12, dtype=np.int64) + TID0
    z = np.array([1e-4, -2e-4, 0.5, 1e-3, 0.3, 2e-4, 0, 0, 1e-5, 0.7,
                  -1e-4, 0.1])
    spectype = np.array(['STAR', 'STAR', 'GALAXY', 'GALAXY', 'QSO',
                         'STAR', 'STAR', 'STAR', 'STAR', 'QSO', 'GALAXY',
                         'STAR'])
    keep = np.arange(12) != 6                 # one target has no entry
    rfits.write(path, [dict(kind='image', data=None),
                       dict(kind='table', name='REDSHIFTS', data=[
                           ('TARGETID', tids[keep]), ('Z', z[keep]),
                           ('SPECTYPE', spectype[keep]),
                           ('SUBTYPE', np.array(['none'] * 11))])])


SELECT_CASES = {
    'fiberstatus_objtype': ('main', {}),
    'coadd_fiberstatus': ('coadd', {}),
    'minsn': ('main', dict(minsn=5.0)),
    'targetid': ('main', dict(fit_targetid=np.array([TID0 + 1, TID0 + 9,
                                                     7]))),
    'expid': ('main', dict(expid_range=(101, 103))),
    'objtypes_main': ('main', dict(objtypes=['MWS_.*', 'STD_.*'])),
    'objtypes_sv3': ('sv3', dict(objtypes=['LRG.*', 'MWS_ANY'])),
    'objtypes_cmx': ('cmx', dict(objtypes=['STD_.*'])),
    'objtype_mask': ('main', dict(objtype_mask=(1 << 61) | 2)),
    'targetmask_tables': ('cmx', dict(
        objtypes=['SV0_.*'],
        target_tables={'CMX_TARGET': {'SV0_BGS': 8, 'SV0_MWS': 9}})),
    'zbest': ('main', dict(zbest=True)),
    'zbest_select': ('main', dict(zbest=True, zbest_select=True,
                                  minsn=0.0)),
}


@pytest.mark.parametrize('case', sorted(SELECT_CASES))
def test_select_fibers_matches_reference(case, tmp_path):
    variant, kw = SELECT_CASES[case]
    kw = dict(kw)
    fm, sns = _fibermap(variant)
    if kw.pop('zbest', False):
        kw['zbest_path'] = str(tmp_path / 'redrock-x.fits')
        _redrock(kw['zbest_path'])
    sel, rr = desi.select_fibers_to_fit(fm, sns, **kw)
    want_sel, want_rr = rdesi.select_fibers_to_fit(fm, sns, **kw)
    np.testing.assert_array_equal(sel, want_sel)
    assert 0 < sel.sum() < len(sel)
    assert list(rr) == list(want_rr)
    for k in rr:
        np.testing.assert_array_equal(rr[k], want_rr[k])


def test_objtypes_without_match_or_column_raise():
    fm, sns = _fibermap('main')
    with pytest.raises(ValueError, match='no DESI_TARGET names'):
        desi.select_fibers_to_fit(fm, sns, objtypes=['NOPE'])
    del fm['DESI_TARGET']
    with pytest.raises(RuntimeError, match='no target column'):
        desi.select_fibers_to_fit(fm, sns, objtypes=['MWS_.*'])


def test_load_targetmask_yaml_matches_reference(tmp_path):
    yml = tmp_path / 'tm.yaml'
    yml.write_text('cmx_mask:\n  - [SV0_MWS, 9, "x", {}]\n'
                   'sv1_desi_mask:\n  - [LRG_INIT_4PASS, 3, "x", {}]\n'
                   'bgs_mask:\n  - [BGS_FAINT, 0, "x", {}]\n')
    assert desi.load_targetmask_yaml(str(yml)) == \
        rdesi.load_targetmask_yaml(str(yml))


# ------------------------------------------------------------------
# arm building

def _raw_arms(seed, nfib=6, npix=300, resolution=False):
    rng = np.random.RandomState(seed)
    waves, fluxes, ivars, masks, res = {}, {}, {}, {}, {}
    for s, (l0, l1) in dict(b=(4200.0, 4600.0), r=(5000.0, 5300.0)).items():
        wave = np.linspace(l0, l1, npix)
        flux = (10 + rng.normal(size=(nfib, npix))).astype(np.float32)
        ivar = rng.uniform(0.5, 2.0, (nfib, npix)).astype(np.float32)
        mask = np.zeros((nfib, npix), np.int32)
        flux[1, 50:60] = np.nan                  # NaN pixels
        ivar[2, 10:20] = 0                       # no error
        ivar[3, 5] = 1e6                         # too small an error
        mask[2, 200:230] = 4                     # masked run
        mask[4] = 1                              # fully masked fiber
        flux[0, 0:3] = np.inf
        waves[s], fluxes[s], ivars[s], masks[s] = wave, flux, ivar, mask
        res[s] = np.stack([_gauss_band(1.5 + 0.1 * i, 11, npix)
                           for i in range(nfib)]).astype(np.float32) \
            if resolution else None
    return waves, fluxes, ivars, masks, res


@pytest.mark.parametrize('resolution', [False, True])
def test_build_batch_arms_matches_reference(resolution):
    waves, fluxes, ivars, masks, res = _raw_arms(1, resolution=resolution)
    subset = np.array([True, True, True, True, True, False])
    kw = dict(use_resolution_matrix=resolution,
              lsf_sigma0_angstrom={'b': 0.7, 'r': 0.9})
    arms, good = desi.build_batch_arms(waves, fluxes, ivars, masks, res,
                                       subset, ('b', 'r'), **kw)
    want, want_good = rdesi.build_batch_arms(waves, fluxes, ivars, masks,
                                             res, subset, ('b', 'r'), **kw)
    np.testing.assert_array_equal(good, want_good)
    assert not good[4] and good[:4].all()
    for a, w in zip(arms, want):
        assert (a.name, a.setup) == (w.name, w.setup)
        np.testing.assert_array_equal(a.lam, w.lam)
        np.testing.assert_allclose(a.flux, w.flux, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.ivar, w.ivar, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(a.badmask, w.badmask)
        if resolution:
            np.testing.assert_allclose(a.resolution, w.resolution,
                                       rtol=0, atol=1e-12)
        else:
            assert a.resolution is None and w.resolution is None


def test_resolution_bands_match_reference():
    rng = np.random.RandomState(2)
    mats = np.stack([_gauss_band(s, 11, 120) for s in (1.2, 1.7, 2.3)])
    mats *= rng.uniform(0.9, 1.1, mats.shape)
    kw = dict(sigma0_angstrom=0.6, pix_size_angstrom=0.8)
    np.testing.assert_allclose(
        desi.deconvolve_resolution_matrix(mats, **kw),
        rdesi.deconvolve_resolution_matrix(mats, **kw), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        desi.prepare_resolution_band(mats, **kw),
        rdesi.prepare_resolution_band(mats, **kw), rtol=0, atol=1e-12)
    # one fiber alone gives that fiber's rows of the stack
    np.testing.assert_allclose(desi.prepare_resolution_band(mats[1], **kw),
                               desi.prepare_resolution_band(mats, **kw)[1],
                               rtol=0, atol=1e-12)
    # row and column conventions are inverse of each other
    np.testing.assert_array_equal(
        desi._band_tocolumns(desi._band_torows(mats)), mats)
    np.testing.assert_array_equal(desi._band_torows(mats),
                                  rdesi._band_torows(mats))


def test_host_statistics_match_reference():
    rng = np.random.RandomState(4)
    x = rng.normal(size=(6, 50))
    good = rng.rand(6, 50) > 0.3
    good[2] = False
    x[0, :5] = np.inf
    x[1, :3] = np.nan
    np.testing.assert_array_equal(desi.masked_median(x, good),
                                  rcont.masked_median(x, good))
    lam = np.linspace(4000, 4100, 50)
    bad = ~good
    np.testing.assert_array_equal(desi.infill_bad_pixels(lam, x, bad),
                                  rcont.infill_bad_pixels(lam, x, bad))
    np.testing.assert_array_equal(desi.interpolate_bad_regions(x, bad),
                                  rdesi.interpolate_bad_regions(x, bad))


# ------------------------------------------------------------------
# S/N, warnings, columns, status lines

def test_get_sns_matches_reference():
    waves, fluxes, ivars, masks, _ = _raw_arms(6)
    for s in waves:
        np.testing.assert_array_equal(
            desi.get_sns(fluxes[s], ivars[s], masks[s]),
            rdesi.get_sns(fluxes[s], ivars[s], masks[s]))


@pytest.mark.parametrize('prefix', ['MEDIAN_CALIB_SNR_', 'MEDIAN_COADD_SNR_',
                                    'MEDIAN_COADD_FLUX_SNR_', 'OTHER_',
                                    None])
def test_get_sns_from_scores_matches_reference(prefix):
    scores = None if prefix is None else {
        prefix + s: np.arange(3.0) + i for i, s in enumerate('BRZ')}
    got = desi.get_sns_from_scores(scores, ('b', 'r', 'z'))
    want = rdesi.get_sns_from_scores(scores, ('b', 'r', 'z'))
    if want is None:
        assert got is None
    else:
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_rvs_warn_bits_and_column_desc_match_reference():
    rng = np.random.RandomState(7)
    n = 200
    res = dict(VRAD=rng.uniform(-1010, 1010, n),
               VRAD_ERR=rng.uniform(0, 150, n),
               VSINI=rng.uniform(0, 150, n),
               CHISQ_TOT=rng.uniform(0, 1000, n),
               CHISQ_C_TOT=rng.uniform(0, 1100, n),
               BAD_HESSIAN=rng.rand(n) > 0.8,
               TEFF=rng.uniform(2200, 15100, n),
               FEH=rng.uniform(-4.1, 1.1, n),
               LOGG=rng.uniform(-0.6, 6.6, n))
    cfg = dict(min_vel=-1000, max_vel=1000)
    got = desi.get_rvs_warn_batch(res, cfg)
    np.testing.assert_array_equal(got, rdesi.get_rvs_warn_batch(res, cfg))
    assert np.bitwise_or.reduce(got) == 1 | 2 | 4 | 8 | 16 | 64
    assert desi.bitmasks == rdesi.bitmasks
    for setups in (['B', 'R', 'Z'], ['B', 'R']):
        assert desi.get_column_desc(setups) == rdesi.get_column_desc(setups)


def test_status_lines_match_reference(tmp_path):
    for mod, name in ((desi, 'port'), (rdesi, 'ref')):
        path = str(tmp_path / name)
        mod.update_process_status_file(path, None, None, 0, 0, start=True)
        mod.update_process_status_file(path, 'a.fits', 'SUCCESS', 500,
                                       12.345, finished_at=1.5e9)
        mod.update_process_status_file(path, 'b.fits', 'FAILURE', 0, 0.1,
                                       finished_at=1.6e9 + 0.25)
    with open(tmp_path / 'port') as fa, open(tmp_path / 'ref') as fb:
        port = fa.read()
        assert port == fb.read()
    assert port == ('a.fits SUCCESS 500 12.35 1500000000.000\n'
                    'b.fits FAILURE 0 0.10 1600000000.250\n')


# ------------------------------------------------------------------
# writers

def _compare_fits(got_path, want_path):
    """Same HDUs, header cards (provenance aside), columns, dtypes,
    units and data."""
    got, want = fitsio.read(got_path), fitsio.read(want_path)
    assert got.names() == want.names()
    for hg, hw in zip(got.hdus, want.hdus):
        strip = lambda h: [c for c in h.cards
                           if not c[0].startswith(PROVENANCE)]
        assert strip(hg.header) == strip(hw.header)
        if isinstance(hw.data, dict):
            assert list(hg.data) == list(hw.data)
            for k in hw.data:
                assert hg.data[k].dtype == hw.data[k].dtype, k
                np.testing.assert_array_equal(hg.data[k], hw.data[k])
        elif hw.data is None:
            assert hg.data is None
        else:
            assert hg.data.dtype == hw.data.dtype
            np.testing.assert_array_equal(hg.data, hw.data)
    return got


def test_write_outputs_matches_reference(tmp_path):
    rng = np.random.RandomState(8)
    n, setups = 4, ('b', 'r')
    idx = np.array([0, 2, 3, 5])
    fibermap = dict(TARGETID=np.arange(6, dtype=np.int64) + TID0,
                    TARGET_RA=rng.uniform(0, 360, 6),
                    FIBER=np.arange(6, dtype=np.int32),
                    DESI_TARGET=np.full(6, 1 << 61, np.int64),
                    OBJTYPE=np.array(['TGT'] * 6))
    res = dict(VRAD=rng.normal(size=n), VRAD_ERR=rng.uniform(1, 2, n),
               TEFF=rng.uniform(4000, 6000, n),
               CHISQ_TOT=rng.uniform(size=n), SUCCESS=np.ones(n, bool),
               RVS_WARN=np.array([0, 1, 64, 32]),
               BAD_HESSIAN=np.array([0, 0, 1, 0], bool),
               TARGETID=fibermap['TARGETID'][idx],
               RR_SPECTYPE=np.array(['STAR', 'GALAXY', '', 'QSO'],
                                    dtype=object),
               EXTRA=rng.normal(size=n))
    arms = [types.SimpleNamespace(name=f'desi_{s}') for s in setups]
    waves = {s: np.linspace(4000 + 1000 * i, 4500 + 1000 * i, 30)
             for i, s in enumerate(setups)}
    mods = dict(models={a.name: rng.normal(size=(n, 30)) for a in arms})
    scores = dict(MEDIAN_CALIB_SNR_B=rng.uniform(size=6))
    exp_fm = dict(TARGETID=np.repeat(fibermap['TARGETID'], 2),
                  EXPID=np.arange(12, dtype=np.int64))
    templates = {f'desi_{s}': types.SimpleNamespace(
        extra=dict(revision='r1', creation_soft_version='v2'))
        for s in setups}
    header = rfits.Header([('TILEID', 80605, ''), ('NIGHT', 20210101, ''),
                           ('OTHER', 1, '')])
    paths = {}
    for mod, name in ((desi, 'port'), (rdesi, 'ref')):
        paths[name] = (str(tmp_path / f'{name}-tab.fits'),
                       str(tmp_path / f'{name}-mod.fits'))
        mod._write_outputs(*paths[name], res, mods, arms, waves, fibermap,
                           idx, setups, dict(config_file_path='/c.yaml'),
                           'coadd-x.fits', scores=scores,
                           exp_fibermap=exp_fm, cmdline='prog --x',
                           templates=templates, spectrum_header=header,
                           zbest_path='redrock-x.fits')
    tab = _compare_fits(paths['port'][0], paths['ref'][0])
    _compare_fits(paths['port'][1], paths['ref'][1])
    hdr = tab[0].header
    assert hdr['TMPLREV0'] == 'r1' and hdr['TILEID'] == 80605
    assert hdr['RVS_VER'] == desi.__version__
    deps = {hdr[k] for k in hdr.keys() if k.startswith('DEPNAM')}
    assert {'python', 'rvspecfit_torch', 'numpy', 'torch'} <= deps
    assert 'jax' not in deps


# ------------------------------------------------------------------
# the driver on the CPU

@pytest.fixture(scope='module')
def coadds(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_coadds')
    files = {}
    for name, seed, res in (('a', 11, False), ('b', 12, False),
                            ('res', 21, True)):
        path = str(root / f'coadd-{name}.fits')
        files[name] = (path, write_coadd(path, seed, resolution=res,
                                         nfib=4 if res else NFIB))
    return files


def _main(files, outdir, lib, *extra):
    desi.main(list(files) + ['--output_dir', str(outdir), '--templ_lib', lib,
                             '--device', 'cpu'] + list(extra))


def _status(path):
    with open(path) as fp:
        return [ln.split() for ln in fp.read().strip().splitlines()]


@pytest.fixture(scope='module')
def e2e(coadds, desi_library, tmp_path_factory):
    """``main`` over coadds a and b at --coalesce 2 (one group), and
    the same files at --coalesce 1."""
    root = tmp_path_factory.mktemp('torch_e2e')
    names = [coadds['a'][0], coadds['b'][0]]
    out = {}
    for coal in ('2', '1'):
        outdir = root / f'out{coal}'
        status = str(root / f'status{coal}.txt')
        _main(names, outdir, desi_library, '--process_status_file', status,
              '--coalesce', coal, '--throw_exceptions')
        out[coal] = (outdir, status)
    return out


def test_driver_recovers_rvs_and_writes_the_reference_schema(coadds, e2e):
    outdir, _ = e2e['2']
    truth = coadds['a'][1]
    tab = fitsio.read(os.path.join(outdir, 'rvtab-a.fits'))
    rv = tab['RVTAB'].data
    # the fully masked fiber has S/N -1e9 and is not selected
    np.testing.assert_array_equal(rv['TARGETID'],
                                  np.arange(NFIB - 1) + TID0)
    dv = rv['VRAD'] - truth['vel'][:NFIB - 1]
    assert (np.abs(dv) < np.maximum(10, 5 * rv['VRAD_ERR'])).all()
    assert rv['SUCCESS'].all()
    desc = rdesi.get_column_desc(['B', 'R', 'Z'])
    absent = {'EXPID', 'RR_Z', 'RR_SPECTYPE', 'RR_SUBTYPE'}
    assert set(rv) == set(desc) - absent
    hdr = tab['RVTAB'].header
    tfields = {str(hdr[f'TTYPE{i}']): i
               for i in range(1, int(hdr['TFIELDS']) + 1)}
    for k, (dtype, _, unit) in desc.items():
        if k in absent:
            continue
        assert rv[k].dtype == np.dtype(dtype), k
        assert hdr.get(f'TUNIT{tfields[k]}', '') == unit, k
    mod = fitsio.read(os.path.join(outdir, 'rvmod-a.fits'))
    for s in DESI_ARMS:
        m = mod[f'{s.upper()}_MODEL'].data
        assert m.shape == (NFIB - 1, 400) and m.dtype == np.float32
        assert np.isfinite(m).all()
    # passthrough of the fitted targets' FIBERMAP, SCORES, EXP_FIBERMAP
    np.testing.assert_array_equal(tab['FIBERMAP'].data['TARGETID'],
                                  rv['TARGETID'])
    np.testing.assert_allclose(tab['SCORES'].data['MEDIAN_CALIB_SNR_B'], 80)
    ef = tab['EXP_FIBERMAP'].data
    np.testing.assert_array_equal(ef['TARGETID'],
                                  np.repeat(rv['TARGETID'], 2))
    np.testing.assert_allclose(rv['SN_B'], 80.0)
    assert tab[0].header['TILEID'] == 80605
    assert tab[0].header['RVS_CMD'].startswith('rvstorch_desi_fit')


def test_status_file_and_coalesce_match_per_file(coadds, e2e):
    for coal in ('2', '1'):
        lines = _status(e2e[coal][1])
        assert [ln[0] for ln in lines] == [coadds['a'][0], coadds['b'][0]]
        assert all(len(ln) == 5 and ln[1] == 'SUCCESS' and ln[2] == '4'
                   for ln in lines)
        assert float(lines[0][4]) <= float(lines[1][4])
    for name in ('a', 'b'):
        grp = fitsio.read(os.path.join(e2e['2'][0], f'rvtab-{name}.fits'))
        one = fitsio.read(os.path.join(e2e['1'][0], f'rvtab-{name}.fits'))
        g, o = grp['RVTAB'].data, one['RVTAB'].data
        assert list(g) == list(o)
        for k in g:
            if g[k].dtype.kind == 'f':
                np.testing.assert_allclose(g[k], o[k], rtol=1e-7,
                                           atol=1e-7, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], o[k], err_msg=k)


def test_skipexisting_writes_existing(coadds, e2e, desi_library, tmp_path):
    outdir, _ = e2e['2']
    status = str(tmp_path / 'status.txt')
    _main([coadds['a'][0]], outdir, desi_library, '--skipexisting',
          '--process_status_file', status, '--throw_exceptions')
    assert [ln[:3] for ln in _status(status)] == \
        [[coadds['a'][0], 'EXISTING', '0']]


@pytest.mark.parametrize('coalesce', ['1', '2'])
def test_corrupt_file_fails_and_the_next_is_fitted(coadds, desi_library,
                                                   tmp_path, monkeypatch,
                                                   coalesce):
    bad = str(tmp_path / 'coadd-broken.fits')
    with open(bad, 'w') as fp:
        fp.write('this is not a FITS file')
    status = str(tmp_path / 'status.txt')
    monkeypatch.chdir(tmp_path)                 # crash logs land here
    _main([bad, coadds['a'][0]], tmp_path / 'out', desi_library,
          '--targetid', str(TID0 + 2), '--process_status_file', status,
          '--coalesce', coalesce)
    stat = {ln[0]: ln[1:3] for ln in _status(status)}
    assert stat == {bad: ['FAILURE', '0'], coadds['a'][0]: ['SUCCESS', '1']}
    assert any(p.name.startswith('crash_') for p in tmp_path.iterdir())
    rv = fitsio.read(str(tmp_path / 'out' / 'rvtab-a.fits'))['RVTAB'].data
    assert list(rv['TARGETID']) == [TID0 + 2]


def test_ccf_failure_gives_failure_not_default_starts(coadds, desi_library,
                                                     tmp_path, monkeypatch):
    """The reference starts every fiber at default parameters when its
    CCF raises; the port raises, so the file gets a FAILURE line."""
    def broken(*args, **kwargs):
        raise RuntimeError('CCF kernel failed')
    monkeypatch.setattr(desi.ccf_mod, 'fit_batch', broken)
    monkeypatch.chdir(tmp_path)
    status = str(tmp_path / 'status.txt')
    _main([coadds['a'][0]], tmp_path / 'out', desi_library,
          '--process_status_file', status)
    assert [ln[1] for ln in _status(status)] == ['FAILURE']
    assert not os.path.exists(tmp_path / 'out' / 'rvtab-a.fits')
    with pytest.raises(RuntimeError, match='CCF kernel failed'):
        _main([coadds['a'][0]], tmp_path / 'out', desi_library,
              '--throw_exceptions')


def test_template_loading_failure_raises(coadds, tmp_path):
    with pytest.raises(RuntimeError, match='does not exist'):
        _main([coadds['a'][0]], tmp_path / 'out', str(tmp_path / 'nolib'))


def test_resolution_matrix_recovers_rvs(coadds, desi_library, tmp_path):
    fname, truth = coadds['res']
    cfg = tmp_path / 'config.yaml'
    cfg.write_text('lsf_sigma0_angstrom: {b: 1.0616, r: 1.0616, '
                   'z: 1.0616}\nsecond_minimizer: false\n')
    _main([fname], tmp_path / 'out', desi_library, '--resolution_matrix',
          '--config', str(cfg), '--throw_exceptions')
    rv = fitsio.read(str(tmp_path / 'out' / 'rvtab-res.fits'))['RVTAB'].data
    assert len(rv['VRAD']) == 4
    dv = rv['VRAD'] - truth['vel']
    assert (np.abs(dv) < np.maximum(10, 5 * rv['VRAD_ERR'])).all()


def test_zbest_select_reads_the_redrock_file_beside_the_coadd(
        coadds, desi_library, tmp_path):
    fname = str(tmp_path / 'coadd-a.fits')
    with open(coadds['a'][0], 'rb') as src, open(fname, 'wb') as dst:
        dst.write(src.read())
    tids = np.arange(3, dtype=np.int64) + TID0
    fitsio.write(str(tmp_path / 'redrock-a.fits'), [
        dict(kind='image', data=None),
        dict(kind='table', name='REDSHIFTS', data=[
            ('TARGETID', tids), ('Z', np.array([1e-4, 0.5, -2e-4])),
            ('SPECTYPE', np.array(['STAR', 'GALAXY', 'STAR'])),
            ('SUBTYPE', np.array(['G', '', 'K']))])])
    _main([fname], tmp_path / 'out', desi_library, '--zbest_select',
          '--throw_exceptions')
    tab = fitsio.read(str(tmp_path / 'out' / 'rvtab-a.fits'))
    rv = tab['RVTAB'].data
    np.testing.assert_array_equal(rv['TARGETID'], tids[[0, 2]])
    assert list(rv['RR_SPECTYPE']) == ['STAR', 'STAR']
    assert list(rv['RR_SUBTYPE']) == ['G', 'K']
    assert rv['RR_Z'].dtype == np.float64
    # a card holds 68 characters of a string value
    assert str(tmp_path / 'redrock-a.fits').startswith(
        tab[0].header['RR_FILE'])


def test_empty_selection_matches_reference_main(coadds, desi_library,
                                                tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fname = coadds['a'][0]
    _main([fname], tmp_path / 'port', desi_library, '--minsn', '1e9',
          '--throw_exceptions')
    rdesi.main([fname, '--output_dir', str(tmp_path / 'ref'),
                '--templ_lib', desi_library, '--minsn', '1e9',
                '--throw_exceptions'])
    for kind in ('rvtab', 'rvmod'):
        got = _compare_fits(str(tmp_path / 'port' / f'{kind}-a.fits'),
                            str(tmp_path / 'ref' / f'{kind}-a.fits'))
        assert got[0].header['TMPLCON0'] == 'desi_b'
    rv = fitsio.read(str(tmp_path / 'port' / 'rvtab-a.fits'))['RVTAB'].data
    assert set(rv) == set(desi.get_column_desc(['B', 'R', 'Z']))
    assert all(len(v) == 0 for v in rv.values())


# ------------------------------------------------------------------
# command line, config, file lists, loaders

def test_main_needs_the_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        desi.main(['x.fits', '--output_dir', str(tmp_path)])
    assert not os.path.exists(tmp_path / 'rvtab-x.fits')


def _record_main(main, mod, dist, argv, monkeypatch):
    """Run a driver's ``main`` with its proc_many and world stubbed:
    what it passed on ({'exit': True} when it exited through the
    parser)."""
    calls = {}
    monkeypatch.setattr(mod, 'proc_many', lambda files, outdir, **kw:
                        calls.update(files=files, kw=kw))
    monkeypatch.setattr(dist, 'init_distributed',
                        lambda coord=None, n=None, p=None:
                        calls.update(init=(coord, n, p)) or (1, 3))
    monkeypatch.setattr(dist, 'barrier', lambda name=None, timeout_ms=None:
                        calls.update(barrier=name))
    monkeypatch.setattr(dist, 'shutdown', lambda *a: calls.update(shut=1))
    try:
        main(argv)
    except SystemExit:
        calls['exit'] = True
    return calls


@pytest.mark.parametrize('option', [['--queue_file'], ['--dynamic_queue'],
                                    ['--rank', '0'], ['--world', '2'],
                                    ['--coordinator', 'h:1'], ['--doplot'],
                                    ['--figure_dir', 'f'],
                                    ['--param_init', 'random']])
def test_left_out_options_are_refused(option, tmp_path, monkeypatch):
    """Of these options only an unknown ``--param_init`` is still
    refused: the queue, world and plot options are ported, and with a
    file on the command line each one reaches proc_many as in the
    reference's ``main`` (the same queue class; the world opened and,
    after the run, the barrier passed and the world closed)."""
    from rvspecfit_tpu.parallel import distributed as rdist
    from rvspecfit_torch.parallel import distributed as pdist
    argv = ['x.fits', '--output_dir', str(tmp_path)] + option
    want = _record_main(rdesi.main, rdesi, rdist, argv, monkeypatch)
    got = _record_main(desi.main, desi, pdist, argv + ['--device', 'cpu'],
                       monkeypatch)
    assert got.get('exit') == want.get('exit')
    assert bool(got.get('exit')) == (option[0] == '--param_init')
    if got.get('exit'):
        return
    assert type(got['files']).__name__ == type(want['files']).__name__
    assert list(got['files']) == list(want['files']) == ['x.fits']
    assert ('init' in got) == ('init' in want) == \
        (option[0] == '--coordinator')
    if 'init' in got:
        assert got['init'] == want['init'] == ('h:1', None, None)
        assert got['barrier'] == 'rvstorch_desi_fit_done'
        assert got['shut'] == want['shut'] == 1
    assert got['kw']['doplot'] == want['kw']['doplot_figs']
    assert got['kw']['figure_dir'] == want['kw']['figure_dir']


def test_bruteforce_start_is_the_reference_firstguess(coadds,
                                                     desi_library):
    """``--param_init bruteforce``: every fiber starts at fiber 0's
    vel_fit.firstguess and velocity 0; that guess equals the
    reference's firstguess on the same arms."""
    from rvspecfit_tpu.fit import vel_fit as rvf
    from rvspecfit_tpu.fit.spec_data import SpecData as RSpecData
    from rvspecfit_tpu.pipeline import library as rlib
    cfg = utils.read_config(None, {'template_lib': desi_library})
    prep = desi._prepare_one(coadds['a'][0], cfg)
    arms = prep['arms']
    setups = [a.setup for a in arms]
    templates = library.load_template_models(cfg, setups, device='cpu')
    parnames = templates[setups[0]].parnames
    params, vel, vsini, has_vs = desi.bruteforce_starts(
        arms, parnames, templates, cfg, {'npoly': 10})
    want = rvf.firstguess(
        [RSpecData(a.setup, a.lam, a.flux[0], 1.0 / np.sqrt(a.ivar[0]))
         for a in arms], config=cfg, options={'npoly': 10},
        templates=rlib.load_template_models(cfg, set(setups)))
    np.testing.assert_array_equal(
        params, np.tile([want[p] for p in parnames], (len(vel), 1)))
    assert (vel == 0).all()
    assert has_vs.all() == ('vsini' in want)
    np.testing.assert_array_equal(vsini, want.get('vsini') or 0.0)


def test_param_init_bruteforce_runs_main(coadds, desi_library, tmp_path):
    """``main --param_init bruteforce`` on the CPU: every selected fiber
    recovered within max(10 km/s, 5 sigma), no CCF columns but
    VRAD_CCF (0), the status line SUCCESS."""
    status = str(tmp_path / 'status.txt')
    _main([coadds['a'][0]], tmp_path / 'out', desi_library,
          '--param_init', 'bruteforce', '--process_status_file', status,
          '--throw_exceptions')
    rv = fitsio.read(str(tmp_path / 'out' / 'rvtab-a.fits'))['RVTAB'].data
    truth = coadds['a'][1]
    dv = rv['VRAD'] - truth['vel'][:NFIB - 1]
    assert (np.abs(dv) < np.maximum(10, 5 * rv['VRAD_ERR'])).all()
    assert not any(k.endswith('_CCF') and k != 'VRAD_CCF' for k in rv)
    assert (rv['VRAD_CCF'] == 0).all()
    assert [ln[1:3] for ln in _status(status)] == [['SUCCESS', '4']]


def test_version_and_ignored_nthreads(capsys, tmp_path):
    desi.main(['--version', '--output_dir', str(tmp_path), '--nthreads',
               '4'])
    assert capsys.readouterr().out.strip() == desi.__version__
    with pytest.raises(SystemExit):
        desi.main(['--output_dir', str(tmp_path), '--device', 'cpu'])


def _thaw(d):
    return {k: _thaw(v) if hasattr(v, 'items') else v for k, v in d.items()}


def test_read_config_and_file_queue(tmp_path, monkeypatch):
    from rvspecfit_tpu import utils as rutils
    monkeypatch.chdir(tmp_path)
    assert _thaw(utils.read_config()) == _thaw(rutils.read_config())
    cfg = tmp_path / 'c.yaml'
    cfg.write_text('max_vel: 500\nlsf_sigma0_angstrom: {b: 1.0}\n'
                   'extra: [1, 2]\n')
    got = utils.read_config(str(cfg), {'template_lib': 'lib'})
    assert _thaw(got) == _thaw(rutils.read_config(str(cfg),
                                                  {'template_lib': 'lib'}))
    assert got['max_vel'] == 500 and got['extra'] == (1, 2)
    assert hash(got) == hash(utils.freeze(dict(got)))
    with pytest.raises(RuntimeError, match='not found'):
        utils.read_config(str(tmp_path / 'missing.yaml'))
    lst = tmp_path / 'files.txt'
    lst.write_text('a.fits\n\nb.fits\n')
    assert list(utils.FileQueue(file_from=str(lst))) == ['a.fits', 'b.fits']
    assert list(utils.FileQueue(file_list=['c'])) == ['c']


def test_load_template_models_carries_provenance(desi_library):
    from rvspecfit_tpu.pipeline import library as rlib
    cfg = dict(template_lib=desi_library)
    tms = library.load_template_models(cfg, ['desi_b', 'desi_r'],
                                       device='cpu')
    assert sorted(tms) == ['desi_b', 'desi_r']
    want = rlib.load_template_model('desi_b', cfg).extra
    got = tms['desi_b'].extra
    assert got == {k: want[k] for k in ('revision', 'creation_soft_version')}
    assert tms['desi_b'].geom.h.device.type == 'cpu'


# ------------------------------------------------------------------
# fleets: file queues, ranks and worlds; plots; --overwrite

def test_queue_file_with_crash_isolation(coadds, desi_library, tmp_path,
                                         monkeypatch):
    """``--queue_file``: the lock-file queue is popped empty; a corrupt
    file gets a crash log and a FAILURE line and the next one is fitted
    (the reference's test_desi_queue_mode_and_crash_isolation)."""
    bad = str(tmp_path / 'coadd-broken.fits')
    with open(bad, 'w') as fp:
        fp.write('this is not a FITS file')
    qfile = tmp_path / 'queue.txt'
    qfile.write_text(f'{bad}\n{coadds["a"][0]}\n')
    status = str(tmp_path / 'status.txt')
    monkeypatch.chdir(tmp_path)                 # crash logs land here
    _main([], tmp_path / 'out', desi_library, '--input_file_from',
          str(qfile), '--queue_file', '--targetid', str(TID0 + 1),
          '--process_status_file', status)
    stat = {ln[0]: ln[1:3] for ln in _status(status)}
    assert stat == {bad: ['FAILURE', '0'], coadds['a'][0]: ['SUCCESS', '1']}
    assert qfile.read_text() == ''
    assert any(p.name.startswith('crash_') for p in tmp_path.iterdir())
    rv = fitsio.read(str(tmp_path / 'out' / 'rvtab-a.fits'))['RVTAB'].data
    assert list(rv['TARGETID']) == [TID0 + 1]


def test_status_file_takes_the_rank(coadds, desi_library, tmp_path):
    """``%d`` in --process_status_file (and --log) becomes the rank
    (the reference's test_desi_status_file_rank_substitution)."""
    status = str(tmp_path / 'status_%d.txt')
    _main([coadds['a'][0]], tmp_path / 'out', desi_library,
          '--process_status_file', status, '--rank', '3', '--world', '4',
          '--minsn', '1e9', '--throw_exceptions')
    assert [ln[:3] for ln in _status(str(tmp_path / 'status_3.txt'))] == \
        [[coadds['a'][0], 'SUCCESS', '0']]
    assert desi.per_rank('log_%d.txt', 2) == 'log_2.txt'
    assert desi.per_rank('log.txt', 2) == 'log.txt'
    assert desi.per_rank('log_%d.txt', None) == 'log_%d.txt'


@pytest.mark.parametrize('rank,world', [('0', '2'), ('1', '2'), ('2', '3')])
def test_rank_and_world_shard_the_list_as_the_reference(rank, world,
                                                        tmp_path,
                                                        monkeypatch):
    from rvspecfit_tpu.parallel import distributed as rdist
    from rvspecfit_torch.parallel import distributed as pdist
    lst = tmp_path / 'files.txt'
    lst.write_text(''.join(f'coadd-{i}.fits\n' for i in range(7)))
    argv = ['--input_file_from', str(lst), '--output_dir', str(tmp_path),
            '--rank', rank, '--world', world]
    want = _record_main(rdesi.main, rdesi, rdist, argv, monkeypatch)
    got = _record_main(desi.main, desi, pdist, argv + ['--device', 'cpu'],
                       monkeypatch)
    assert type(got['files']).__name__ == 'ShardedFileQueue'
    assert list(got['files']) == list(want['files']) == \
        [f'coadd-{i}.fits' for i in range(7)][int(rank)::int(world)]
    assert 'init' not in got


def test_coordinator_wiring_with_the_world_mocked(tmp_path, monkeypatch):
    """``--coordinator`` with ``--dynamic_queue``: the world's rank and
    size become the run's, the list goes into a CoordinatedFileQueue,
    the status file gets the rank, and the barrier and the shutdown run
    after the run, also when it fails; a dynamic queue without a world
    raises."""
    from rvspecfit_torch.parallel import distributed as pdist
    lst = tmp_path / 'files.txt'
    lst.write_text('coadd-0.fits\ncoadd-1.fits\n')

    class Queue(list):
        pass
    monkeypatch.setattr(pdist, 'CoordinatedFileQueue', Queue)
    argv = ['--input_file_from', str(lst), '--output_dir', str(tmp_path),
            '--coordinator', 'localhost:1234', '--dynamic_queue',
            '--process_status_file', str(tmp_path / 'status_%d.txt'),
            '--device', 'cpu']
    calls = _record_main(desi.main, desi, pdist, argv, monkeypatch)
    assert calls['init'] == ('localhost:1234', None, None)
    assert isinstance(calls['files'], Queue)
    assert list(calls['files']) == ['coadd-0.fits', 'coadd-1.fits']
    assert calls['kw']['status_fname'] == str(tmp_path / 'status_1.txt')
    assert calls['barrier'] == 'rvstorch_desi_fit_done' and calls['shut']

    def failing(files, outdir, **kw):
        raise RuntimeError('fit failed')
    monkeypatch.setattr(desi, 'proc_many', failing)
    calls.clear()
    with pytest.raises(RuntimeError, match='fit failed'):
        desi.main(argv)
    assert calls['barrier'] == 'rvstorch_desi_fit_done' and calls['shut']
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match='multi-process world'):
        desi.main(argv[:4] + ['--dynamic_queue', '--device', 'cpu'])


def test_proc_many_claims_no_queue_item_before_the_previous_is_fitted(
        tmp_path, monkeypatch, caplog):
    """A queue's items are claimed one at a time, each after the
    previous file is fitted, at coalesce 1 with a log line (an early
    claim would take work from the other ranks); a static list is read
    up front and fitted in groups.  The fits are stubs that follow the
    drivers' protocol: with ``defer_finish`` they return their counts
    with the finish that proc_many's writer runs."""
    events = []

    def queue():
        for f in ('coadd-a.fits', 'coadd-b.fits', 'coadd-c.fits'):
            events.append(('claim', f))
            yield f

    def deferred(count, defer_finish):
        return (count, lambda: count) if defer_finish else count

    def fit_one(f, tab, mod, *args, defer_finish=False, **kw):
        events.append(('fit', f))
        return deferred(1, defer_finish)

    def fit_group(gprep, *args, defer_finish=False, **kw):
        events.append(('fit', tuple(gprep['fnames'])))
        return deferred([1] * len(gprep['fnames']), defer_finish)
    monkeypatch.setattr(desi, 'proc_desi_wrapper', fit_one)
    monkeypatch.setattr(desi, 'prepare_desi_group',
                        lambda fnames, *a, **k: dict(fnames=fnames))
    monkeypatch.setattr(desi, 'fit_desi_group', fit_group)
    model = types.SimpleNamespace(geom=types.SimpleNamespace(
        h=torch.zeros(1)))
    kw = dict(config={}, templates={'desi_b': model}, coalesce=2)
    with caplog.at_level('INFO'):
        desi.proc_many(queue(), str(tmp_path), **kw)
    assert events == [(k, f) for f in ('coadd-a.fits', 'coadd-b.fits',
                                       'coadd-c.fits')
                      for k in ('claim', 'fit')]
    assert 'queue inputs are fitted one file at a time' in caplog.text

    # the lock-file queue: the second line is still in the file while
    # the first file is fitted
    qfile = tmp_path / 'queue.txt'
    qfile.write_text('coadd-a.fits\ncoadd-b.fits\n')
    seen = []
    monkeypatch.setattr(desi, 'proc_desi_wrapper', lambda f, *a, **k:
                        seen.append((f, qfile.read_text()))
                        or deferred(1, k.get('defer_finish')))
    desi.proc_many(utils.FileQueue(file_from=str(qfile), queue=True),
                   str(tmp_path), **kw)
    assert seen == [('coadd-a.fits', 'coadd-b.fits\n'),
                    ('coadd-b.fits', '')]

    events.clear()
    desi.proc_many(list(queue()), str(tmp_path), **kw)
    assert events == [('claim', 'coadd-a.fits'), ('claim', 'coadd-b.fits'),
                      ('claim', 'coadd-c.fits'),
                      ('fit', ('coadd-a.fits', 'coadd-b.fits')),
                      ('fit', ('coadd-c.fits',))]


def test_overwrite_warns_as_the_reference(coadds, desi_library, tmp_path,
                                          caplog):
    _main([coadds['a'][0]], tmp_path / 'out', desi_library, '--minsn',
          '1e9', '--overwrite', 'yes', '--throw_exceptions')
    assert 'overwrite keyword is meaningless now' in caplog.text
    assert os.path.exists(tmp_path / 'out' / 'rvtab-a.fits')


def test_doplot_writes_figures(coadds, desi_library, tmp_path):
    """``--doplot``: one PNG per fitted fiber in --figure_dir, named
    {figure_prefix}-{file}_{TARGETID}.png, as the reference names them;
    without --figure_dir they go to the output directory."""
    _main([coadds['a'][0]], tmp_path / 'out', desi_library, '--doplot',
          '--figure_dir', str(tmp_path / 'figs'), '--figure_prefix', 'p',
          '--targetid', str(TID0 + 2), '--throw_exceptions')
    fig = tmp_path / 'figs' / f'p-a_{TID0 + 2}.png'
    assert fig.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
    _main([coadds['a'][0]], tmp_path / 'out2', desi_library, '--doplot',
          '--targetid', str(TID0 + 2), '--coalesce', '2',
          '--throw_exceptions')
    assert os.path.exists(tmp_path / 'out2' / f'fig-a_{TID0 + 2}.png')


_RANK = r"""
import sys
sys.modules['jax'] = None
sys.modules['rvspecfit_tpu'] = None
from rvspecfit_torch.survey import desi
desi.main(sys.argv[1:])
"""


def test_two_process_fleet_on_the_cpu(coadds, desi_library, tmp_path):
    """Two ``rvstorch_desi_fit --device cpu`` processes (jax and the JAX
    package blocked) over a world on this host claim two files through
    --dynamic_queue: each file is fitted once, per-rank status files,
    RV recovery."""
    import shutil
    import subprocess
    import sys
    from test_torch_distributed import _free_port
    files = [coadds['a'][0], str(tmp_path / 'coadd-a2.fits')]
    shutil.copy(files[0], files[1])
    lst = tmp_path / 'files.txt'
    lst.write_text(''.join(f + '\n' for f in files))
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK, '--input_file_from', str(lst),
         '--output_dir', str(tmp_path / 'out'), '--templ_lib',
         desi_library, '--device', 'cpu', '--dynamic_queue',
         '--coordinator', f'127.0.0.1:{port}', '--rank', str(rank),
         '--world', '2', '--process_status_file',
         str(tmp_path / 'status_%d.txt'), '--throw_exceptions'],
        cwd=repo) for rank in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    lines = sum((_status(str(tmp_path / f'status_{r}.txt'))
                 for r in range(2)), [])
    assert sorted(ln[0] for ln in lines) == sorted(files)
    assert all(ln[1:3] == ['SUCCESS', str(NFIB - 1)] for ln in lines)
    truth = coadds['a'][1]
    for base in ('a', 'a2'):
        rv = fitsio.read(str(tmp_path / 'out' / f'rvtab-{base}.fits'))[
            'RVTAB'].data
        dv = rv['VRAD'] - truth['vel'][:NFIB - 1]
        assert (np.abs(dv) < np.maximum(10, 5 * rv['VRAD_ERR'])).all()


# ------------------------------------------------------------------
# fitted values against the reference's driver

@pytest.mark.slow
def test_driver_matches_reference_driver(coadds, desi_library, tmp_path,
                                         monkeypatch):
    """The port's ``main`` against the reference's synchronous ``main``
    (RVST_DEFER_TAIL=0 RVST_PIPELINE_PREP=0 RVST_ASYNC_WRITE=0) on the
    same coadd: TARGETID order, SUCCESS and RVS_WARN equal; velocities
    within 1e-6 km/s, parameters and errors within rtol 1e-6 (the
    tolerances of test_torch_tail's group-fit parity)."""
    for k in ('RVST_DEFER_TAIL', 'RVST_PIPELINE_PREP', 'RVST_ASYNC_WRITE'):
        monkeypatch.setenv(k, '0')
    monkeypatch.chdir(tmp_path)
    fname = coadds['a'][0]
    _main([fname], tmp_path / 'port', desi_library, '--throw_exceptions')
    rdesi.main([fname, '--output_dir', str(tmp_path / 'ref'),
                '--templ_lib', desi_library, '--throw_exceptions'])
    got = fitsio.read(str(tmp_path / 'port' / 'rvtab-a.fits'))['RVTAB'].data
    want = fitsio.read(str(tmp_path / 'ref' / 'rvtab-a.fits'))['RVTAB'].data
    assert list(got) == list(want)
    for k in ('TARGETID', 'SUCCESS', 'RVS_WARN'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got['VRAD'], want['VRAD'], rtol=0, atol=1e-6)
    for k in ('TEFF', 'LOGG', 'FEH', 'ALPHAFE', 'VRAD_ERR', 'TEFF_ERR',
              'LOGG_ERR', 'FEH_ERR', 'ALPHAFE_ERR'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
