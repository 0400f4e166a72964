"""``rvstorch_prewarm``: get a fresh process of a fleet ready to fit.

Counterpart of rvspecfit_tpu/pipeline/prewarm.py.  The reference fills
XLA's persistent compilation cache; the port has no such cache, and
what a first file pays for is the build of the CUDA kernels
(ops/cuda_build.load: once per source hash into
``rvspecfit_torch/_build/``, then reused by every process) and the
first uses of the library calls (cuFFT plans, cuBLAS and cuSOLVER
handles) at the data's shapes.  So :func:`main` builds both kernel
libraries and then fits one synthetic exposure shaped like the data
(the same arm wavelength grids, fiber count and options) through the
production driver (survey/desi.proc_many) in a throwaway directory.

Shapes come from ``--like <coadd.fits>`` (only its wavelength grids and
RESOLUTION band widths are read; the spectra are synthetic) or from the
template library's own setup grids (``--setups``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import logging
import os
import shutil
import sys
import tempfile
import time

import numpy as np

C_KMS = 299792.458


def synth_coadd_like(out_fname, waves, nfibers, resol_ndiag=None,
                     seed=0):
    """Write a synthetic DESI-format coadd with the given per-setup
    wavelength grids (dict name -> (npix,) array): fake stars at S/N 50
    drawn from ``RandomState(seed)`` in the reference's order, so the
    arrays equal the reference's for the same seed.  ``resol_ndiag``
    (dict name -> int or None) adds a Gaussian band RESOLUTION extension
    of that width."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.io import fitsio

    rng = np.random.RandomState(seed)
    vel = rng.uniform(-300, 300, nfibers)
    teff = rng.uniform(4500, 9500, nfibers)
    logg = rng.uniform(1.0, 4.8, nfibers)
    feh = rng.uniform(-1.9, -0.1, nfibers)
    alpha = rng.uniform(0.05, 0.95, nfibers)

    hdus = [dict(kind='image', data=None)]
    for s, lam in waves.items():
        su = s.upper()
        npix = len(lam)
        flux = np.zeros((nfibers, npix), np.float32)
        for i in range(nfibers):
            lam_rest = lam / (1 + vel[i] / C_KMS)
            sp = simulation.fake_spectrum(lam_rest, teff[i], logg[i],
                                          feh[i], alpha[i], wresol=2.0)
            flux[i] = sp + rng.normal(size=npix) * (sp / 50.0)
        esp = np.abs(flux) / 50.0 + 1e-10
        hdus += [
            dict(kind='image', data=lam, name=f'{su}_WAVELENGTH'),
            dict(kind='image', data=flux, name=f'{su}_FLUX'),
            dict(kind='image', data=(1.0 / esp**2).astype(np.float32),
                 name=f'{su}_IVAR'),
            dict(kind='image', data=np.zeros((nfibers, npix), np.int32),
                 name=f'{su}_MASK')]
        nd = (resol_ndiag or {}).get(s)
        if nd:
            x = np.arange(nd) - nd // 2
            band = np.exp(-0.5 * (x / 1.5)**2)
            band /= band.sum()
            res = np.tile(band[None, :, None],
                          (nfibers, 1, npix)).astype(np.float32)
            hdus.append(dict(kind='image', data=res,
                             name=f'{su}_RESOLUTION'))
    hdus.append(dict(kind='table', name='FIBERMAP', data=[
        ('TARGETID', np.arange(nfibers, dtype=np.int64) + 1),
        ('TARGET_RA', np.linspace(0.0, 359.0, nfibers)),
        ('TARGET_DEC', np.zeros(nfibers)),
        ('FIBER', np.arange(nfibers, dtype=np.int32)),
        ('OBJTYPE', np.array(['TGT'] * nfibers)),
        ('FIBERSTATUS', np.zeros(nfibers, np.int32)),
        ('DESI_TARGET', np.full(nfibers, 1 << 61, np.int64)),
    ]))
    fitsio.write(out_fname, hdus, overwrite=True)


def build_kernels():
    """Build (or find built) both kernel libraries, one nvcc each, in
    parallel, and bind every launcher of both forms."""
    import torch
    from rvspecfit_torch.ops import ccf_chisq, cuda_build, spline_eval
    with concurrent.futures.ThreadPoolExecutor() as ex:
        list(ex.map(cuda_build.load, ('spline_eval', 'ccf_chisq')))
    for dtype in (torch.float64, torch.float32):
        spline_eval.build(dtype)
        spline_eval.build_adjoint(dtype)
        ccf_chisq.build(dtype)


def prewarm(waves, nfibers, config, options=None, resol_ndiag=None,
            setups=None, templates=None, banks=None, device=None):
    """Fit one synthetic exposure shaped like the data through
    survey/desi.proc_many in a temporary directory, which is removed
    afterwards: ``waves`` {setup letter: (npix,)}, ``nfibers`` fibers,
    ``resol_ndiag`` optional RESOLUTION band widths (fitted with the
    resolution matrices), ``templates``/``banks`` in memory or None (the
    library of ``config``), on ``device`` (None: the CUDA card).  Raises
    if the fit fails.  Returns its seconds."""
    from rvspecfit_torch.survey import desi
    setups = tuple(setups or waves)
    tmpdir = tempfile.mkdtemp(prefix='rvstorch_prewarm_')
    try:
        coadd = os.path.join(tmpdir, 'coadd-prewarm.fits')
        synth_coadd_like(coadd, waves, nfibers, resol_ndiag=resol_ndiag)
        logging.info('prewarm exposure: %d fibers x %s', nfibers,
                     {s: len(w) for s, w in waves.items()})
        t0 = time.perf_counter()
        desi.proc_many([coadd], os.path.join(tmpdir, 'out'), config=config,
                       options=options or {'npoly': 10}, coalesce=1,
                       templates=templates, banks=banks, device=device,
                       throw_exceptions=True, setups=setups,
                       use_resolution_matrix=any(
                           (resol_ndiag or {}).values()))
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def library_waves(config, setups, device=None):
    """Per-setup wavelength grids from the library's own templates,
    trimmed so that the whole velocity range stays inside them."""
    from rvspecfit_torch.pipeline.library import load_template_model
    vmax = max(abs(float(config['min_vel'])), abs(float(config['max_vel'])))
    frac = 1.25 * vmax / C_KMS           # 25% safety + spline support
    waves = {}
    for s in setups:
        tm = load_template_model(f'desi_{s}', config, device=device)
        lam = tm.geom.xs.double().cpu().numpy()
        sel = (lam > lam[0] * (1 + frac)) & (lam < lam[-1] * (1 - frac))
        waves[s] = lam[sel]
    return waves


def main(args=None):
    """``rvstorch_prewarm``: build the kernels and fit one synthetic
    exposure shaped like the data.  Runs on the CUDA card unless
    ``--device cpu`` is given (then no kernel is built)."""
    parser = argparse.ArgumentParser(
        description='Build the CUDA kernels and fit one synthetic '
                    'exposure at the production DESI-fit shapes.')
    parser.add_argument('--config', type=str, default=None)
    parser.add_argument('--templ_lib', type=str, default=None)
    parser.add_argument('--like', type=str, default=None,
                        help='existing coadd whose arm wavelength grids '
                             '(and RESOLUTION band width) set the shapes; '
                             'its spectra are NOT read')
    parser.add_argument('--setups', type=str, default='b,r,z')
    parser.add_argument('--nfibers', type=int, default=500)
    parser.add_argument('--npoly', type=int, default=10)
    parser.add_argument('--resolution_matrix', action='store_true',
                        default=False)
    parser.add_argument('--no_ccf_continuum_normalize',
                        dest='ccf_continuum_normalize',
                        action='store_false', default=True)
    parser.add_argument('--log_level', type=str, default='INFO')
    parser.add_argument('--device', type=str, default=None,
                        help="torch device, e.g. 'cpu' (default: the "
                        'CUDA card; raises without one)')
    args = parser.parse_args(args)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()))

    from rvspecfit_torch import utils
    from rvspecfit_torch.device import resolve_device
    from rvspecfit_torch.io import fitsio

    device = resolve_device(args.device)
    if device.type == 'cuda':
        t0 = time.perf_counter()
        build_kernels()
        logging.info('kernels built in %.1f s', time.perf_counter() - t0)
    override = {'ccf_continuum_normalize': args.ccf_continuum_normalize}
    if args.templ_lib:
        override['template_lib'] = args.templ_lib
    config = utils.read_config(args.config, override)
    setups = args.setups.split(',')
    waves, resol_ndiag = {}, {}
    if args.like:
        fp = fitsio.read(args.like)
        for s in setups:
            su = s.upper()
            waves[s] = np.asarray(fp[f'{su}_WAVELENGTH'].data,
                                  np.float64).ravel()
            resol_ndiag[s] = (fp[f'{su}_RESOLUTION'].data.shape[1]
                              if f'{su}_RESOLUTION' in fp
                              and args.resolution_matrix else None)
    else:
        waves = library_waves(config, setups, device=device)
        resol_ndiag = {s: 11 if args.resolution_matrix else None
                       for s in setups}
    seconds = prewarm(waves, args.nfibers, config,
                      options={'npoly': args.npoly},
                      resol_ndiag=resol_ndiag, setups=setups, device=device)
    logging.info('prewarm complete: one %d-fiber exposure fitted in %.1f s',
                 args.nfibers, seconds)
    return 0


if __name__ == '__main__':
    sys.exit(main())
