"""Statistical accuracy harness: the RV pull-distribution check.

Counterpart of rvspecfit_tpu/validation.py: fit many randomized
synthetic spectra at a given S/N and report the median RV bias, the
median reported uncertainty, the RV scatter, and the pull standard
deviation std((v_fit - v_true)/sigma_v), which is ~1 when the errors
are calibrated.  The whole trial set is one fiber batch through
fit/batch.BatchedFitter (velocity scan -> Nelder-Mead -> gradient
polish -> velocity refinement), on one device (None: the CUDA card),
whole or in tiles of ``microbatch`` trials.
"""
from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
import subprocess

import numpy as np

from rvspecfit_torch import simulation
from rvspecfit_torch.device import resolve_device
from rvspecfit_torch.fit import vel_fit
from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter

C_KMS = 299792.458
DEFAULT_CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5,
                      max_vsini=500, min_vsini=1e-2, min_vel_step=0.2,
                      second_minimizer=True, template_lib='')


def run_accuracy(ntrials=1000, snr=300.0, npix=400, resol=1000.0,
                 seed=1, templates=None, config=None,
                 fit_start=(6000.0, 3.0, -1.0, 0.5), npoly=10,
                 nm_chunk=64, fatol=None, maxiter=None, device=None,
                 microbatch=None):
    """Fit ``ntrials`` random synthetic spectra; return (pull
    statistics, per-trial dict: v0, vfit, verr, params).

    ``templates`` {'acc': TemplateModel} (default: the synthetic
    6x6x6x4 grid at 4096 px on ``device``, None: the CUDA card); the
    fit runs where the template model lies.  The production pipeline:
    Nelder-Mead at the loose production defaults (``fatol``,
    ``maxiter`` override them; rounds of ``nm_chunk`` iterations),
    with ``config['second_minimizer']`` the gradient polish, then the
    velocity refinement.  The trials' truths and spectra are drawn from
    ``RandomState(seed)`` in the reference's order.  ``microbatch``
    fits the trials in tiles of at most that many (BatchedFitter)."""
    config = dict(DEFAULT_CONFIG if config is None else config)
    if templates is None:
        templates = {'acc': simulation.build_template_model(
            6, 6, 6, 4, npix=4096, device=resolve_device(device))}
    tm = templates['acc']

    rng = np.random.RandomState(seed)
    v0 = rng.uniform(-500, 500, ntrials)
    teff = rng.uniform(4500, 9500, ntrials)
    logg = rng.uniform(1.0, 4.5, ntrials)
    feh = rng.uniform(-1.8, -0.2, ntrials)
    alpha = rng.uniform(0.1, 0.9, ntrials)
    lam = np.linspace(4600, 5400, npix)
    wres = 5000.0 / resol / 2.35
    flux = np.zeros((ntrials, npix))
    ivar = np.zeros((ntrials, npix))
    for i in range(ntrials):
        lam_rest = lam / (1 + v0[i] / C_KMS)
        sp = simulation.fake_spectrum(lam_rest, teff[i], logg[i], feh[i],
                                      alpha[i], wresol=wres)
        esp = sp / snr
        flux[i] = sp + rng.normal(size=npix) * esp
        ivar[i] = 1.0 / esp**2

    bf = BatchedFitter([BatchArm('acc', lam, flux, ivar)], templates,
                       config, options={'npoly': npoly},
                       microbatch=microbatch)
    scan = bf.scan_velocities(
        np.arange(config['min_vel'], config['max_vel'],
                  config['vel_step0']),
        np.tile(fit_start, (ntrials, 1)))
    mapper = vel_fit.ParamMapper(
        tm.parnames, dict(zip(tm.parnames, fit_start)), [], None, False)
    nm_kwargs = dict(nm_chunk=nm_chunk)
    if fatol is not None:
        nm_kwargs['fatol'] = fatol
    if maxiter is not None:
        nm_kwargs['maxiter'] = maxiter
    nmres = bf.run_neldermead(mapper, scan['best_vel'], **nm_kwargs)
    xbest, fun = nmres['x'], nmres['fun']
    if config.get('second_minimizer'):
        xbest = bf.run_polish(mapper, xbest, fun0=fun, steps=3)['x']
    vel_b, params_b, _ = mapper.unpack_host(xbest)
    ref = bf.refine_velocities(vel_b, params_b)

    dv = ref['best_vel'] - v0
    sig = ref['vel_err']
    pull = dv / np.where(sig > 0, sig, np.inf)
    stats = dict(
        ntrials=int(ntrials), snr=float(snr),
        median_bias=float(np.median(dv)),
        median_err=float(np.median(sig)),
        scatter=float(0.5 * np.subtract(*np.percentile(dv, [84, 16]))),
        # the reference's metric: a plain std of the pulls, sensitive to
        # the tails; the percentile-based one separates the core
        pull_std=float(np.std(pull)),
        pull_std_robust=float(
            0.5 * np.subtract(*np.percentile(pull, [84, 16]))),
        frac_within_3sig=float(np.mean(np.abs(pull) < 3)),
    )
    return stats, dict(v0=v0, vfit=ref['best_vel'], verr=sig,
                       params=params_b)


def _git_rev():
    try:
        return subprocess.check_output(
            ['git', 'rev-parse', 'HEAD'], stderr=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return 'unknown'


def main(args=None):
    """``python -m rvspecfit_torch.validation``: prints the pull
    statistics as one JSON line; on the CUDA card unless ``--cpu``."""
    parser = argparse.ArgumentParser(
        description='RV accuracy / pull-distribution harness')
    parser.add_argument('--ntrials', type=int, default=1000)
    parser.add_argument('--snr', type=float, default=300.0)
    parser.add_argument('--npix', type=int, default=400)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--nm_chunk', type=int, default=64,
                        help='Nelder-Mead iterations per round')
    parser.add_argument('--fatol', type=float, default=None)
    parser.add_argument('--maxiter', type=int, default=None)
    parser.add_argument('--microbatch', type=int, default=None,
                        help='fit the trials in tiles of at most this '
                        'many (default: all at once)')
    parser.add_argument('--cpu', action='store_true', default=False,
                        help='Fit on the CPU instead of the CUDA card')
    parser.add_argument('--output', type=str, default=None,
                        help='also write the statistics, with the git '
                        'revision, the device and the date, to this '
                        'JSON file')
    args = parser.parse_args(args)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device('cpu' if args.cpu else None)
    stats, _ = run_accuracy(ntrials=args.ntrials, snr=args.snr,
                            npix=args.npix, seed=args.seed,
                            nm_chunk=args.nm_chunk, fatol=args.fatol,
                            maxiter=args.maxiter, device=device,
                            microbatch=args.microbatch)
    print(json.dumps(stats))
    if args.output:
        import torch
        rec = dict(stats, git_rev=_git_rev(), device=(
            torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu'), date=datetime.datetime.now().isoformat())
        with open(args.output, 'w') as fp:
            json.dump(rec, fp, indent=1)


if __name__ == '__main__':
    main()
