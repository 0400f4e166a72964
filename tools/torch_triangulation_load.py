#!/usr/bin/env python3
"""Host seconds of the triangulation branch on a large synthetic grid:
make_nd's triangulation build and pipeline/library's conversion of the
library into the card's regular grid, on the CPU, in memory (no h5py).

Usage (from the root of a checkout):

    python3 tools/torch_triangulation_load.py [--grid 24,13,10,8]
        [--npix 512] [--scatter 0.3]

* the grid: simulation.make_template_grid at ``--grid`` nodes (by
  default 24,960 templates, the NN training cell's) and ``--npix``
  pixels, as the specs dict make_interpol writes;
* make_nd.build_interpolator without --regulargrid: the seeded jitter,
  the padded corners and the Delaunay check build;
* library.triangulation_grid on it: the rectilinear point set converts
  exactly (the jitter and the corners stripped);
* the same after moving every template by a uniform random offset of
  up to ``--scatter`` grid steps along each axis (an irregular point
  set, spectra unchanged): the conversion resamples the Delaunay
  interpolant (``auto_regularize``), the path of a real irregular
  library.

Prints one line per step and, last, a JSON object of the seconds.
"""
import argparse
import json
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rvspecfit_torch import simulation  # noqa: E402
from rvspecfit_torch.pipeline import library, make_nd  # noqa: E402


def specs_dict(vec, specs, lam):
    """A specs dict as make_interpol writes it: raw parameters (teff
    unlogged), log-spectra."""
    raw = vec.copy()
    raw[0] = 10.0**raw[0]
    return dict(vec=raw, specs=specs, lam=lam,
                parnames=['teff', 'logg', 'feh', 'alpha'], log_ids=[0],
                lognorms=np.zeros(len(specs)), log_step=True, log_spec=True)


def timed(label, fn, seconds):
    t0 = time.perf_counter()
    out = fn()
    seconds[label] = time.perf_counter() - t0
    print(f'{label}: {seconds[label]:.3f} s', flush=True)
    return out


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--grid', default='24,13,10,8')
    parser.add_argument('--npix', type=int, default=512)
    parser.add_argument('--scatter', type=float, default=0.3)
    args = parser.parse_args(args)
    grid = [int(x) for x in args.grid.split(',')]
    seconds = {}
    lam, _, _, vec, specs, _ = timed(
        'make_template_grid', lambda: simulation.make_template_grid(
            *grid, npix=args.npix), seconds)
    steps = np.array([np.diff(np.unique(v)).min() for v in vec])[:, None]
    moved = vec + args.scatter * steps * np.random.RandomState(5).uniform(
        -1.0, 1.0, vec.shape)
    for name, pts in (('rectilinear', vec), ('irregular', moved)):
        d = specs_dict(pts, specs, lam)
        fd, dats = timed(f'make_nd triangulation ({name}, '
                         f'{d["specs"].shape[0]} templates)',
                         lambda: make_nd.build_interpolator(d), seconds)
        got, grid_dats = timed(
            f'library.triangulation_grid ({name})',
            lambda: library.triangulation_grid(
                fd, dats, 'large', dict(auto_regularize=True)), seconds)
        print(f'  -> regular grid {got["idgrid"].shape}, '
              f'{int((got["idgrid"] < 0).sum())} holes, stored '
              f'{grid_dats.shape}', flush=True)
    print(json.dumps(dict(host=platform.processor() or platform.machine(),
                          cores=os.cpu_count(), grid=grid, npix=args.npix,
                          scatter=args.scatter, seconds=seconds)))


if __name__ == '__main__':
    main()
