"""Build the n-d interpolator artifacts (offline, host).

The port's own copy of rvspecfit_tpu/pipeline/make_nd.py: consumes
``specs_{setup}.h5`` and produces ``interp_{setup}.h5`` and
``interpdat_{setup}.npy`` (the names pipeline/library.py reads).
:func:`build_interpolator` returns (the descriptor dict, the stored
spectra) that :func:`execute` writes (writing needs ``h5py``).

Two interpolation types:
* ``regulargrid``: per-dimension unique values and an integer id grid
  with -1 holes (interp/grid.GridInterpState on the device);
* ``triangulation``: the points perturbed by a seeded +-1e-6 jitter
  (``np.random.RandomState(1)``, which pipeline/library.py's loader
  undoes) and padded with the 2^ndim corners of a box 20% wider than
  the grid, whose spectra are their nearest neighbours'; the artifact
  stores the point set, and the Delaunay triangulation is rebuilt at
  load time (here it is built once, so that a failure shows now).
"""
from __future__ import annotations

import argparse
import logging
import os
import shlex
import sys

import numpy as np
import scipy.spatial

from rvspecfit_torch import __version__ as git_rev
from rvspecfit_torch import serializer
from rvspecfit_torch.interp.mapper import LogMapper
from rvspecfit_torch.pipeline.make_interpol import SPECS_H5_NAME

INTERPOL_H5_NAME = 'interp_%s.h5'
INTERPOL_DAT_NAME = 'interpdat_%s.npy'
PERTURBATION_AMPLITUDE = 1e-6
EDGE_PAD_FRACTION = 0.2


def getedgevertices(vec):
    """(ndim, 2^ndim) vertices of a box around the (ndim, n) points,
    padded by EDGE_PAD_FRACTION of their span."""
    ndim = vec.shape[0]
    span = np.ptp(vec, axis=1)
    lo = vec.min(axis=1) - EDGE_PAD_FRACTION * span
    hi = vec.max(axis=1) + EDGE_PAD_FRACTION * span
    corners = []
    for i in range(2**ndim):
        corners.append([hi[j] if (i >> j) & 1 else lo[j]
                        for j in range(ndim)])
    return np.array(corners).T


def build_interpolator(d, regular=False, perturb=True, revision='',
                       cmdline=''):
    """(descriptor dict, (n, npix) stored spectra) of the interpolator
    of ``d``, a dict as make_interpol writes it (vec (ndim, nspec),
    specs, lam, parnames, log_ids, lognorms, log_step, log_spec)."""
    vec = np.asarray(d['vec'], dtype=np.float64)
    specs = np.asarray(d['specs'])
    mapper = LogMapper(tuple(int(x) for x in d.get('log_ids', (0,))))
    vec_mapped = mapper.forward(vec.T).T
    if not np.isfinite(vec_mapped).all():
        raise RuntimeError('Mapped parameters are not finite')
    ndim = vec_mapped.shape[0]

    ret = dict(lam=d['lam'], log_step=bool(d['log_step']),
               parnames=list(d['parnames']),
               mapper_class='LogMapper',
               log_ids=list(d.get('log_ids', (0,))),
               revision=revision, lognorms=d['lognorms'],
               log_spec=bool(d.get('log_spec', True)),
               git_rev=git_rev, cmdline=cmdline)

    if regular:
        uvecs, vecids = [], []
        for i in range(ndim):
            u, inv = np.unique(vec_mapped[i], return_inverse=True)
            uvecs.append(u)
            vecids.append(inv)
        lens = [len(u) for u in uvecs]
        idgrid = np.full(lens, -1, dtype=np.int64)
        idgrid[tuple(vecids)] = np.arange(vec_mapped.shape[1])
        ret['interpolation_type'] = 'regulargrid'
        ret['uvecs'] = {f'dim{i}': u for i, u in enumerate(uvecs)}
        ret['idgrid'] = idgrid
        ret['vec'] = vec_mapped
    else:
        if perturb:
            rng = np.random.RandomState(1)
            vec_mapped = vec_mapped + rng.uniform(
                -PERTURBATION_AMPLITUDE, PERTURBATION_AMPLITUDE,
                size=vec_mapped.shape)
        edges = getedgevertices(vec_mapped)
        nearnei = scipy.spatial.cKDTree(vec_mapped.T).query(edges.T)[1]
        vec_all = np.hstack([vec_mapped, edges])
        specs = np.vstack([specs, specs[nearnei]])
        extraflags = np.concatenate([np.zeros(vec_mapped.shape[1]),
                                     np.ones(edges.shape[1])])
        ret['interpolation_type'] = 'triangulation'
        ret['vec'] = vec_all
        ret['extraflags'] = extraflags
        ret['lognorms'] = np.concatenate(
            [np.asarray(d['lognorms']), np.zeros(edges.shape[1])])
        scipy.spatial.Delaunay(vec_all.T)
    return ret, np.ascontiguousarray(specs)


def execute(setup, prefix=None, regular=False, perturb=True, revision='',
            cmdline=''):
    """Build ``interp_{setup}.h5`` and ``interpdat_{setup}.npy`` in
    ``prefix`` from the ``specs_{setup}.h5`` there."""
    d = serializer.load_dict_from_hdf5(
        os.path.join(prefix, SPECS_H5_NAME % setup))
    ret, specs = build_interpolator(d, regular=regular, perturb=perturb,
                                    revision=revision, cmdline=cmdline)
    serializer.save_dict_to_hdf5(
        os.path.join(prefix, INTERPOL_H5_NAME % setup), ret)
    np.save(os.path.join(prefix, INTERPOL_DAT_NAME % setup), specs)
    logging.info('wrote %s interpolator for setup %s',
                 ret['interpolation_type'], setup)


def main(args=None):
    if args is None:
        args = sys.argv[1:]
    cmdline = shlex.join(['rvstorch_make_nd'] + list(args))
    parser = argparse.ArgumentParser(
        description='Create n-d spectral interpolation artifacts')
    parser.add_argument('--prefix', type=str, required=True)
    parser.add_argument('--setup', type=str, required=True)
    parser.add_argument('--regulargrid', action='store_true')
    parser.add_argument('--revision', type=str, default='')
    args = parser.parse_args(args)
    execute(args.setup, prefix=args.prefix, revision=args.revision or '',
            regular=args.regulargrid, cmdline=cmdline)


if __name__ == '__main__':
    main()
