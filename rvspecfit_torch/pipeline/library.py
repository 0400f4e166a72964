"""Template-library loading: on-disk artifacts -> TemplateModel.

Counterpart of rvspecfit_tpu/pipeline/library.py.
:func:`read_template_artifacts` reads a setup's ``interp_{setup}.h5``
descriptor from ``config['template_lib']`` on the host, with its data:
the stored spectra ``interpdat_{setup}.npy`` (the names make_nd writes)
of a regular grid, or the NN checkpoint payload (``nn_file``, by
default ``nnstate_{setup}.h5``, as the NN trainer writes it) of an NN
library.  A triangulation library (make_nd without ``--regulargrid``)
is rasterized there into a regular grid, as the reference's loader
does: exactly when its points are a rectilinear grid (ghost corners
and the Delaunay-stabilization jitter stripped), and otherwise,
where asked (``RVST_AUTO_REGULARIZE=1`` or ``config['auto_regularize']``),
by resampling its Delaunay interpolant onto a rectilinear grid; so the
card fits every library through the grid or the NN interpolator.
:func:`template_model_from_artifacts` builds the TemplateModel on a
device from a regular grid's or an NN library's artifacts;
:func:`load_template_model` does both, and :func:`load_template_models`
for several setups.  Loaded models are kept in one process-wide cache
(:func:`clear_cache` empties it), keyed by the library's absolute path,
the setup, the dtype, the device and what else changes the model built
(``config['auto_regularize']``, ``RVST_AUTO_REGULARIZE`` and
``RVST_AUTO_REGULARIZE_N``): every caller of one key shares one
model, whose tensors nothing writes to.  :func:`model_on` gives a model
on another device (a shard of parallel/mesh) through the same cache,
keyed by the model and the device.
"""
from __future__ import annotations

import itertools
import logging
import os

import numpy as np
import torch

from rvspecfit_torch import serializer
from rvspecfit_torch.device import map_tensors, resolve_device
from rvspecfit_torch.interp import nn as nn_mod
from rvspecfit_torch.interp.api import TemplateModel
from rvspecfit_torch.interp.grid import GridInterpState
from rvspecfit_torch.ops.spline import SplineGeometry
from rvspecfit_torch.pipeline.make_nd import (INTERPOL_DAT_NAME,
                                              INTERPOL_H5_NAME)

NN_STATE_NAME = 'nnstate_%s.h5'
# interpolation_type -> TemplateModel kind (a triangulation library
# reaches template_model_from_artifacts as its rasterized regular grid)
KINDS = {'regulargrid': 'grid', 'nn': 'nn', 'generic': 'nn'}


def _kind(fd):
    itype = fd.get('interpolation_type')
    if itype not in KINDS:
        raise RuntimeError(f'Unknown interpolation type {itype!r}')
    return KINDS[itype]


def _cluster_values(vals, atol=1e-5):
    """Collapse values that differ by <= atol into cluster means
    (undoes make_nd's deterministic 1e-6 Delaunay-stabilization
    perturbation).  Returns (centers, inverse-index)."""
    vals = np.asarray(vals, np.float64)
    order = np.argsort(vals)
    sv = vals[order]
    new = np.concatenate([[True], np.diff(sv) > atol])
    gid_sorted = np.cumsum(new) - 1
    gid = np.empty(len(vals), np.int64)
    gid[order] = gid_sorted
    ngroups = gid_sorted[-1] + 1
    centers = np.zeros(ngroups)
    counts = np.bincount(gid, minlength=ngroups)
    np.add.at(centers, gid, vals)
    centers /= counts
    return centers, gid


def triangulation_grid(fd, dats, setup, config=None):
    """The regular grid of a triangulation library: (the interp dict
    of a regular grid, with the library's other keys, and its (nspec,
    npix) stored spectra), from the library's interp dict and all its
    stored spectra (ghost corner vertices included).

    A rectilinear point set converts exactly: ghost corners and the
    stabilization jitter are stripped, the spectra are the stored ones
    (grid holes fall back to the nearest node).  An irregular point set
    raises, unless ``RVST_AUTO_REGULARIZE=1`` or
    ``config['auto_regularize']`` asks to resample it through its
    Delaunay interpolant (:func:`_auto_regularize_triangulation`)."""
    vec = np.asarray(fd['vec'], np.float64)
    flags = np.asarray(fd['extraflags']) if 'extraflags' in fd else \
        np.zeros(vec.shape[1])
    real = np.nonzero(flags == 0)[0]
    pts = vec[:, real]
    ndim, npts = pts.shape
    uvecs, idxs = [], []
    for i in range(ndim):
        centers, gid = _cluster_values(pts[i])
        uvecs.append(centers)
        idxs.append(gid)
    nnodes = float(np.prod([float(len(u)) for u in uvecs]))
    if nnodes > max(8.0 * npts, 65536.0):
        auto = os.environ.get('RVST_AUTO_REGULARIZE') == '1' or \
            bool(config is not None and config.get('auto_regularize'))
        if not auto:
            raise RuntimeError(
                f'Setup {setup!r} uses a triangulation interpolator over '
                f'an IRREGULAR point set ({npts} points, {nnodes:.3g} '
                'rectilinear nodes) — it cannot be converted exactly to '
                'the on-device grid interpolator.  Set '
                'RVST_AUTO_REGULARIZE=1 (or config auto_regularize: true) '
                'to resample it through the Delaunay interpolant at load '
                'time, resample offline with rvst_regularize_grid, '
                'rebuild with rvst_make_nd --regulargrid, or train the NN '
                'interpolator (rvstorch_train_nn_interpolator).')
        uvecs, idgrid, pts, grid_dats = _auto_regularize_triangulation(
            setup, vec, dats, real)
    else:
        lens = [len(u) for u in uvecs]
        idgrid = np.full(lens, -1, dtype=np.int64)
        idgrid[tuple(idxs)] = np.arange(npts)
        nholes = int((idgrid < 0).sum())
        logging.warning(
            'setup %s: converting triangulation library to the on-device '
            'regular-grid interpolator (%d points -> %s grid, %d holes%s)',
            setup, npts, 'x'.join(str(n) for n in lens), nholes,
            '; holes fall back to nearest-neighbor' if nholes else '')
        grid_dats = np.asarray(dats)[real]
    return dict(fd, interpolation_type='regulargrid',
                uvecs={f'dim{i}': u for i, u in enumerate(uvecs)},
                idgrid=idgrid, vec=pts), grid_dats


def _auto_regularize_triangulation(setup, vec_all, dats_all, real):
    """Rasterize an IRREGULAR triangulation library onto a rectilinear
    grid: (uvecs, idgrid, node points (ndim, m), (m, npix) float32
    spectra at the m nodes inside the hull).

    The Delaunay barycentric interpolant over the library's full point
    set (ghost corner vertices included, as the reference's loader
    builds it) is evaluated once per node of a rectilinear grid
    spanning the real points; nodes outside the hull are grid holes
    (nearest-neighbor fallback).  A held-out accuracy check — the grid
    evaluated multilinearly at the original template points against
    their stored spectra — is logged.

    Grid resolution: ``RVST_AUTO_REGULARIZE_N`` nodes per dimension,
    default ``clip(round(2 * npts**(1/ndim)), 4, 12)``; a grid of more
    than 4 GiB in float32 raises.
    """
    import scipy.spatial

    pts = vec_all[:, real]
    ndim, npts = pts.shape
    npix = dats_all.shape[1]
    n_env = int(os.environ.get('RVST_AUTO_REGULARIZE_N', '0'))
    n_per_dim = n_env or int(np.clip(round(2 * npts ** (1.0 / ndim)),
                                     4, 12))
    uvecs = [np.linspace(pts[i].min(), pts[i].max(), n_per_dim)
             for i in range(ndim)]
    nnodes = n_per_dim ** ndim
    if nnodes * npix * 4 > 4 << 30:
        raise RuntimeError(
            f'auto-regularize grid for setup {setup!r} would need '
            f'{nnodes * npix * 4 / 2**30:.1f} GiB; lower '
            'RVST_AUTO_REGULARIZE_N or resample offline with '
            'rvst_regularize_grid')

    tri = scipy.spatial.Delaunay(vec_all.T)
    nodes = np.stack(np.meshgrid(*uvecs, indexing='ij'),
                     axis=-1).reshape(-1, ndim)
    simplex = tri.find_simplex(nodes)
    inside = simplex >= 0
    m = int(inside.sum())
    grid_dats = np.empty((m, npix), np.float32)
    in_nodes = nodes[inside]
    in_simp = simplex[inside]
    for lo in range(0, m, 512):
        sl = slice(lo, min(lo + 512, m))
        T = tri.transform[in_simp[sl]]
        b = np.einsum('mij,mj->mi', T[:, :ndim, :],
                      in_nodes[sl] - T[:, ndim, :])
        bfull = np.concatenate([b, 1 - b.sum(axis=1, keepdims=True)],
                               axis=1)
        verts = tri.simplices[in_simp[sl]]
        grid_dats[sl] = np.einsum('mv,mvp->mp', bfull,
                                  np.asarray(dats_all)[verts])
    idgrid = np.full(nnodes, -1, np.int64)
    idgrid[np.nonzero(inside)[0]] = np.arange(m)

    # held-out accuracy: multilinear-interpolate the rasterized grid at
    # the original template points against their stored (log) spectra
    lens = [len(u) for u in uvecs]
    rng = np.random.RandomState(3)
    test_ids = rng.permutation(npts)[:min(npts, 64)]
    errs, nskip = [], 0
    for t in test_ids:
        p = pts[:, t]
        ji, wi = [], []
        for i, u in enumerate(uvecs):
            j = int(np.clip(np.searchsorted(u, p[i]) - 1, 0, len(u) - 2))
            ji.append(j)
            wi.append(np.clip((p[i] - u[j]) / (u[j + 1] - u[j]), 0.0, 1.0))
        spec = np.zeros(npix)
        ok = True
        for corner in itertools.product((0, 1), repeat=ndim):
            flat, weight = 0, 1.0
            for i, c in enumerate(corner):
                flat = flat * lens[i] + ji[i] + c
                weight *= wi[i] if c else (1.0 - wi[i])
            sid = idgrid[flat]
            if sid < 0:
                ok = False           # hole in this cell: skip the point
                break
            spec += weight * grid_dats[sid]
        if not ok:
            nskip += 1
            continue
        errs.append(float(np.median(np.abs(
            spec - np.asarray(dats_all)[real[t]]))))
    med_err = float(np.median(errs)) if errs else float('nan')
    max_err = float(np.max(errs)) if errs else float('nan')
    logging.warning(
        'setup %s: AUTO-REGULARIZED irregular triangulation library '
        '(%d points -> %s grid, %d/%d nodes inside the hull); '
        'held-out accuracy at %d template points (stored/log space): '
        'median |d|=%.4g, max median-per-spec |d|=%.4g (%d skipped at '
        'holes).  For tighter control resample offline with '
        'rvst_regularize_grid or train the NN interpolator.',
        setup, npts, 'x'.join(str(n) for n in lens), m, nnodes,
        len(errs), med_err, max_err, nskip)
    return uvecs, idgrid.reshape(lens), in_nodes.T, grid_dats


def read_template_artifacts(setup, config):
    """Host data of one setup's library: (the interp dict, and the
    (nspec, npix) stored spectra, memory-mapped, of a regular grid or
    the checkpoint payload of an NN library); a triangulation library
    gives its regular grid (:func:`triangulation_grid`)."""
    lib = config['template_lib']
    fd = serializer.load_dict_from_hdf5(
        os.path.join(lib, INTERPOL_H5_NAME % setup))
    if fd.get('interpolation_type') == 'triangulation':
        return triangulation_grid(
            fd, np.load(os.path.join(lib, INTERPOL_DAT_NAME % setup),
                        mmap_mode='r'), setup, config)
    if _kind(fd) == 'nn':
        ck = serializer.load_dict_from_hdf5(os.path.join(
            lib, str(fd.get('nn_file') or NN_STATE_NAME % setup)))
        return fd, ck.get('state', ck)
    dats = np.load(os.path.join(lib, INTERPOL_DAT_NAME % setup),
                   mmap_mode='r')
    return fd, dats


def template_model_from_artifacts(fd, data, device=None, dtype=None):
    """TemplateModel on ``device`` (None: the CUDA card) from the interp
    dict of a library (keys as make_nd or the NN trainer write them:
    interpolation_type, lam, log_step, parnames, log_ids, log_spec and,
    for a regular grid, uvecs {dim0, ...}, idgrid, vec) and its data:
    the (nspec, npix) spectra of a regular grid, the checkpoint payload
    of an NN library.  ``dtype`` overrides the device's working
    dtype."""
    kind = _kind(fd)
    device = resolve_device(device)
    if kind == 'nn':
        state = nn_mod.state_from_dict(data, device=device, dtype=dtype)
    else:
        uvdict = fd['uvecs']
        uvecs = [np.asarray(uvdict[f'dim{i}']) for i in range(len(uvdict))]
        state = GridInterpState.build(
            uvecs, np.asarray(fd['idgrid']), np.asarray(fd['vec']),
            np.array(data), log_spec=bool(fd.get('log_spec', True)),
            device=device, dtype=dtype)
    geom = SplineGeometry.from_knots(np.asarray(fd['lam'], np.float64),
                                     log_step=bool(fd['log_step']),
                                     device=device, dtype=dtype)
    extra = dict(revision=str(fd.get('revision') or ''),
                 creation_soft_version=str(fd.get('git_rev') or ''))
    return TemplateModel(state=state, geom=geom,
                         parnames=tuple(str(p) for p in fd['parnames']),
                         log_ids=tuple(int(x)
                                       for x in fd.get('log_ids', (0,))),
                         kind=kind, extra=extra)


_cache = {}


def clear_cache():
    """Forget every loaded template model."""
    _cache.clear()


def _cache_key(setup, config, device, dtype):
    return (os.path.abspath(config['template_lib']), setup, dtype,
            str(resolve_device(device)), bool(config.get('auto_regularize')),
            os.environ.get('RVST_AUTO_REGULARIZE'),
            os.environ.get('RVST_AUTO_REGULARIZE_N'))


def load_template_model(setup, config, device=None, dtype=None):
    """One setup's TemplateModel from ``config['template_lib']`` on
    ``device`` (None: the CUDA card), in ``dtype`` (None: the device's
    working dtype); read and built once per cache key (see the module's
    docstring)."""
    key = _cache_key(setup, config, device, dtype)
    if key not in _cache:
        _cache[key] = template_model_from_artifacts(
            *read_template_artifacts(setup, config), device=device,
            dtype=dtype)
    return _cache[key]


def load_template_models(config, setups, device=None, dtype=None):
    """{setup: TemplateModel} of several setups from
    ``config['template_lib']`` on ``device`` (None: the CUDA card),
    through :func:`load_template_model`'s cache."""
    return {s: load_template_model(s, config, device=device, dtype=dtype)
            for s in setups}


def model_on(tm, device):
    """TemplateModel ``tm`` on ``device``: ``tm`` itself where it is
    there already, else a copy with every tensor moved, made once per
    model and device and kept in the cache (which holds ``tm`` too, so
    its key stays its own)."""
    device = torch.device(device)
    if tm.geom.h.device == device:
        return tm
    key = ('model_on', id(tm), str(device))
    if key not in _cache:
        _cache[key] = (tm, map_tensors(tm, lambda t: t.to(device)))
    return _cache[key][1]


def get_spec_params(setup, config, device=None):
    """Ordered parameter names of a setup's library (reference:
    rvspecfit_tpu/pipeline/library.py:300), through
    :func:`load_template_model` on ``device`` (None: the CUDA card)."""
    return load_template_model(setup, config, device=device).parnames
