"""Template-library loading: on-disk artifacts -> TemplateModel.

Counterpart of the regular-grid and NN branches of
rvspecfit_tpu/pipeline/library.py.  :func:`read_template_artifacts`
reads a setup's ``interp_{setup}.h5`` descriptor from
``config['template_lib']`` on the host, with its data: the stored
spectra ``interpdat_{setup}.npy`` (the names make_nd writes) of a
regular grid, or the NN checkpoint payload (``nn_file``, by default
``nnstate_{setup}.h5``, as the NN trainer writes it) of an NN
library; :func:`template_model_from_artifacts` builds the TemplateModel
on a device from those; :func:`load_template_model` does both, and
:func:`load_template_models` for several setups.  A triangulation
library raises (not ported yet, ROADMAP A5).
"""
from __future__ import annotations

import os

import numpy as np

from rvspecfit_torch import serializer
from rvspecfit_torch.device import resolve_device
from rvspecfit_torch.interp import nn as nn_mod
from rvspecfit_torch.interp.api import TemplateModel
from rvspecfit_torch.interp.grid import GridInterpState
from rvspecfit_torch.ops.spline import SplineGeometry

INTERPOL_H5_NAME = 'interp_%s.h5'
INTERPOL_DAT_NAME = 'interpdat_%s.npy'
NN_STATE_NAME = 'nnstate_%s.h5'
# interpolation_type -> TemplateModel kind
KINDS = {'regulargrid': 'grid', 'nn': 'nn', 'generic': 'nn'}


def _kind(fd):
    itype = fd.get('interpolation_type')
    if itype not in KINDS:
        raise ValueError(f'interpolation type {itype!r} is not ported '
                         '(regulargrid and nn are; triangulation is '
                         'ROADMAP A5)')
    return KINDS[itype]


def read_template_artifacts(setup, config):
    """Host data of one setup's library: (the interp dict, and the
    (nspec, npix) stored spectra, memory-mapped, of a regular grid or
    the checkpoint payload of an NN library)."""
    lib = config['template_lib']
    fd = serializer.load_dict_from_hdf5(
        os.path.join(lib, INTERPOL_H5_NAME % setup))
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


def load_template_model(setup, config, device=None):
    """One setup's TemplateModel from ``config['template_lib']`` on
    ``device`` (None: the CUDA card)."""
    return template_model_from_artifacts(
        *read_template_artifacts(setup, config), device=device)


def load_template_models(config, setups, device=None):
    """{setup: TemplateModel} of several setups from
    ``config['template_lib']`` on ``device`` (None: the CUDA card)."""
    return {s: load_template_model(s, config, device=device)
            for s in setups}
