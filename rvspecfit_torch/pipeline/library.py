"""Template-library loading: on-disk artifacts -> TemplateModel.

Counterpart of the regular-grid branch of
rvspecfit_tpu/pipeline/library.py.  :func:`read_template_artifacts`
reads ``interp_{setup}.h5`` and ``interpdat_{setup}.npy`` (the names
make_nd writes) from ``config['template_lib']`` on the host;
:func:`template_model_from_artifacts` builds the TemplateModel on a
device from those arrays; :func:`load_template_model` does both, and
:func:`load_template_models` for several setups.  The NN and
triangulation interpolators are not ported: their libraries raise.
"""
from __future__ import annotations

import os

import numpy as np

from rvspecfit_torch import serializer
from rvspecfit_torch.device import resolve_device
from rvspecfit_torch.interp.api import TemplateModel
from rvspecfit_torch.interp.grid import GridInterpState
from rvspecfit_torch.ops.spline import SplineGeometry

INTERPOL_H5_NAME = 'interp_%s.h5'
INTERPOL_DAT_NAME = 'interpdat_%s.npy'

def _check_type(fd):
    itype = fd.get('interpolation_type')
    if itype != 'regulargrid':
        raise ValueError(f'interpolation type {itype!r} is not ported '
                         '(only regulargrid)')


def read_template_artifacts(setup, config):
    """Host arrays of one setup's regular-grid library: (the interp
    dict, the (nspec, npix) stored spectra, memory-mapped)."""
    lib = config['template_lib']
    fd = serializer.load_dict_from_hdf5(
        os.path.join(lib, INTERPOL_H5_NAME % setup))
    _check_type(fd)
    dats = np.load(os.path.join(lib, INTERPOL_DAT_NAME % setup),
                   mmap_mode='r')
    return fd, dats


def template_model_from_artifacts(fd, dats, device=None, dtype=None):
    """TemplateModel on ``device`` (None: the CUDA card) from the interp
    dict of a regular-grid library (keys as make_nd writes them:
    interpolation_type, lam, log_step, parnames, log_ids, log_spec,
    uvecs {dim0, ...}, idgrid, vec) and its (nspec, npix) spectra;
    ``dtype`` overrides the device's working dtype."""
    _check_type(fd)
    device = resolve_device(device)
    uvdict = fd['uvecs']
    uvecs = [np.asarray(uvdict[f'dim{i}']) for i in range(len(uvdict))]
    state = GridInterpState.build(
        uvecs, np.asarray(fd['idgrid']), np.asarray(fd['vec']),
        np.array(dats), log_spec=bool(fd.get('log_spec', True)),
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
                         extra=extra)


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
