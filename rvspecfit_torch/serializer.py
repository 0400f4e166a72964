"""Read the template library's HDF5 artifacts (nested dicts).

The port's own copy of the loading half of
rvspecfit_tpu/serializer.py: one ``type`` attribute per node says how
to rebuild it.  Pickle-free: a ``pickle`` node raises.  ``h5py`` is
imported inside :func:`load_dict_from_hdf5` only, so the modules that
use this one import on a machine without it (reading a library needs
it).
"""
from __future__ import annotations

import os

CURRENT_VERSION = 1


def _load_node(h5py, node):
    if isinstance(node, h5py.Group):
        typ = node.attrs.get('type', 'dict')
        if typ in ('seq_list', 'seq_tuple'):
            n = int(node.attrs['length'])
            vals = [_load_node(h5py, node[f'_{i}']) for i in range(n)]
            return vals if typ == 'seq_list' else tuple(vals)
        return {k: _load_node(h5py, v) for k, v in node.items()}
    typ = node.attrs.get('type', 'ndarray')
    if typ == 'none':
        return None
    if typ == 'str':
        v = node[()]
        return v.decode('utf-8') if isinstance(v, bytes) else str(v)
    if typ == 'bool':
        return bool(node[()])
    if typ == 'scalar':
        return node[()]
    if typ in ('list', 'tuple'):
        arr = node[:]
        if arr.dtype.kind == 'O':
            arr = arr.astype(str)
        vals = list(arr)
        return vals if typ == 'list' else tuple(vals)
    if typ == 'ndarray':
        arr = node[...]
        if getattr(arr, 'dtype', None) is not None and arr.dtype.kind == 'O':
            arr = arr.astype(str)
        return arr
    if typ == 'pickle':
        raise ValueError(f'{node.name}: pickled nodes are not loaded')
    raise ValueError(f'Unknown node type {typ!r}')


def load_dict_from_hdf5(filename):
    """Load a nested dict from an HDF5 artifact file."""
    import h5py
    if not os.path.exists(filename):
        raise RuntimeError(f'File {filename} does not exist')
    with h5py.File(filename, 'r') as h5:
        version = h5.attrs.get('version')
        if version != CURRENT_VERSION:
            raise ValueError(f'Incompatible artifact version: {version}')
        return {k: _load_node(h5py, v) for k, v in h5.items()}
