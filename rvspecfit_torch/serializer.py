"""Read and write the template library's HDF5 artifacts (nested dicts).

The port's own copy of rvspecfit_tpu/serializer.py: one ``type``
attribute per node says how to rebuild it, so each side reads what the
other writes.  Pickle-free: a ``pickle`` node raises on reading, and
an object without a node type raises on writing.  ``h5py`` is imported
inside :func:`load_dict_from_hdf5` and :func:`save_dict_to_hdf5` only,
so the modules that use this one import on a machine without it
(reading or writing a library needs it).  :func:`verify_data` checks
that a loaded artifact equals what was saved.
"""
from __future__ import annotations

import logging
import os

import numpy as np

CURRENT_VERSION = 1


def _save_node(h5py, h5, path, item):
    if isinstance(item, dict):
        grp = h5.require_group(path)
        grp.attrs['type'] = 'dict'
        for k, v in item.items():
            _save_node(h5py, h5, f'{path}/{k}', v)
    elif item is None:
        h5.create_dataset(path, data=0)
        h5[path].attrs['type'] = 'none'
    elif isinstance(item, str):
        h5.create_dataset(path, data=item, dtype=h5py.string_dtype('utf-8'))
        h5[path].attrs['type'] = 'str'
    elif isinstance(item, (bool, np.bool_)):
        h5.create_dataset(path, data=int(item))
        h5[path].attrs['type'] = 'bool'
    elif isinstance(item, (int, float, complex, np.generic)):
        h5.create_dataset(path, data=item)
        h5[path].attrs['type'] = 'scalar'
    elif isinstance(item, (list, tuple)):
        kind = 'list' if isinstance(item, list) else 'tuple'
        arr = None
        if len(item) > 0 and all(
                isinstance(x, type(item[0])) for x in item) and not isinstance(
                    item[0], (dict, list, tuple, type(None))):
            try:
                arr = np.asarray(item)
            except ValueError:
                arr = None
        if arr is not None and arr.dtype != object:
            if arr.dtype.char == 'U':
                ds = h5.create_dataset(path, shape=len(item),
                                       dtype=h5py.string_dtype('utf-8'))
                ds[:] = arr
            else:
                h5.create_dataset(path, data=arr)
            h5[path].attrs['type'] = kind
        else:
            grp = h5.require_group(path)
            grp.attrs['type'] = 'seq_' + kind
            grp.attrs['length'] = len(item)
            for i, x in enumerate(item):
                _save_node(h5py, h5, f'{path}/_{i}', x)
    elif isinstance(item, np.ndarray):
        if item.dtype.char == 'U' or item.dtype == object:
            ds = h5.create_dataset(path, shape=item.shape,
                                   dtype=h5py.string_dtype('utf-8'))
            ds[...] = item.astype(str)
        else:
            h5.create_dataset(path, data=item)
        h5[path].attrs['type'] = 'ndarray'
    else:
        raise ValueError(f'{path}: cannot serialize {type(item)} '
                         '(pickled nodes are not written)')


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


def save_dict_to_hdf5(filename, dic):
    """Save a nested dict to an HDF5 artifact file (atomically: written
    to ``filename + '.tmp'``, then renamed; removed if writing fails)."""
    import h5py
    tmp = filename + '.tmp'
    try:
        with h5py.File(tmp, 'w') as h5:
            h5.attrs['version'] = CURRENT_VERSION
            h5.attrs['writer'] = 'rvspecfit_torch'
            for k, v in dic.items():
                _save_node(h5py, h5, f'/{k}', v)
    except BaseException:
        os.remove(tmp)
        raise
    os.replace(tmp, filename)


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


def verify_data(original, loaded, path='/'):
    """Whether ``loaded`` equals ``original`` in structure, type and
    value (reference: rvspecfit_tpu/serializer.py:138): dicts by keys,
    sequences by length, strings and None exactly, arrays by shape and
    elements (NaNs equal), scalars by value (numpy scalars against
    Python ones).  Logs the first path that differs."""

    def fail(why):
        logging.warning('verify_data mismatch at %s: %s', path, why)
        return False

    if isinstance(original, dict):
        if not isinstance(loaded, dict):
            return fail(f'type {type(loaded).__name__} != dict')
        if set(original) != set(loaded):
            return fail(f'keys {sorted(original)} != {sorted(loaded)}')
        return all(verify_data(original[k], loaded[k], f'{path}/{k}')
                   for k in original)
    if original is None:
        return loaded is None or fail('expected None')
    if isinstance(original, str):
        return (isinstance(loaded, str) and original == loaded) \
            or fail('string mismatch')
    if isinstance(original, (list, tuple)):
        if not isinstance(loaded, (list, tuple)):
            return fail(f'type {type(loaded).__name__} != sequence')
        if len(original) != len(loaded):
            return fail(f'length {len(loaded)} != {len(original)}')
        return all(verify_data(o, v, f'{path}[{i}]')
                   for i, (o, v) in enumerate(zip(original, loaded)))
    if isinstance(original, np.ndarray) or hasattr(original, '__array__'):
        o, v = np.asarray(original), np.asarray(loaded)
        if o.shape != v.shape:
            return fail(f'shape {v.shape} != {o.shape}')
        ok = np.array_equal(o, v, equal_nan=o.dtype.kind in 'fc')
        return bool(ok) or fail('array values differ')
    try:
        if isinstance(original, (bool, np.bool_)):
            return bool(original) == bool(loaded) or fail('bool mismatch')
        eq = original == loaded
        if isinstance(original, float) and np.isnan(original):
            eq = np.isnan(loaded)
        return bool(eq) or fail(f'{loaded!r} != {original!r}')
    except Exception as exc:
        return fail(f'incomparable: {exc}')
