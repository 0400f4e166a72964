"""Configuration and input-file lists of the drivers.

The config part and the static file list of rvspecfit_tpu/utils.py:
YAML config -> defaults merge -> frozen mapping, and the iterator over
input files.  ``yaml`` is imported where a config file is read, so the
module imports without it (the card's machine has none).  Not ported:
the lock-file queue (``--queue_file``), ``ShardedFileQueue`` and the
JAX compile-cache helpers.
"""
from __future__ import annotations

import logging
import os

from rvspecfit_torch.frozendict import frozendict


def get_default_config():
    """Default fit configuration (keys mirror the reference semantics,
    reference: py/rvspecfit/utils.py:9-28)."""
    return {
        'min_vel': -1000,
        'max_vel': 1000,
        'vel_step0': 5,
        'max_vsini': 500,
        'min_vsini': 1e-2,
        'min_vel_step': 0.2,
        'second_minimizer': True,
        'template_lib': 'templ_data/',
    }


def freeze(obj):
    """Recursively freeze dicts -> frozendict, lists -> tuples."""
    if isinstance(obj, dict):
        return frozendict({k: freeze(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return tuple(freeze(v) for v in obj)
    return obj


def read_config(fname=None, override_options=None):
    """Read a YAML config, fill defaults, apply overrides, freeze.

    Without ``fname``, ``config.yaml`` in the working directory is read
    if it exists; a named file that does not exist raises.
    """
    fname_specified = fname is not None
    if fname is None:
        fname = 'config.yaml'
    if os.path.exists(fname):
        import yaml
        with open(fname) as fp:
            conf = yaml.safe_load(fp)
        if conf is None:
            conf = {}
            logging.warning('Configuration file %s is empty; using defaults',
                            fname)
    else:
        if fname_specified:
            raise RuntimeError(f"Configuration file '{fname}' not found.")
        logging.warning("Configuration file '%s' not found; using defaults",
                        fname)
        conf = {}
    for k, v in get_default_config().items():
        conf.setdefault(k, v)
    conf['config_file_path'] = os.path.abspath(fname)
    if override_options:
        for k, v in override_options.items():
            if k in conf and conf[k] != v:
                logging.warning('Option %s overrides the config-file value', k)
            conf[k] = v
    return freeze(conf)


class FileQueue:
    """Iterator over input files: a list, or the lines of a text file
    (read once, blank lines skipped)."""

    def __init__(self, file_list=None, file_from=None):
        if file_list is not None:
            self.file_list = list(file_list)
        elif file_from is not None:
            with open(file_from) as fp:
                self.file_list = [ln.rstrip('\n') for ln in fp
                                  if ln.strip()]
        else:
            raise ValueError('provide file_list or file_from')

    def __iter__(self):
        return self

    def __next__(self):
        if self.file_list:
            return self.file_list.pop(0)
        raise StopIteration
