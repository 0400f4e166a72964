"""Configuration and input-file lists of the drivers.

The config part and the file queues of rvspecfit_tpu/utils.py: YAML
config -> defaults merge -> frozen mapping; the iterator over input
files (a list, the lines of a file, or that file as a lock-file queue
shared by processes on a shared filesystem); and the static
``files[rank::world]`` sharding.  ``yaml`` is imported where a config
file is read, so the module imports without it (the card's machine has
none).  Not ported: the JAX compile-cache helpers.

Rank and world default to ``RANK`` and ``WORLD_SIZE``, the variables
``torchrun`` sets (the reference reads ``RVS_TPU_RANK`` and
``RVS_TPU_WORLD``).
"""
from __future__ import annotations

import logging
import os
import socket
import time

import numpy as np

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
    """Iterator over input files: a list, the lines of a text file
    (read once, blank lines skipped), or, with ``queue=True``, that file
    as a work queue shared by every process that pops from it.

    A pop renames the file to a name of this host and process, takes
    its first line off and renames it back, so on a shared filesystem
    each line goes to exactly one consumer, and a consumer takes a line
    only when it asks for the next file.  A consumer that finds the
    file renamed away waits 1-1.5 s and tries again, 1000 times at most.
    """

    def __init__(self, file_list=None, file_from=None, queue=False):
        self.file_from = None
        self.queue = False
        if file_list is not None:
            self.file_list = list(file_list)
        elif file_from is not None:
            if queue:
                self.file_list = None
                self.file_from = file_from
                self.queue = True
            else:
                with open(file_from) as fp:
                    self.file_list = [ln.rstrip('\n') for ln in fp
                                      if ln.strip()]
        else:
            raise ValueError('provide file_list or file_from')

    def __iter__(self):
        return self

    def __next__(self):
        if self.file_list is not None:
            if self.file_list:
                return self.file_list.pop(0)
            raise StopIteration
        return self._pop_locked()

    def _pop_locked(self):
        lockname = '%s.%s.%d.lock' % (self.file_from, socket.gethostname(),
                                      os.getpid())
        wait = 1.0
        for _ in range(1000):
            try:
                os.rename(self.file_from, lockname)
            except FileNotFoundError:
                time.sleep(np.random.uniform(wait, 1.5 * wait))
                continue
            try:
                with open(lockname) as fp:
                    lines = fp.readlines()
                if not lines:
                    raise StopIteration
                with open(lockname, 'w') as fp:
                    fp.writelines(lines[1:])
                return lines[0].rstrip('\n')
            finally:
                os.rename(lockname, self.file_from)
        logging.warning('Could not acquire the queue-file lock')
        raise StopIteration

    def shutdown(self):
        pass


def _env_int(name, default):
    val = os.environ.get(name)
    return default if val in (None, '') else int(val)


class ShardedFileQueue:
    """Static round-robin sharding of a file list: rank ``rank`` of
    ``world`` processes takes ``files[rank::world]``.  ``rank`` and
    ``world`` default to the ``RANK`` and ``WORLD_SIZE`` environment
    variables (0 and 1 where they are unset)."""

    def __init__(self, file_list, rank=None, world=None):
        if rank is None:
            rank = _env_int('RANK', 0)
        if world is None:
            world = _env_int('WORLD_SIZE', 1)
        self.files = list(file_list)[rank::max(world, 1)]

    def __iter__(self):
        return iter(self.files)

    def shutdown(self):
        pass
