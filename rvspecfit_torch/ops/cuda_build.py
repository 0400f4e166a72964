"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
nvcc for Hopper (``sm_90a``) into ``_build/lib<name>_<hash>.so`` the
first time a kernel of that file is needed; the file hash is part of
the library name, so editing a source rebuilds it.  Nothing here runs
at import: this module only defines functions, so the CPU-only tests
can import every module of the port.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from rvspecfit_torch import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD = _PKG / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

def nvcc_path():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    return os.path.join(home, 'bin', 'nvcc')


# one lock per source: threads that need one library at once build it
# once, and different sources still build in parallel
_locks = collections.defaultdict(threading.Lock)
_locks_lock = threading.Lock()


def load(name):
    """ctypes handle of ``csrc/<name>.cu``, compiled on first use (by
    one thread; the others wait for it)."""
    with _locks_lock:
        lock = _locks[name]
    with lock:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name):
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD / f'lib{name}_{digest}.so'
    if not lib.exists():
        BUILD.mkdir(exist_ok=True)
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.'
                           f'{threading.get_ident()}.tmp')
        # kept (trace.kept('kernel.build')) with the seconds nvcc took
        # and what ptxas reported (registers, spills)
        with trace.span('kernel.build', keep=True, kernel=name) as sp:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, '-o',
                                   str(tmp), str(src)],
                                  capture_output=True, text=True)
            sp.set(ptxas=proc.stderr.strip())
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on {src}:\n{proc.stderr}')
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def check_launch(err, name):
    """Raise if the C launcher returned a non-zero cudaError_t."""
    if err:
        raise RuntimeError(f'{name}: CUDA launch failed with '
                           f'cudaError_t {err}')


def current_stream(tensor):
    """Raw cudaStream_t (as int) of torch's current stream on the
    tensor's device."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
