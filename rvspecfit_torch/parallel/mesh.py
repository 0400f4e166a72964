"""Fiber sharding of the batched fitter over the devices of one process.

Counterpart of rvspecfit_tpu/parallel/mesh.py.  The reference lays the
fiber axis over a ``jax.sharding.Mesh`` and lets XLA partition every
stage; here a mesh is a tuple of torch devices, and
:func:`shard_fitter` cuts the fiber axis into contiguous shards, one
per mesh entry, each a fitter of its own:

- its arms (the likelihood's per-fiber tensors) on its device;
- the template models on its device (pipeline/library.model_on,
  cached under the library's device key);
- one host thread, whose first statement is ``torch.cuda.set_device``
  (device.enter_device): the C launchers launch on the thread's current
  device.

Every stage of the fitter then runs shard by shard, the shards' threads
at once, and the results are concatenated in fiber order, as the
microbatch tiles are; shards and ``fit_microbatch`` tiles compose (each
shard tiles its own fibers).  Fibers are independent, so a sharded fit
is the unsharded one fiber by fiber.

A mesh may name a device more than once (two shards on one card, or on
the CPU).  The reference pads the fiber axis to a multiple of the mesh,
which NamedSharding needs; shards here may differ by one fiber, so
nothing is padded.

:func:`auto_shard` is the drivers' entry: it shards over every card of
the host, and does nothing on a one-card host, in a process that is a
rank of a multi-process world (its devices are its one card, as the
reference's ``jax.local_devices()`` are a rank's), or with
``RVST_NO_MESH=1``.

:func:`make_grid` lays devices out as a two-axis grid, the counterpart
of the reference's ``Mesh(devices.reshape(D, M), ('data', 'model'))``
that its NN trainer shards over (pipeline/train_nn.py ``mesh=``).
"""
from __future__ import annotations

import concurrent.futures
import copy
import os
import weakref
from typing import NamedTuple

import numpy as np
import torch

from rvspecfit_torch.device import concrete, enter_device, map_tensors
from rvspecfit_torch.fit.batch import BatchArm
from rvspecfit_torch.parallel import distributed
from rvspecfit_torch.pipeline import library


def make_mesh(devices):
    """A mesh: the tuple of torch devices of ``devices`` (names or
    devices, repeats allowed; a card named without an index is the
    calling thread's current one)."""
    mesh = tuple(concrete(d) for d in devices)
    if not mesh:
        raise ValueError('a mesh needs at least one device')
    return mesh


class Grid(NamedTuple):
    """A two-axis device grid: ``devices`` holds shape[0] rows of
    shape[1] torch devices, ``axis_names`` names the rows' axis, then
    the columns'."""
    devices: tuple
    axis_names: tuple

    @property
    def shape(self):
        return len(self.devices), len(self.devices[0])

    def layout(self, row_axis, col_axis):
        """The devices as rows over ``row_axis`` of columns over
        ``col_axis`` (transposed where the grid names them the other
        way round)."""
        if (row_axis, col_axis) == self.axis_names:
            return self.devices
        if (col_axis, row_axis) == self.axis_names:
            return tuple(zip(*self.devices))
        raise ValueError(f'the grid\'s axes are {self.axis_names}, not '
                         f'{row_axis!r} and {col_axis!r}')


def make_grid(devices, shape, axis_names=('data', 'model')):
    """The devices of ``devices`` (names or devices, repeats allowed, as
    :func:`make_mesh` takes them) laid out row-major as a grid of
    ``shape`` (rows, columns) with ``axis_names``: grid.devices[d][m]
    is the device of row d and column m."""
    flat = make_mesh(devices)
    rows, cols = (int(n) for n in shape)
    if rows < 1 or cols < 1 or rows * cols != len(flat):
        raise ValueError(f'{len(flat)} devices do not make a grid of shape '
                         f'{tuple(shape)}')
    axis_names = tuple(axis_names)
    if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
        raise ValueError(f'a grid needs two axis names, not {axis_names}')
    return Grid(tuple(flat[r * cols:(r + 1) * cols] for r in range(rows)),
                axis_names)


def shard_bounds(nfibers, nshards):
    """Contiguous [lo, hi) fiber ranges of ``nshards`` shards whose
    sizes differ by at most one, the larger first (numpy's
    array_split)."""
    q, r = divmod(int(nfibers), int(nshards))
    edges = np.cumsum([0] + [q + (i < r) for i in range(nshards)])
    return [(int(lo), int(hi)) for lo, hi in zip(edges[:-1], edges[1:])]


def _host_rows(arm, lo, hi):
    """The BatchArm of fibers [lo, hi) of ``arm``."""
    return BatchArm(arm.name, arm.lam, arm.flux[lo:hi], arm.ivar[lo:hi],
                    badmask=arm.badmask[lo:hi],
                    resolution=None if arm.resolution is None
                    else np.asarray(arm.resolution)[lo:hi],
                    setup=arm.setup)


def _shard(bf, lo, hi, device):
    """The fitter of fibers [lo, hi) of ``bf`` on ``device``."""
    sh = copy.copy(bf)
    idx = torch.arange(lo, hi, device=bf.device)
    sh.arms = [map_tensors(a.take(idx), lambda t: t.to(device))
               for a in bf.arms]
    sh.batch_arms = [_host_rows(a, lo, hi) for a in bf.batch_arms]
    sh.templates = {s: library.model_on(tm, device)
                    for s, tm in bf.templates.items()}
    sh.device = device
    sh.nfibers = hi - lo
    sh.fiber_lo = lo
    sh.shards = sh.shard_pools = None
    return sh


def shard_fitter(bf, mesh):
    """Lay the fiber axis of BatchedFitter ``bf`` over ``mesh`` (see the
    module docstring): its stages then run shard by shard.  A fitter
    with fewer fibers than the mesh has devices takes one shard per
    fiber.  Returns ``bf``."""
    mesh = make_mesh(mesh)
    if bf.shards:
        raise ValueError('the fitter is already sharded')
    bounds = shard_bounds(bf.nfibers, min(len(mesh), bf.nfibers))
    shards = [_shard(bf, lo, hi, dev) for (lo, hi), dev in zip(bounds, mesh)]
    pools = ShardPools(concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix=f'rvst-shard{i}',
        initializer=enter_device, initargs=(sh.device,))
        for i, sh in enumerate(shards))
    bf.shards, bf.shard_pools = shards, pools
    return bf


class ShardPools(list):
    """The shards' threads, one single-worker pool per shard.  A sharded
    fitter and every snapshot of it (a deferred tail's,
    BatchedFitter._snapshot) hold this one list, and the pools shut
    down when the last of them lets it go."""

    def __init__(self, pools):
        super().__init__(pools)
        weakref.finalize(self, _shutdown, tuple(self))


def _shutdown(pools):
    for pool in pools:
        pool.shutdown(wait=False)


def local_devices(device):
    """The devices a fitter on ``device`` may shard over: every CUDA
    card of the host, except in a process that is a rank of a
    multi-process world (``LOCAL_RANK`` set, or a world opened by
    parallel/distributed), whose devices are its own card; a CPU
    fitter's device alone."""
    device = torch.device(device)
    if device.type != 'cuda' or distributed.local_rank() is not None:
        return [device]
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def auto_shard(bf, devices=None, min_devices=2):
    """Shard ``bf`` over ``devices`` (None: :func:`local_devices` of its
    device) when there are at least ``min_devices`` and
    ``RVST_NO_MESH`` is not ``1``.  Returns the mesh, or None where it
    did nothing."""
    if os.environ.get('RVST_NO_MESH') == '1':
        return None
    if devices is None:
        devices = local_devices(bf.device)
    if len(devices) < min_devices:
        return None
    mesh = make_mesh(devices)
    shard_fitter(bf, mesh)
    return mesh


def shard_trials(bf, vels, params, vsinis=None):
    """Per-fiber trial arrays of ``bf`` as tensors in its dtype on its
    device (``vsinis`` may be None); each stage hands every shard its
    rows on the shard's device."""
    put = lambda x: torch.as_tensor(np.asarray(x, np.float64),  # noqa: E731
                                    dtype=bf.dtype, device=bf.device)
    return put(vels), put(params), None if vsinis is None else put(vsinis)
