"""Multi-process worlds of the drivers on a ``torch.distributed.TCPStore``.

Counterpart of rvspecfit_tpu/parallel/distributed.py.  Fits are
independent per file and per fiber, so no tensor crosses processes and
no process group (NCCL or gloo) is made: the world is one key-value
store that rank 0 hosts at the coordinator's ``host:port`` and every
other rank connects to.  It serves the end-of-run :func:`barrier` and
the dynamic :class:`CoordinatedFileQueue` (the reference's MPI task
farm without a server thread or a shared filesystem).

A driver opens the world with :func:`init_distributed` when it is given
``--coordinator`` or when ``MASTER_ADDR`` is set (as ``torchrun`` sets
it), and closes it with :func:`barrier` and :func:`shutdown`.  The
world lives in this module for the life of the process, as
``torch.distributed``'s own default group does.

Under ``torchrun`` the launcher's agent already hosts a store at
``MASTER_ADDR:MASTER_PORT`` (``TORCHELASTIC_USE_AGENT_STORE=True``):
every rank then connects to that one as a client.  The world's keys
live under the prefix ``rvspecfit_torch/``.

Rank 0 owns the store: if it exited first, the other ranks would lose
their queue and barrier.  :func:`shutdown` therefore keeps rank 0, and
so the store, up until every rank has reached its own shutdown.
"""
from __future__ import annotations

import datetime
import logging
import os

_WORLD = None          # the open world: dict(store, rank, size, barriers)
BARRIER_TIMEOUT_MS = 6 * 3600 * 1000


def _timeout_ms(timeout_ms=None):
    if timeout_ms is None:
        timeout_ms = int(os.environ.get('RVST_BARRIER_TIMEOUT_MS',
                                        BARRIER_TIMEOUT_MS))
    return datetime.timedelta(milliseconds=int(timeout_ms))


def _env_int(name):
    val = os.environ.get(name)
    return None if val in (None, '') else int(val)


def init_distributed(coordinator=None, num_processes=None,
                     process_id=None):
    """Open the world (idempotent, opt-in): rank 0 hosts the store at
    ``coordinator`` (``host:port``), the other ranks connect to it.

    The arguments fall back to ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  Returns (rank, world size); (0, 1)
    when no coordinator is configured.  Rank 0 waits for every rank to
    connect, for at most the barrier timeout
    (``RVST_BARRIER_TIMEOUT_MS``, default 6 h)."""
    global _WORLD
    if coordinator is None and os.environ.get('MASTER_ADDR'):
        coordinator = '%s:%s' % (os.environ['MASTER_ADDR'],
                                 os.environ.get('MASTER_PORT', '29500'))
    if num_processes is None:
        num_processes = _env_int('WORLD_SIZE')
    if process_id is None:
        process_id = _env_int('RANK')
    if not coordinator:
        return 0, 1
    if _WORLD is not None:
        return _WORLD['rank'], _WORLD['size']
    if num_processes is None or process_id is None:
        raise ValueError('a world needs its size and this process\'s rank '
                         '(--world/--rank, or WORLD_SIZE/RANK)')
    if not 0 <= process_id < num_processes:
        raise ValueError(f'rank {process_id} is outside a world of '
                         f'{num_processes}')
    from torch.distributed import PrefixStore, TCPStore
    host, port = coordinator.rsplit(':', 1)
    agent = os.environ.get('TORCHELASTIC_USE_AGENT_STORE') == 'True'
    store = PrefixStore('rvspecfit_torch', TCPStore(
        host, int(port), world_size=num_processes,
        is_master=process_id == 0 and not agent, timeout=_timeout_ms(),
        wait_for_workers=not agent))
    _WORLD = dict(store=store, rank=int(process_id),
                  size=int(num_processes), barriers={})
    logging.info('world up: rank %d of %d (store at %s)', process_id,
                 num_processes, coordinator)
    return _WORLD['rank'], _WORLD['size']


def local_rank():
    """The rank that picks this process's card: ``LOCAL_RANK`` where
    it is set (``torchrun``), else the open world's rank, else None."""
    env = _env_int('LOCAL_RANK')
    if env is not None:
        return env
    return None if _WORLD is None else _WORLD['rank']


def barrier(name='rvspecfit_torch_barrier', timeout_ms=None):
    """Wait until every rank of the world has reached the barrier
    ``name`` (a no-op outside a multi-process world).

    Each rank adds one to a counter in the store; the rank that brings
    it to the world size opens the barrier, which the others wait for.
    A name may be passed several times: each pass has a key of its own.
    Raises when the barrier does not open within ``timeout_ms``
    (default ``RVST_BARRIER_TIMEOUT_MS``, else 6 h: end-of-run skew
    between ranks is bounded by one file's fit time)."""
    if _WORLD is None or _WORLD['size'] <= 1:
        return
    gen = _WORLD['barriers'].get(name, 0)
    _WORLD['barriers'][name] = gen + 1
    key = f'barrier/{name}/{gen}'
    store = _WORLD['store']
    if store.add(key + '/arrived', 1) == _WORLD['size']:
        store.set(key + '/open', b'1')
    store.wait([key + '/open'], _timeout_ms(timeout_ms))


class CoordinatedFileQueue:
    """Dynamic work distribution over the world's store.

    Every rank holds the same ordered file list; iterating claims the
    next unclaimed item only when the consumer asks for it, first
    writer wins (``store.add(f'{name}/{i}', 1) == 1``).  A slow file
    delays only its own rank and fast ranks drain the tail: the dynamic
    balance that static ``files[rank::world]`` sharding loses, with no
    shared filesystem (``utils.FileQueue``'s lock-file queue needs
    one).

    Raises RuntimeError outside a multi-process world, or when the
    store fails its capability probe (a key written and read back).
    """

    def __init__(self, file_list, name='rvst_cq'):
        if _WORLD is None or _WORLD['size'] <= 1:
            raise RuntimeError('CoordinatedFileQueue needs a multi-process '
                               'world (init_distributed with a '
                               'coordinator and a world size > 1)')
        self._store = _WORLD['store']
        self._rank = _WORLD['rank']
        self._list = list(file_list)
        self._name = name
        probe = f'{name}/probe_{self._rank}'
        try:
            self._store.set(probe, b'ok')
            got = self._store.get(probe)
        except Exception as exc:
            raise RuntimeError('the world\'s key-value store failed its '
                               'capability probe') from exc
        if got != b'ok':
            raise RuntimeError(f'the store\'s probe read back {got!r} '
                               "(expected b'ok')")

    def __iter__(self):
        for i, f in enumerate(self._list):
            if self._store.add(f'{self._name}/{i}', 1) == 1:
                logging.info('claimed work item %d (%s)', i, f)
                yield f

    def shutdown(self):
        pass


def shutdown(timeout_ms=None):
    """Close the world.  Every rank counts itself out in the store; rank
    0, which hosts it, waits until the last rank has done so, so that no
    rank loses the store while it still uses it."""
    global _WORLD
    if _WORLD is None:
        return
    w, _WORLD = _WORLD, None
    if w['size'] > 1:
        store = w['store']
        if store.add('shutdown/out', 1) == w['size']:
            store.set('shutdown/all_out', b'1')
        if w['rank'] == 0:
            store.wait(['shutdown/all_out'], _timeout_ms(timeout_ms))
    logging.info('world closed: rank %d of %d', w['rank'], w['size'])
