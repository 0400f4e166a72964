"""The port's file queues (rvspecfit_torch/utils.py) against the
reference's (rvspecfit_tpu/utils.py): the list, file and lock-file
queue modes of FileQueue, two processes popping one lock-file queue,
and the static rank/world sharding of ShardedFileQueue."""
import os
import subprocess
import sys

import pytest

from rvspecfit_tpu import utils as rutils
from rvspecfit_torch import utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEMS = [f'coadd-{i}.fits' for i in range(7)]


def _write(path, lines):
    path.write_text(''.join(f'{ln}\n' for ln in lines))
    return str(path)


@pytest.mark.parametrize('mode', ['list', 'file', 'queue'])
def test_file_queue_gives_the_reference_sequence(mode, tmp_path):
    """The same items in the same order as the reference's FileQueue;
    blank lines are skipped by the file mode as by the reference; the
    queue mode pops the file empty."""
    lines = ITEMS[:3] + [''] + ITEMS[3:] if mode == 'file' else ITEMS

    def make(mod, name):
        if mode == 'list':
            return mod.FileQueue(file_list=ITEMS)
        path = _write(tmp_path / name, lines)
        return mod.FileQueue(file_from=path, queue=mode == 'queue')

    got = list(make(utils, 'port.txt'))
    want = list(make(rutils, 'ref.txt'))
    assert got == want == ITEMS
    if mode == 'queue':
        assert (tmp_path / 'port.txt').read_text() == ''
        assert (tmp_path / 'ref.txt').read_text() == ''
        assert not list(tmp_path.glob('*.lock'))


def test_file_queue_needs_an_input_and_has_shutdown():
    with pytest.raises(ValueError):
        utils.FileQueue()
    q = utils.FileQueue(file_list=['a'])
    q.shutdown()
    assert list(q) == ['a']
    utils.ShardedFileQueue(['a']).shutdown()


_POPPER = r"""
import sys, time
sys.modules['jax'] = None
sys.modules['rvspecfit_tpu'] = None
from rvspecfit_torch import utils
q = utils.FileQueue(file_from=sys.argv[1], queue=True)
got = []
for item in q:
    got.append(item)
    time.sleep(0.01)
with open(sys.argv[2], 'w') as fp:
    fp.write('\n'.join(got))
"""


def test_two_processes_pop_every_line_once(tmp_path):
    """Two processes popping one lock-file queue at once: every line
    goes to exactly one of them, and the queue file ends empty."""
    items = [f'item{i:03d}' for i in range(40)]
    qfile = _write(tmp_path / 'queue.txt', items)
    outs = [str(tmp_path / f'got{r}.txt') for r in range(2)]
    procs = [subprocess.Popen([sys.executable, '-c', _POPPER, qfile, out],
                              cwd=REPO) for out in outs]
    for p in procs:
        assert p.wait(timeout=120) == 0
    got = [open(out).read().split() for out in outs]
    assert sorted(got[0] + got[1]) == items
    assert not set(got[0]) & set(got[1])
    assert (tmp_path / 'queue.txt').read_text() == ''


@pytest.mark.parametrize('rank,world', [(0, 1), (0, 2), (1, 2), (2, 3),
                                        (3, 4), (5, 8)])
def test_sharded_queue_matches_reference(rank, world):
    got = list(utils.ShardedFileQueue(ITEMS, rank=rank, world=world))
    want = list(rutils.ShardedFileQueue(ITEMS, rank=rank, world=world))
    assert got == want == ITEMS[rank::world]


def test_sharded_queue_defaults_to_the_launcher_variables(monkeypatch):
    """Rank and world default to torchrun's RANK and WORLD_SIZE (the
    reference reads RVS_TPU_RANK and RVS_TPU_WORLD), else 0 and 1."""
    monkeypatch.delenv('RANK', raising=False)
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    assert list(utils.ShardedFileQueue(ITEMS)) == ITEMS
    monkeypatch.setenv('RANK', '1')
    monkeypatch.setenv('WORLD_SIZE', '3')
    monkeypatch.setenv('RVS_TPU_RANK', '1')
    monkeypatch.setenv('RVS_TPU_WORLD', '3')
    assert list(utils.ShardedFileQueue(ITEMS)) == \
        list(rutils.ShardedFileQueue(ITEMS)) == ITEMS[1::3]
