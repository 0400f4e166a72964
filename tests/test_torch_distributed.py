"""The port's multi-process world (rvspecfit_torch/parallel/distributed.py)
on a torch.distributed.TCPStore: two torch-only processes (jax and the
JAX package blocked) claim items of one CoordinatedFileQueue, meet at a
barrier and close the world, with the criteria of the reference's
tests/test_distributed.py; a single-process world refuses the queue."""
import json
import os
import socket
import subprocess
import sys

import pytest

from rvspecfit_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, sys, time
sys.modules['jax'] = None
sys.modules['rvspecfit_tpu'] = None
from rvspecfit_torch.parallel import distributed
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
rec = {}
assert distributed.init_distributed(f'127.0.0.1:{port}', 2, rank) == (rank, 2)
claimed = []
for it in distributed.CoordinatedFileQueue([f'item{i}' for i in range(8)],
                                           name='testq'):
    claimed.append(it)
    # rank 1 is slow: rank 0 must drain the tail (dynamic balance)
    time.sleep(1.0 if rank == 1 else 0.02)
rec['claimed'] = claimed
if rank == 1:
    time.sleep(1.0)
rec['at_barrier'] = time.time()
distributed.barrier('testq_done')
rec['past_barrier'] = time.time()
if rank == 1:
    # rank 0 is in its shutdown by now; the store must still serve
    time.sleep(1.0)
    rec['late_claims'] = list(distributed.CoordinatedFileQueue(
        ['late0', 'late1'], name='lateq'))
    rec['late_done'] = time.time()
distributed.shutdown()
rec['shut'] = time.time()
assert 'jax' not in sys.modules or sys.modules['jax'] is None
with open(out, 'w') as fp:
    json.dump(rec, fp)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp('world')
    port = str(_free_port())
    outs = [str(root / f'rank{r}.json') for r in range(2)]
    procs = [subprocess.Popen([sys.executable, '-c', _WORKER, str(r), port,
                               outs[r]], cwd=REPO) for r in range(2)]
    rcs = [p.wait(timeout=120) for p in procs]
    assert rcs == [0, 0]
    return [json.load(open(o)) for o in outs]


def test_every_item_is_claimed_once_and_the_slow_rank_claims_fewer(
        two_ranks):
    c0, c1 = two_ranks[0]['claimed'], two_ranks[1]['claimed']
    assert sorted(c0 + c1) == sorted(f'item{i}' for i in range(8))
    assert not set(c0) & set(c1)
    # static rank::world sharding would give 4 and 4
    assert len(c0) >= 5, (c0, c1)


def test_barrier_holds_the_fast_rank(two_ranks):
    r0, r1 = two_ranks
    assert r0['at_barrier'] < r1['at_barrier']
    assert r0['past_barrier'] >= r1['at_barrier']


def test_rank0_finishing_first_does_not_break_rank1(two_ranks):
    """Rank 0 reaches its shutdown first; it keeps the store up until
    rank 1, which still claims items after the barrier, has shut down."""
    r0, r1 = two_ranks
    assert r1['late_claims'] == ['late0', 'late1']
    assert r0['shut'] >= r1['late_done']


def test_single_process_world_refuses_the_queue():
    with pytest.raises(RuntimeError, match='multi-process world'):
        distributed.CoordinatedFileQueue(['a', 'b'])
    assert distributed.init_distributed() == (0, 1)
    assert distributed._WORLD is None
    distributed.barrier('nothing')          # a no-op outside a world
    try:
        assert distributed.init_distributed(
            f'127.0.0.1:{_free_port()}', 1, 0) == (0, 1)
        assert (distributed._WORLD['rank'], distributed._WORLD['size']) \
            == (0, 1)
        with pytest.raises(RuntimeError, match='multi-process world'):
            distributed.CoordinatedFileQueue(['a', 'b'])
    finally:
        distributed.shutdown()
    assert distributed._WORLD is None


def test_world_arguments_fall_back_to_the_launcher_variables(monkeypatch):
    """MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK, as torchrun sets
    them; a coordinator without a rank raises."""
    port = _free_port()
    monkeypatch.setenv('MASTER_ADDR', '127.0.0.1')
    monkeypatch.setenv('MASTER_PORT', str(port))
    monkeypatch.setenv('WORLD_SIZE', '1')
    monkeypatch.setenv('RANK', '0')
    try:
        assert distributed.init_distributed() == (0, 1)
        assert distributed.local_rank() == 0
    finally:
        distributed.shutdown()
    monkeypatch.delenv('RANK')
    with pytest.raises(ValueError, match='rank'):
        distributed.init_distributed(f'127.0.0.1:{port}', 2)


def test_device_per_rank_and_no_cpu_fallback(monkeypatch):
    """Under a world the default device is card rank % device_count();
    without a card it still raises."""
    import torch
    from rvspecfit_torch import device
    monkeypatch.setenv('LOCAL_RANK', '3')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert device.resolve_device(None) == torch.device('cuda', 1)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        device.resolve_device(None)
    assert device.resolve_device('cpu') == torch.device('cpu')


_TORCHRUN_RANK = r"""
import json, os, sys
sys.modules['jax'] = None
sys.modules['rvspecfit_tpu'] = None
from rvspecfit_torch.parallel import distributed
rank, size = distributed.init_distributed()
got = list(distributed.CoordinatedFileQueue([f'item{i}' for i in range(6)]))
distributed.barrier('done')
distributed.shutdown()
with open(os.path.join(sys.argv[1], f'rank{rank}.json'), 'w') as fp:
    json.dump(dict(rank=rank, size=size, local=distributed.local_rank(),
                   claimed=got), fp)
"""


def test_world_under_torchrun(tmp_path):
    """Under torchrun (whose agent hosts the store at MASTER_PORT) the
    ranks connect to the agent's store: the world's rank and size are
    torchrun's, and every item is claimed once."""
    script = tmp_path / 'rank.py'
    script.write_text(_TORCHRUN_RANK)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
         '2', '--master_port', str(_free_port()), str(script),
         str(tmp_path)], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.load(open(tmp_path / f'rank{r}.json')) for r in range(2)]
    assert [(r['rank'], r['size'], r['local']) for r in recs] == \
        [(0, 2, 0), (1, 2, 1)]
    claimed = recs[0]['claimed'] + recs[1]['claimed']
    assert sorted(claimed) == [f'item{i}' for i in range(6)]
