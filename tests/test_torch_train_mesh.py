"""The port's NN trainer on a (data, model) device grid
(pipeline/train_nn.py ``mesh=``, parallel/mesh.make_grid) against its
unsharded run and against the reference's sharded trainer, in float64
on the CPU.

Grids name the CPU several times: the arithmetic is the sharded
layout's (column blocks of the hidden layers, the bottleneck's partial
products summed over the model axis, the batch's parts' L1 means
averaged, the copies' gradients summed over the data parts), whatever
the devices.  The sharded and unsharded runs differ by rounding alone,
~3e-16 relative after 4 epochs, held to the trainer tests' 1e-10."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from rvspecfit_tpu import serializer as rserializer
from rvspecfit_tpu.pipeline import train_nn as rtrain
from rvspecfit_torch.interp import nn
from rvspecfit_torch.parallel import mesh as pmesh
from rvspecfit_torch.pipeline import train_nn

from test_torch_train_nn import (RTOL, SMALL, _assert_weights_close,
                                 _epoch0_checkpoints, _training_set)

GRID = pmesh.make_grid(['cpu'] * 4, (2, 2))


def _assert_models_close(got, want, rtol=RTOL):
    """Every float array of the two payloads within rtol of its largest
    entry; the rest equal."""
    a, b = nn.state_to_dict(got), nn.state_to_dict(want)
    assert set(a) == set(b)
    for k, w in b.items():
        if isinstance(w, np.ndarray) and w.dtype.kind == 'f':
            assert np.abs(a[k] - w).max() <= rtol * max(np.abs(w).max(),
                                                        1e-300), k
        else:
            assert a[k] == w, k


@pytest.mark.parametrize('withbn', [False, True])
def test_grid_matches_unsharded_from_one_checkpoint(tmp_path, withbn):
    """4 epochs on a (2, 2) grid and unsharded from one epoch-0
    checkpoint (non-zero biases and batch-norm shifts): losses within
    rtol 1e-10, the folded weights within 1e-10 of each array's largest
    entry; the returned model is an unsharded NNInterpolator on the
    trainer's device without gradients."""
    x, specs = _training_set()
    ck, ck2 = _epoch0_checkpoints(tmp_path, withbn)
    kw = dict(SMALL, num_epochs=4, pca_init=False, withbn=withbn,
              resume=True, checkpoint_every=100, device='cpu')
    want, whist = train_nn.train_interpolator(x, specs, checkpoint_path=ck,
                                              **kw)
    got, hist = train_nn.train_interpolator(x, specs, checkpoint_path=ck2,
                                            mesh=GRID, **kw)
    np.testing.assert_allclose(hist['loss'], whist['loss'], rtol=RTOL)
    assert hist['lr'] == whist['lr'] and hist['loss'][-1] < hist['loss'][0]
    _assert_models_close(got, want)
    assert isinstance(got, nn.NNInterpolator)
    assert got.mean.device.type == 'cpu'
    assert not any(p.requires_grad for p in got.parameters())
    assert got.bn_layers == ((1, 2) if withbn else ())


def test_grid_matches_reference_sharded_trainer(tmp_path):
    """A (4, 2) grid against the reference's trainer on a (4, 2) mesh of
    the 8 host devices (tests/test_train_nn.py's layout), with PCA
    initialization, from one epoch-0 checkpoint: losses and weights
    within 1e-10 (measured: losses 4.4e-16 relative, weights 1.0e-14
    of each array's largest entry; XLA partitions the reference's
    reductions, which moves its own sharded weights 5.1e-15 from its
    unsharded ones, a reordering of sums well inside the limit)."""
    x, specs = _training_set(npix=64)
    ck_ref, ck_port = _epoch0_checkpoints(tmp_path, False, npix=64)
    kw = dict(SMALL, num_epochs=4, pca_init=True, resume=True,
              checkpoint_every=100)
    rmesh = Mesh(np.array(jax.devices()).reshape(4, 2), ('data', 'model'))
    rstate, rhist = rtrain.train_interpolator(
        x, specs, checkpoint_path=ck_ref, mesh=rmesh, **kw)
    model, hist = train_nn.train_interpolator(
        x, specs, checkpoint_path=ck_port, device='cpu',
        mesh=pmesh.make_grid(['cpu'] * 8, (4, 2)), **kw)
    np.testing.assert_allclose(hist['loss'], rhist['loss'], rtol=RTOL)
    assert hist['lr'] == rhist['lr']
    _assert_weights_close(model, rstate)


def test_grid_checkpoints_and_resume(tmp_path):
    """Checkpoints under a grid hold the gathered weights (the payload
    the reference reads); resuming from one on the grid trains only the
    remaining epochs and ends where an unsharded resume ends."""
    x, specs = _training_set()
    ck = str(tmp_path / 'ck.h5')
    kw = dict(SMALL, pca_init=False, checkpoint_every=3, device='cpu')
    train_nn.train_interpolator(x, specs, num_epochs=7, mesh=GRID,
                                checkpoint_path=ck, **kw)
    saved = rserializer.load_dict_from_hdf5(ck)
    assert int(saved['epoch']) == 6
    assert set(saved['state']) == set(nn.state_to_dict(
        train_nn.train_interpolator(x, specs, num_epochs=0, **kw)[0]))
    ck2 = str(tmp_path / 'ck2.h5')
    rserializer.save_dict_to_hdf5(ck2, saved)
    got, hist = train_nn.train_interpolator(
        x, specs, num_epochs=9, resume=True, mesh=GRID, checkpoint_path=ck,
        **kw)
    want, whist = train_nn.train_interpolator(
        x, specs, num_epochs=9, resume=True, checkpoint_path=ck2, **kw)
    assert len(hist['loss']) == 9 - 6
    np.testing.assert_allclose(hist['loss'], whist['loss'], rtol=RTOL)
    _assert_models_close(got, want)


@pytest.mark.parametrize('shape,batch_size,ntrain,match', [
    ((1, 3), 64, 300, 'width 32'),
    ((3, 1), 64, 300, 'batch of 64'),
    ((2, 1), 1000, 299, 'batch of 299'),
])
def test_uneven_grid_raises(shape, batch_size, ntrain, match):
    """The width must split over the model axis, and the batch (the
    training set where it is smaller) over the data axis, as the
    reference's NamedSharding requires."""
    x, specs = _training_set()
    grid = pmesh.make_grid(['cpu'] * (shape[0] * shape[1]), shape)
    with pytest.raises(ValueError, match=match):
        train_nn.train_interpolator(
            x[:ntrain], specs[:ntrain], mesh=grid, device='cpu',
            **dict(SMALL, num_epochs=1, batch_size=batch_size))


def test_make_grid_layout():
    """Row-major layout, repeats allowed; axes looked up by name (a grid
    named (model, data) is read transposed); sizes and names checked."""
    grid = pmesh.make_grid(['cpu', 'meta', 'cpu', 'meta'], (2, 2),
                           ('model', 'data'))
    assert grid.shape == (2, 2)
    assert [d.type for d in grid.devices[0]] == ['cpu', 'meta']
    assert [d.type for d in grid.layout('data', 'model')[0]] == ['cpu', 'cpu']
    with pytest.raises(ValueError, match='grid of shape'):
        pmesh.make_grid(['cpu'] * 3, (2, 2))
    with pytest.raises(ValueError, match='two axis names'):
        pmesh.make_grid(['cpu'] * 4, (2, 2), ('data', 'data'))
    with pytest.raises(ValueError, match='axes'):
        grid.layout('data', 'fiber')
