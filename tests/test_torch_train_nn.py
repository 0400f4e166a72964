"""The port's NN trainer (pipeline/train_nn.py) and its serializer's
writer against the JAX reference's, in float64 on the CPU.

Both trainers draw their own initial weights (a torch.Generator here,
a jax PRNG key there), so parity runs start both from one reference
init_state written as an epoch-0 checkpoint (``resume=True`` restores
the weights only, on both sides).  From there the batches (one
RandomState), the loss, Adam and the schedule are the same: the two
runs differ by rounding alone, ~1e-15 relative after 4 epochs, held to
1e-10 (Adam divides by sqrt(v) + 1e-8, so a rounding difference of a
gradient near 1e-8 is amplified, and an L1 residual that changes sign
changes one gradient entry by 2/N)."""
import os

import jax
import numpy as np
import pytest
import torch

from rvspecfit_tpu import serializer as rserializer
from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.interp import nn as rnn
from rvspecfit_tpu.pipeline import library as rlib
from rvspecfit_tpu.pipeline import train_nn as rtrain
from rvspecfit_torch import serializer
from rvspecfit_torch.interp import nn
from rvspecfit_torch.pipeline import library, train_nn

RTOL = 1e-10
SMALL = dict(width=32, nlayers=2, npc=8, batch_size=64, lr0=1e-3, seed=5)


def _training_set(npix=60):
    """tests/test_train_nn.py's set: 300 templates of the 5,5,4,3 grid
    as (nspec, 4) mapped parameters and (nspec, npix) log-spectra."""
    lam, uvecs, idgrid, vecs, specs, parnames = rsim.make_template_grid(
        5, 5, 4, 3, npix=npix)
    return vecs.T, specs


def _epoch0_checkpoints(tmp_path, withbn, npix=60):
    """One reference init_state (random, non-zero biases) written as an
    epoch-0 checkpoint twice: (reference's copy, port's copy)."""
    st = rnn.init_state(jax.random.PRNGKey(7), 4, SMALL['width'],
                        SMALL['nlayers'], SMALL['npc'], npix, withbn=withbn)
    payload = rnn.state_to_dict(st)
    rng = np.random.RandomState(8)
    for k in payload:
        if k.startswith(('b_', 'bn_shift')):
            payload[k] = 0.1 * rng.normal(size=payload[k].shape)
    paths = [str(tmp_path / f'ck_{side}.h5') for side in ('ref', 'port')]
    for p in paths:
        rserializer.save_dict_to_hdf5(p, dict(state=payload, epoch=0))
    return paths


def _assert_weights_close(model, rstate, rtol=RTOL):
    got, want = nn.state_to_dict(model), rnn.state_to_dict(rstate)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray) and w.dtype.kind == 'f':
            scale = max(np.abs(w).max(), 1e-300)
            assert np.abs(got[k] - w).max() <= rtol * scale, k
        else:
            assert got[k] == w, k


@pytest.mark.parametrize('withbn', [False, True])
def test_training_matches_reference_from_one_checkpoint(tmp_path, withbn):
    """4 epochs (4 steps each, the last partial batch dropped) from one
    checkpoint: loss histories within rtol 1e-10, the final folded
    weights within 1e-10 of each array's largest entry."""
    x, specs = _training_set()
    ck_ref, ck_port = _epoch0_checkpoints(tmp_path, withbn)
    kw = dict(SMALL, num_epochs=4, pca_init=False, withbn=withbn,
              resume=True, checkpoint_every=100)
    rstate, rhist = rtrain.train_interpolator(x, specs,
                                              checkpoint_path=ck_ref, **kw)
    model, hist = train_nn.train_interpolator(x, specs,
                                              checkpoint_path=ck_port,
                                              device='cpu', **kw)
    assert len(hist['loss']) == 4
    np.testing.assert_allclose(hist['loss'], rhist['loss'], rtol=RTOL)
    assert hist['lr'] == rhist['lr']
    for k in ('t_mean', 't_std'):
        np.testing.assert_array_equal(hist[k], rhist[k])
    assert hist['spread0'] == rhist['spread0']
    assert hist['loss'][-1] < hist['loss'][0]
    _assert_weights_close(model, rstate)
    assert not any(p.requires_grad for p in model.parameters())
    assert model.bn_layers == ((1, 2) if withbn else ())


def test_pca_layer_matches_sklearn():
    """The output layer's PCA initialization against the reference's
    sklearn PCA at a shape where sklearn picks its exact ('full')
    solver: components within 1e-9 (unit vectors whose signs follow
    svd_flip), means within 1e-14; and through the trainers (no epochs:
    the PCA layer, folded), equal as well."""
    from sklearn.decomposition import PCA
    x, specs = _training_set()
    targets = (specs - specs.mean(0)) / specs.std(0)
    rows = np.random.RandomState(0).permutation(len(targets))
    pca = PCA(n_components=8)
    pca.fit(targets[rows])
    assert pca._fit_svd_solver == 'full'
    w, b = train_nn.pca_init_pc_layer(torch.as_tensor(targets[rows]), 8)
    np.testing.assert_allclose(w.numpy(), pca.components_, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(b.numpy(), pca.mean_, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match='npc'):
        train_nn.pca_init_pc_layer(torch.as_tensor(targets[:5]), 8)

    kw = dict(SMALL, num_epochs=0, pca_init=True)
    rstate, _ = rtrain.train_interpolator(x, specs, **kw)
    model, hist = train_nn.train_interpolator(x, specs, device='cpu', **kw)
    assert hist['loss'] == []
    got, want = nn.state_to_dict(model), rnn.state_to_dict(rstate)
    np.testing.assert_allclose(got['pc_w'], want['pc_w'], rtol=0,
                               atol=1e-9 * np.abs(want['pc_w']).max())
    np.testing.assert_allclose(got['pc_b'], want['pc_b'], rtol=1e-13)


def test_plateau_halves_the_rate_and_stops_below_min_lr():
    """A rate too small to move the loss of one full batch: after
    patience + 1 flat epochs the rate halves, and training stops in the
    epoch whose rate falls under min_lr; the schedule equals the
    reference's."""
    x, specs = _training_set()
    kw = dict(SMALL, lr0=1e-12, min_lr=0.3e-12, plateau_patience=2,
              num_epochs=50, pca_init=False, batch_size=len(x))
    _, hist = train_nn.train_interpolator(x, specs, device='cpu', **kw)
    _, rhist = rtrain.train_interpolator(x, specs, **kw)
    assert hist['lr'] == [1e-12] * 3 + [0.5e-12] * 3 + [0.25e-12]
    assert hist['lr'] == rhist['lr']


def test_resume_trains_only_the_remaining_epochs(tmp_path):
    """Checkpoints every checkpoint_every epochs carry the epoch; a
    resumed run starts there, and the reference reads the checkpoint
    the port writes."""
    x, specs = _training_set()
    ck = str(tmp_path / 'ck.h5')
    kw = dict(SMALL, pca_init=False, checkpoint_path=ck, checkpoint_every=3)
    train_nn.train_interpolator(x, specs, num_epochs=7, device='cpu', **kw)
    saved = rserializer.load_dict_from_hdf5(ck)
    assert int(saved['epoch']) == 6
    rnn.state_from_dict(saved['state'])
    _, hist = train_nn.train_interpolator(x, specs, num_epochs=10,
                                          resume=True, device='cpu', **kw)
    assert len(hist['loss']) == 10 - 6


def test_no_card_and_mesh_raise(monkeypatch):
    """No fallback: without device='cpu' the trainer needs the card; the
    reference's SPMD mesh is not ported."""
    x, specs = _training_set()
    with pytest.raises(NotImplementedError, match='ROADMAP A4'):
        train_nn.train_interpolator(x, specs, mesh=object(), device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_nn.train_interpolator(x, specs, num_epochs=1)


def _write_specs(path, setup, npix=80):
    """A specs_{setup}.h5 as the reference's make_interpol writes it,
    with the reference's serializer."""
    lam, uvecs, idgrid, vecs, specs, parnames = rsim.make_template_grid(
        4, 3, 3, 2, npix=npix)
    vec = vecs.copy()
    vec[0] = 10**vec[0]
    rserializer.save_dict_to_hdf5(
        os.path.join(path, f'specs_{setup}.h5'),
        dict(vec=vec, specs=specs, lam=lam, parnames=list(parnames),
             log_ids=[0], lognorms=np.zeros(len(specs)), log_step=True,
             log_spec=True))
    return vec, specs


def test_main_writes_artifacts_the_reference_loads(tmp_path):
    """rvstorch_train_nn_interpolator --cpu on a specs file the
    reference wrote: the three artifacts under the reference's names;
    the reference's loader and the port's build the same spectra (rtol
    1e-12) from them; the predictions are the model's."""
    setup = 'nnt'
    vec, specs = _write_specs(str(tmp_path), setup)
    train_nn.main(['--setup', setup, '--dir', str(tmp_path), '--width',
                   '16', '--nlayers', '1', '--npc', '6', '--batch', '32',
                   '--num_epochs', '3', '--pca_init', '--cpu',
                   '--revision', 'r7'])
    for pat in ('nnstate_%s.h5', 'interp_%s.h5', 'pred_%s.h5'):
        assert (tmp_path / (pat % setup)).exists(), pat
    assert not (tmp_path / f'tmp_nnstate_{setup}.h5').exists()
    fd = rserializer.load_dict_from_hdf5(str(tmp_path / f'interp_{setup}.h5'))
    assert fd['interpolation_type'] == 'nn'
    assert fd['nn_file'] == f'nnstate_{setup}.h5'
    assert fd['nn_kwargs'] == dict(width=16, nlayers=1, npc=6)
    assert fd['cmdline'].startswith('rvstorch_train_nn_interpolator')

    cfg = dict(template_lib=str(tmp_path))
    want = rlib.load_template_model(setup, cfg, cache=False)
    got = library.load_template_model(setup, cfg, device='cpu')
    assert got.kind == want.kind == 'nn'
    assert got.parnames == want.parnames and got.extra['revision'] == 'r7'
    p = vec.T[::5]
    spec, out = got.eval_batch(torch.as_tensor(p))
    rspec, rout = want.eval_batch(jax.numpy.asarray(p))
    np.testing.assert_allclose(spec.numpy(), np.asarray(rspec), rtol=1e-12)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-12,
                               atol=1e-20)
    pred = rserializer.load_dict_from_hdf5(str(tmp_path / f'pred_{setup}.h5'))
    np.testing.assert_allclose(np.exp(pred['pred'][::5]), spec.numpy(),
                               rtol=1e-12)
    np.testing.assert_array_equal(pred['dats'], specs)
    assert pred['train_sel'].all()


def _payload():
    return dict(
        a=np.arange(6.0).reshape(2, 3), s='text', n=None, t=True,
        i=3, f=2.5, c=1 + 2j, g=np.float32(1.5), names=['x', 'yy'],
        nums=[1.0, 2.0], tup=(1, 2), mixed=[1, 'a', None, {'k': 1}],
        strs=np.array(['ab', 'c']), nested=dict(deep=dict(z=np.ones(2))),
        empty=[])


def test_serializer_round_trips_both_ways(tmp_path):
    """The port's writer and the reference's, each read by both
    loaders, give the same nested dict; an object without a node type
    is refused (no pickles)."""
    payload = _payload()
    for writer, name in ((serializer.save_dict_to_hdf5, 'port.h5'),
                         (rserializer.save_dict_to_hdf5, 'ref.h5')):
        path = str(tmp_path / name)
        writer(path, payload)
        for loader in (serializer.load_dict_from_hdf5,
                       rserializer.load_dict_from_hdf5):
            assert rserializer.verify_data(payload, loader(path)), \
                (name, loader)
    with pytest.raises(ValueError, match='cannot serialize'):
        serializer.save_dict_to_hdf5(str(tmp_path / 'bad.h5'),
                                     dict(x={1, 2}))
    assert sorted(os.listdir(str(tmp_path))) == ['port.h5', 'ref.h5']
