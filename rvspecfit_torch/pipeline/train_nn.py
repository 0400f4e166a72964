"""NN template-interpolator training on torch.optim.

Counterpart of rvspecfit_tpu/pipeline/train_nn.py, with the same
data order, loss, schedule, checkpoints and artifacts:

* inputs: mapped template parameters (standardized inside the
  network) and log-spectra standardized per pixel; the loss is the L1
  distance over the global spread of the standardized targets;
* Adam (``torch.optim.Adam``, the reference's optax.adam defaults)
  with a reduce-on-plateau schedule kept on the host (factor 0.5 after
  ``plateau_patience`` + 1 flat epochs), stopping once the rate falls
  under ``min_lr`` or at the epoch limit;
* the validation split and every epoch's shuffle come from one
  ``np.random.RandomState(seed)`` in the reference's order, so one
  seed gives the same batches on both sides; the last partial batch is
  dropped;
* the initial weights come from interp/nn.init_state with a
  ``torch.Generator`` seeded with ``seed``; the optional PCA
  initialization of the output layer is computed here with
  ``torch.linalg.svd`` (sklearn's exact solver and sign convention);
* checkpoints every ``checkpoint_every`` epochs; ``resume`` restores
  the weights only (not Adam's moments, not the rate), as the
  reference does;
* the target standardization is folded into the output layer at the
  end, so the returned model's output is the raw log-spectrum.

Everything runs on one device (None: the CUDA card) in its working
dtype; the epoch's loss is summed there and read once per epoch, for
the plateau test.  ``mesh=`` (a parallel/mesh.make_grid grid with
``('data', 'model')`` axes) trains the reference's tensor-parallel
layout instead (:class:`ShardedMLP`): the batch split over
``data``, the hidden widths over ``model``, one autograd graph across
the grid's devices driven from the calling thread.  Reading
``specs_{setup}.h5`` and writing the artifacts (:func:`execute`,
:func:`main`) needs ``h5py``; without it :func:`train_interpolator`
trains in memory.
"""
from __future__ import annotations

import argparse
import logging
import os
import shlex
import sys

import numpy as np
import scipy.spatial
import torch
import torch.nn.functional as F

from rvspecfit_torch import __version__ as git_rev
from rvspecfit_torch import serializer
from rvspecfit_torch.device import dtype_for, resolve_device
from rvspecfit_torch.interp import nn as nn_mod
from rvspecfit_torch.interp.mapper import LogMapper
from rvspecfit_torch.pipeline.library import NN_STATE_NAME
from rvspecfit_torch.pipeline.make_interpol import SPECS_H5_NAME
from rvspecfit_torch.pipeline.make_nd import INTERPOL_H5_NAME

NN_TMP_STATE_NAME = 'tmp_nnstate_%s.h5'
NN_PRED_NAME = 'pred_%s.h5'
PRED_CHUNK = 4096


def pca_init_pc_layer(targets_std, npc):
    """PCA of the (nspec, npix) standardized targets (a tensor):
    (components (npc, npix), mean (npix,)) on the targets' device,
    sklearn's ``PCA(svd_solver='full')`` result: the exact SVD of the
    centred data, each component's sign set so that its largest
    absolute entry is positive (``svd_flip(u_based_decision=False)``,
    sklearn >= 1.5)."""
    nspec, npix = targets_std.shape
    if not 0 <= npc <= min(nspec, npix):
        raise ValueError(f'npc={npc} must be between 0 and '
                         f'min(nspec, npix)={min(nspec, npix)}')
    mean = targets_std.mean(0)
    vt = torch.linalg.svd(targets_std - mean, full_matrices=False)[2]
    rows = torch.arange(vt.shape[0], device=vt.device)
    signs = torch.sign(vt[rows, vt.abs().argmax(1)])
    return (vt * signs[:, None])[:npc], mean


class ShardedMLP:
    """The trainable weights of NNInterpolator ``model`` laid over a
    (data, model) ``grid`` (parallel/mesh.make_grid) as the reference's
    shard_training lays them over a jax Mesh
    (rvspecfit_tpu/pipeline/train_nn.py:72-102):

    * every hidden layer (``ndim -> width``, then ``width -> width``)
      column-sharded, its output features split over ``model`` into M
      contiguous blocks, with its bias and batch-norm affine;
    * the bottleneck (``width -> npc``) row-sharded, its input features
      split the same way, its bias replicated;
    * the output layer replicated; the standardization and the hull
      are not trained.

    The trained tensors (``parameters``) are one copy per shard: model
    shard m's on the device of grid row 0 and column m, the replicated
    ones on that of row 0, column 0.  :meth:`loss` copies them to the
    other rows with differentiable ``.to()``, so one backward sums each
    copy's gradients over the data parts and one optimizer step over
    ``parameters`` is the unsharded step up to rounding."""

    def __init__(self, model, grid, data_axis='data', model_axis='model'):
        self.devices = grid.layout(data_axis, model_axis)
        self.shape = (len(self.devices), len(self.devices[0]))
        nmod = self.shape[1]
        width = model.layers[0].out_features
        if width % nmod:
            raise ValueError(f'width {width} does not split over the '
                             f'{nmod} devices of the {model_axis!r} axis')
        self.model = model
        self.mean, self.std = model.mean, model.std
        self.act = model.act
        blk = width // nmod
        home = self.devices[0]

        def split(t, dim):
            return [torch.nn.Parameter(x.detach().to(home[m]).clone())
                    for m, x in enumerate(t.split(blk, dim))]
        # per column-sharded layer: (weight shards, bias shards, batch-norm
        # scale shards or None, shift shards or None)
        self.hidden = []
        for i, lin in enumerate(model.layers[:-1]):
            bn = [split(getattr(model, f'bn_{part}_{i}'), 0)
                  for part in ('scale', 'shift')] \
                if i in model.bn_layers else [None, None]
            self.hidden.append((split(lin.weight, 0), split(lin.bias, 0),
                                *bn))
        last = model.layers[-1]
        self.bottleneck = split(last.weight, 1)
        keep = lambda t: torch.nn.Parameter(  # noqa: E731
            t.detach().to(home[0]).clone())
        self.replicated = [keep(last.bias), keep(model.output.weight),
                           keep(model.output.bias)]

    def parameters(self):
        for w, b, sc, sh in self.hidden:
            yield from w
            yield from b
            yield from sc or ()
            yield from sh or ()
        yield from self.bottleneck
        yield from self.replicated

    def _part(self, x, y, row):
        """The L1 mean of one data part (x standardized) on its row."""
        devs = self.devices[row]
        ins = [x.to(dev) for dev in devs]
        outs = None
        for i, (w, b, sc, sh) in enumerate(self.hidden):
            outs = []
            for m, dev in enumerate(devs):
                h = self.act(F.linear(ins[m], w[m].to(dev), b[m].to(dev)))
                if sc is not None:
                    h = h * sc[m].to(dev) + sh[m].to(dev)
                outs.append(h)
            if i + 1 < len(self.hidden):
                # all-gather the next layer's input over the model axis
                ins = [torch.cat([h.to(dev) for h in outs], 1)
                       for dev in devs]
        # the bottleneck's partial products summed over the model axis
        z = sum(F.linear(h, w.to(dev)).to(devs[0])
                for h, w, dev in zip(outs, self.bottleneck, devs))
        bias, pc_w, pc_b = (t.to(devs[0]) for t in self.replicated)
        out = F.linear(self.act(z + bias), pc_w, pc_b)
        return torch.mean(torch.abs(out - y.to(devs[0])))

    def loss(self, x, y, spread0):
        """The batch's loss on the device of row 0, column 0: the mean of
        the D contiguous data parts' L1 means over ``spread0``."""
        ndata = self.shape[0]
        if x.shape[0] % ndata:
            raise ValueError(f'a batch of {x.shape[0]} does not split over '
                             f'the {ndata} devices of the data axis')
        x = (x.to(self.mean.dtype) - self.mean) / self.std
        home = self.devices[0][0]
        parts = [self._part(xp, yp, d).to(home) for d, (xp, yp) in
                 enumerate(zip(x.chunk(ndata), y.chunk(ndata)))]
        return sum(parts) / (ndata * spread0)

    def gather(self):
        """Write the shards into the unsharded model (on its device);
        returns the model."""
        model = self.model
        dev = model.mean.device
        cat = lambda ts, dim: torch.cat(  # noqa: E731
            [t.detach().to(dev) for t in ts], dim)
        with torch.no_grad():
            for i, (w, b, sc, sh) in enumerate(self.hidden):
                model.layers[i].weight.copy_(cat(w, 0))
                model.layers[i].bias.copy_(cat(b, 0))
                if sc is not None:
                    getattr(model, f'bn_scale_{i}').copy_(cat(sc, 0))
                    getattr(model, f'bn_shift_{i}').copy_(cat(sh, 0))
            model.layers[-1].weight.copy_(cat(self.bottleneck, 1))
            for dst, src in zip((model.layers[-1].bias, model.output.weight,
                                 model.output.bias), self.replicated):
                dst.copy_(src.detach().to(dev))
        return model


def fold_output_standardization(model, t_mean, t_std):
    """Fold the target standardization y_raw = y t_std + t_mean into
    the output layer of ``model`` (in place), so that its output is the
    raw log-spectrum; returns the model."""
    out = model.output
    to = lambda a: torch.as_tensor(a, dtype=out.weight.dtype,
                                   device=out.weight.device)
    with torch.no_grad():
        out.weight.mul_(to(t_std)[:, None])
        out.bias.mul_(to(t_std)).add_(to(t_mean))
    return model


def train_interpolator(vecs_mapped, log_specs, width=256, nlayers=3,
                       npc=50, lr0=1e-2, min_lr=1e-5, plateau_patience=20,
                       plateau_factor=0.5, num_epochs=600, batch_size=512,
                       pca_init=True, withbn=False, seed=0,
                       checkpoint_path=None, checkpoint_every=32,
                       resume=False, mesh=None, validation_frac=0.0,
                       log_every=50, device=None, dtype=None):
    """Train an NN interpolator on a prepared template set.

    vecs_mapped : (nspec, ndim) mapped (log10 teff) parameters;
    log_specs : (nspec, npix) log template spectra; device : None (the
    CUDA card) or a torch device; dtype : None (the device's working
    dtype) or a torch dtype; mesh : None, or a (data, model) grid
    (parallel/mesh.make_grid) to train on as :class:`ShardedMLP` lays
    it out: ``width`` must split evenly over the ``model`` axis
    and ``min(batch_size, ntrain)`` over the ``data`` axis (else
    ValueError).  The PCA initialization and ``resume`` act on the
    unsharded model before it is laid out; checkpoints hold the
    gathered weights.

    Returns (interp/nn.NNInterpolator on ``device`` with the output
    standardization folded in and no gradients, history dict: loss
    and lr per epoch, t_mean, t_std, spread0).
    """
    device = resolve_device(device)
    dtype = dtype or dtype_for(device)
    vecs_mapped = np.asarray(vecs_mapped, np.float64)
    log_specs = np.asarray(log_specs, np.float64)
    nspec, ndim = vecs_mapped.shape
    npix = log_specs.shape[1]

    p_mean = vecs_mapped.mean(axis=0)
    p_std = vecs_mapped.std(axis=0)
    p_std[p_std == 0] = 1.0
    t_mean = log_specs.mean(axis=0)
    t_std = log_specs.std(axis=0)
    t_std[t_std == 0] = 1.0
    targets = (log_specs - t_mean) / t_std
    spread0 = float(targets.std())
    if spread0 == 0:
        spread0 = 1.0

    rng = np.random.RandomState(seed)
    nval = int(nspec * validation_frac)
    perm = rng.permutation(nspec)
    tr_idx = perm[nval:]

    hull_eqs = None
    if ndim >= 4:
        try:
            hull_eqs = nn_mod.hull_equations(vecs_mapped)
        except scipy.spatial.QhullError as exc:
            logging.warning('hull construction failed: %s', exc)

    model = nn_mod.init_state(torch.Generator().manual_seed(seed), ndim,
                              width, nlayers, npc, npix, mean=p_mean,
                              std=p_std, hull_eqs=hull_eqs, withbn=withbn,
                              device=device, dtype=dtype)
    xs = torch.as_tensor(vecs_mapped, dtype=dtype, device=device)
    ys = torch.as_tensor(targets, dtype=dtype, device=device)
    del targets
    tr_t = torch.as_tensor(tr_idx, device=device)
    if pca_init:
        pc_w, pc_b = pca_init_pc_layer(ys[tr_t], npc)
        with torch.no_grad():
            model.output.weight.copy_(pc_w.T)
            model.output.bias.copy_(pc_b)

    start_epoch = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        ck = serializer.load_dict_from_hdf5(checkpoint_path)
        ck_model = nn_mod.state_from_dict(ck['state'], device=device,
                                          dtype=dtype)
        # the trained weights only: the standardization and the hull
        # stay this training set's, as in the reference
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(ck_model.get_parameter(name))
        start_epoch = int(ck['epoch'])
        logging.info('resumed NN training at epoch %d', start_epoch)

    history = dict(loss=[], lr=[])
    ntr = len(tr_idx)
    bs = min(batch_size, ntr)
    if mesh is None:
        model.requires_grad_(True)
        params = model.parameters()
        loss_fn = lambda x, y: torch.mean(  # noqa: E731
            torch.abs(model(x) - y)) / spread0
    else:
        sharded = ShardedMLP(model, mesh)
        if bs % sharded.shape[0]:
            raise ValueError(f'a batch of {bs} does not split over the '
                             f'{sharded.shape[0]} devices of the data axis')
        params = sharded.parameters()
        loss_fn = lambda x, y: sharded.loss(x, y, spread0)  # noqa: E731
    optimizer = torch.optim.Adam(params, lr=lr0)
    # host-side reduce-on-plateau, as the reference's
    cur_lr = lr0
    best_loss = np.inf
    plateau_count = 0
    for epoch in range(start_epoch, num_epochs):
        order = tr_t[torch.as_tensor(rng.permutation(ntr), device=device)]
        for group in optimizer.param_groups:
            group['lr'] = cur_lr
        ep_loss = torch.zeros((), dtype=dtype, device=device)
        nb = 0
        for i in range(0, max(ntr - bs + 1, 1), bs):
            sel = order[i:i + bs]
            loss = loss_fn(xs[sel], ys[sel])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            ep_loss = ep_loss + loss.detach().to(device)
            nb += 1
        ep_loss = float(ep_loss) / max(nb, 1)
        if ep_loss < best_loss * (1 - 1e-4):
            best_loss = ep_loss
            plateau_count = 0
        else:
            plateau_count += 1
            if plateau_count > plateau_patience:
                cur_lr *= plateau_factor
                plateau_count = 0
        history['loss'].append(ep_loss)
        history['lr'].append(cur_lr)
        if epoch % log_every == 0:
            logging.info('epoch %d loss %.5f lr %.2e', epoch, ep_loss,
                         cur_lr)
        if checkpoint_path and (epoch + 1) % checkpoint_every == 0:
            if mesh is not None:
                sharded.gather()
            serializer.save_dict_to_hdf5(
                checkpoint_path,
                dict(state=nn_mod.state_to_dict(model), epoch=epoch + 1))
        if cur_lr < min_lr:
            logging.info('stopping: lr below min_lr at epoch %d', epoch)
            break

    if mesh is not None:
        sharded.gather()
    model.requires_grad_(False)
    fold_output_standardization(model, t_mean, t_std)
    history['t_mean'] = t_mean
    history['t_std'] = t_std
    history['spread0'] = spread0
    return model, history


def library_descriptor(lam, parnames, log_step, log_spec, log_ids,
                       lognorms, width, nlayers, npc, nn_file=None,
                       revision='', cmdline=''):
    """The ``interp_{setup}.h5`` dict of an NN library, as the
    reference's trainer writes it; with pipeline/library's
    template_model_from_artifacts and a checkpoint payload
    (interp/nn.state_to_dict) it makes the library's TemplateModel."""
    return dict(
        interpolation_type='nn', parnames=list(parnames),
        lam=np.asarray(lam), log_step=bool(log_step),
        log_spec=bool(log_spec), mapper_class='LogMapper',
        log_ids=list(log_ids), lognorms=np.asarray(lognorms),
        nn_file=nn_file, nn_kwargs=dict(width=width, nlayers=nlayers,
                                        npc=npc),
        revision=revision, git_rev=git_rev, cmdline=cmdline)


def execute(setup, directory='./', width=256, nlayers=2, npc=64,
            lr0=1e-3, min_lr=1e-8, batch_size=100, num_epochs=600,
            patience=20, pca_init=False, resume=False, revision='',
            validation_frac=0.0, n_subset_data=None, mask_ids=None,
            cmdline='', seed=22, mesh=None, device=None):
    """Train the NN interpolator for one setup on ``device`` (None: the
    CUDA card) and write the library artifacts that
    pipeline/library.load_template_model reads, under the reference's
    names and keys:

    * ``nnstate_{setup}.h5`` — the versioned NN checkpoint;
    * ``interp_{setup}.h5``  — the descriptor (lam, parnames,
      interpolation_type='nn', nn_file pointer);
    * ``pred_{setup}.h5``    — the trained model's predictions for QA.

    Returns (model, history)."""
    d = serializer.load_dict_from_hdf5(
        os.path.join(directory, SPECS_H5_NAME % setup))
    vec = np.asarray(d['vec'], np.float64)           # (ndim, nspec)
    specs = np.asarray(d['specs'])                   # (nspec, npix)
    log_ids = tuple(int(x) for x in d.get('log_ids', (0,)))
    vec_mapped = LogMapper(log_ids).forward(vec.T)   # (nspec, ndim)
    if not np.isfinite(vec_mapped).all():
        raise RuntimeError('Mapped parameters are not finite')

    train_sel = np.ones(len(specs), dtype=bool)
    if mask_ids:
        train_sel[list(mask_ids)] = False
    if n_subset_data is not None:
        rng = np.random.RandomState(44)
        ids = np.nonzero(train_sel)[0]
        train_sel[:] = False
        train_sel[rng.permutation(ids)[:n_subset_data]] = True
    logging.info('training NN for setup %s on %d/%d templates',
                 setup, train_sel.sum(), len(specs))

    ck_path = os.path.join(directory, NN_TMP_STATE_NAME % setup)
    model, history = train_interpolator(
        vec_mapped[train_sel], specs[train_sel], width=width,
        nlayers=nlayers, npc=npc, lr0=lr0, min_lr=min_lr,
        plateau_patience=patience, num_epochs=num_epochs,
        batch_size=batch_size, pca_init=pca_init, seed=seed,
        checkpoint_path=ck_path, resume=resume, mesh=mesh,
        validation_frac=validation_frac, device=device)

    nn_file = NN_STATE_NAME % setup
    serializer.save_dict_to_hdf5(
        os.path.join(directory, nn_file),
        dict(state=nn_mod.state_to_dict(model), git_rev=git_rev,
             revision=revision, cmdline=cmdline))
    if os.path.exists(ck_path):
        os.unlink(ck_path)
    serializer.save_dict_to_hdf5(
        os.path.join(directory, INTERPOL_H5_NAME % setup),
        library_descriptor(d['lam'], [str(p) for p in d['parnames']],
                           d['log_step'], d.get('log_spec', True), log_ids,
                           d['lognorms'], width, nlayers, npc,
                           nn_file=nn_file, revision=revision,
                           cmdline=cmdline))

    xs = torch.as_tensor(vec_mapped, dtype=model.mean.dtype,
                         device=model.mean.device)
    with torch.no_grad():
        pred = np.concatenate([model(xs[i:i + PRED_CHUNK]).cpu().numpy()
                               for i in range(0, len(xs), PRED_CHUNK)])
    serializer.save_dict_to_hdf5(
        os.path.join(directory, NN_PRED_NAME % setup),
        dict(pred=pred, vecs=vec_mapped, dats=specs, vecs_orig=vec.T,
             train_sel=train_sel, final_loss=history['loss'][-1],
             cmdline=cmdline))
    logging.info('wrote NN interpolator artifacts for setup %s '
                 '(final loss %.5f)', setup, history['loss'][-1])
    return model, history


def _parse_ids(s):
    if s is None or s == '':
        return None
    return [int(x) for x in s.split(',')]


def main(args=None):
    """Console entry point ``rvstorch_train_nn_interpolator``: trains
    on the CUDA card (raising without one), or on the CPU with
    ``--cpu``."""
    if args is None:
        args = sys.argv[1:]
    cmdline = shlex.join(['rvstorch_train_nn_interpolator'] + list(args))
    parser = argparse.ArgumentParser(
        description='Train the NN template interpolator for one setup')
    parser.add_argument('--setup', type=str, required=True)
    parser.add_argument('--dir', type=str, default='./',
                        help='Directory with specs_{setup}.h5; artifacts '
                        'are written next to it')
    parser.add_argument('--width', type=int, default=256)
    parser.add_argument('--nlayers', type=int, default=2)
    parser.add_argument('--npc', type=int, default=64)
    parser.add_argument('--learning_rate0', type=float, default=1e-3)
    parser.add_argument('--min_learning_rate', type=float, default=1e-8)
    parser.add_argument('--batch', type=int, default=100)
    parser.add_argument('--num_epochs', type=int, default=600)
    parser.add_argument('--patience', type=int, default=20)
    parser.add_argument('--pca_init', action='store_true', default=False)
    parser.add_argument('--resume', action='store_true', default=False)
    parser.add_argument('--cpu', action='store_true', default=False,
                        help='Train on the CPU instead of the CUDA card')
    parser.add_argument('--validation_fraction', type=float, default=0.0)
    parser.add_argument('--n_subset_data', type=int, default=None)
    parser.add_argument('--mask_ids', type=str, default=None,
                        help='Comma-separated template indices to exclude')
    parser.add_argument('--revision', type=str, default='')
    args = parser.parse_args(args)
    logging.basicConfig(level=logging.INFO)
    execute(args.setup, directory=args.dir, width=args.width,
            nlayers=args.nlayers, npc=args.npc, lr0=args.learning_rate0,
            min_lr=args.min_learning_rate, batch_size=args.batch,
            num_epochs=args.num_epochs, patience=args.patience,
            pca_init=args.pca_init, resume=args.resume,
            revision=args.revision,
            validation_frac=args.validation_fraction,
            n_subset_data=args.n_subset_data,
            mask_ids=_parse_ids(args.mask_ids), cmdline=cmdline,
            device='cpu' if args.cpu else None)


if __name__ == '__main__':
    main()
