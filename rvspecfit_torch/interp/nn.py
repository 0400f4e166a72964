"""Neural-network template interpolator (inference and state).

The port's own copy of rvspecfit_tpu/interp/nn.py (itself the
reference's torch MLP interpolator).  Architecture:

    x -> standardize -> Linear(ndim, width) -> act
      -> [Linear(width, width) -> act (-> batch-norm affine)] * nlayers
      -> Linear(width, npc) -> act
      -> Linear(npc, npix)          # PCA-like bottleneck output layer
    spectrum = exp(clip(out, -300, 300))

The trainer folds the output standardization into the last layer and
the batch-norm statistics into a per-feature affine after the
activation, so inference is raw.  The outside-grid indicator is the
squared positive distance to the convex hull of the training
parameters' (p0, p1) and (p2, p3) projections, from facet equations
computed on the host (:func:`hull_equations`).

:class:`NNInterpolator` is an ``nn.Module`` whose weights do not
require gradients (the fit differentiates the spectra in the
parameters, not in the weights); it reads and writes the reference's
checkpoint payload (:func:`state_to_dict`, :func:`state_from_dict`:
same magic, versions and keys), so a library the JAX trainer wrote
loads here.  Clamps that are differentiated go through ops/clip.py,
whose gradients are ``jnp.clip``'s and ``jnp.maximum``'s.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rvspecfit_torch.device import dtype_for, resolve_device
from rvspecfit_torch.ops.clip import clip

ARCHITECTURE_VERSION = 1
CHECKPOINT_MAGIC = 'rvspecfit_tpu.nn_interpolator'
CHECKPOINT_VERSION = 1

# jax.nn.gelu's default is the tanh approximation
ACTIVATIONS = {'SiLU': F.silu,
               'GELU': lambda x: F.gelu(x, approximate='tanh'),
               'Tanh': torch.tanh, 'ReLU': F.relu}


def _linear(w, b, to):
    """nn.Linear computing x @ w + b for a (in, out) weight ``w``."""
    w = to(w)
    lin = torch.nn.utils.skip_init(torch.nn.Linear, w.shape[0], w.shape[1],
                                   device=w.device, dtype=w.dtype)
    with torch.no_grad():
        lin.weight.copy_(w.T)
        lin.bias.copy_(to(b))
    return lin


class NNInterpolator(torch.nn.Module):
    """The NN interpolator on one device.

    weights : per layer (w (in, out), b (out,)); bn : per layer None or
    (scale (out,), shift (out,)); pc_w (npc, npix), pc_b (npix,): the
    output layer; mean, std (ndim,): standardization of the mapped
    parameters; hull_eqs: two (nfacet, 3) facet-equation arrays.
    Arrays are host (numpy) or tensors; ``dtype`` None is the device's
    working dtype."""

    def __init__(self, weights, bn, pc_w, pc_b, mean, std, hull_eqs,
                 nonlinearity='SiLU', device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or dtype_for(device)

        def to(a):
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().double().numpy()
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)
        self.nonlinearity = str(nonlinearity)
        self.act = ACTIVATIONS[self.nonlinearity]
        self.layers = torch.nn.ModuleList(_linear(w, b, to)
                                          for w, b in weights)
        self.output = _linear(pc_w, pc_b, to)
        self.bn_layers = tuple(i for i, x in enumerate(bn) if x is not None)
        for i in self.bn_layers:
            self.register_buffer(f'bn_scale_{i}', to(bn[i][0]))
            self.register_buffer(f'bn_shift_{i}', to(bn[i][1]))
        self.register_buffer('mean', to(mean))
        self.register_buffer('std', to(std))
        self.register_buffer('hull_eq_0', to(hull_eqs[0]))
        self.register_buffer('hull_eq_1', to(hull_eqs[1]))
        self.requires_grad_(False)

    @property
    def npix(self):
        return self.output.out_features

    @property
    def ndim(self):
        return self.mean.shape[0]

    def forward(self, params_mapped):
        """(T, ndim) mapped params -> (T, npix) raw network output."""
        h = (params_mapped.to(self.mean.dtype) - self.mean) / self.std
        for i, lin in enumerate(self.layers):
            h = self.act(lin(h))
            if i in self.bn_layers:
                h = h * getattr(self, f'bn_scale_{i}') \
                    + getattr(self, f'bn_shift_{i}')
        return self.output(h)

    def hull_outside(self, p):
        """Squared positive hull-facet distance of the two 2-D
        projections of the (T, ndim) mapped params (0 inside both)."""
        p = p.to(self.mean.dtype)
        d = None
        for i, eqs in enumerate((self.hull_eq_0, self.hull_eq_1)):
            sub = p[:, 2 * i:2 * i + 2]
            di = torch.amax(sub @ eqs[:, :2].T + eqs[:, 2][None, :], dim=1)
            d = di if d is None else torch.maximum(d, di)
        return clip(d, 0.0)**2

    def interp_batch(self, params_mapped):
        """TemplateModel interpolation protocol: ((T, npix) spectra,
        (T,) outside-hull distance)."""
        out = self(params_mapped)
        return torch.exp(clip(out, -300.0, 300.0)), \
            self.hull_outside(params_mapped)


def hull_equations(vecs_mapped):
    """Host: convex-hull facet equations of the (0, 1) and (2, 3)
    projections of the (nspec, ndim) mapped training parameters."""
    import scipy.spatial
    vecs = np.asarray(vecs_mapped, np.float64)
    return [scipy.spatial.ConvexHull(vecs[:, 2 * i:2 * i + 2]).equations
            for i in range(2)]


def init_state(generator, ndim, width, nlayers, npc, npix, mean=None,
               std=None, hull_eqs=None, withbn=False, nonlinearity='SiLU',
               device=None, dtype=None):
    """Random initialization from the ``torch.Generator`` (a CPU
    generator; the weights are drawn in float64 on the CPU): LeCun-normal
    weights, zero biases, unit batch-norm affines on the middle layers
    with ``withbn``; no hull equations count everything as inside."""
    draw = lambda *shape: torch.randn(shape, generator=generator,
                                      dtype=torch.float64)
    shapes = [(ndim, width)] + [(width, width)] * nlayers + [(width, npc)]
    weights, bn = [], []
    for i, (nin, nout) in enumerate(shapes):
        weights.append((draw(nin, nout) / np.sqrt(nin), np.zeros(nout)))
        middle = 0 < i < len(shapes) - 1
        bn.append((np.ones(nout), np.zeros(nout)) if withbn and middle
                  else None)
    pc_w = draw(npc, npix) / np.sqrt(npc)
    if hull_eqs is None:
        hull_eqs = [np.array([[0.0, 0.0, -1.0]])] * 2
    return NNInterpolator(
        weights, bn, pc_w, np.zeros(npix),
        np.zeros(ndim) if mean is None else mean,
        np.ones(ndim) if std is None else std, hull_eqs,
        nonlinearity=nonlinearity, device=device, dtype=dtype)


def state_to_dict(model):
    """The reference's versioned, pickle-free checkpoint payload."""
    host = lambda t: t.detach().cpu().numpy()
    d = dict(checkpoint_magic=CHECKPOINT_MAGIC,
             checkpoint_version=CHECKPOINT_VERSION,
             nn_arch_version=ARCHITECTURE_VERSION,
             nonlinearity=model.nonlinearity,
             nlayers=len(model.layers) - 2,
             pc_w=host(model.output.weight.T), pc_b=host(model.output.bias),
             mean=host(model.mean), std=host(model.std),
             hull_eq_0=host(model.hull_eq_0),
             hull_eq_1=host(model.hull_eq_1))
    for i, lin in enumerate(model.layers):
        d[f'w_{i}'] = host(lin.weight.T)
        d[f'b_{i}'] = host(lin.bias)
        if i in model.bn_layers:
            d[f'bn_scale_{i}'] = host(getattr(model, f'bn_scale_{i}'))
            d[f'bn_shift_{i}'] = host(getattr(model, f'bn_shift_{i}'))
    return d


def state_from_dict(d, device=None, dtype=None):
    """:class:`NNInterpolator` from a checkpoint payload (the
    reference's keys), on ``device`` (None: the CUDA card)."""
    if d.get('checkpoint_magic') != CHECKPOINT_MAGIC:
        raise RuntimeError('Invalid NN checkpoint magic')
    if d.get('checkpoint_version') != CHECKPOINT_VERSION:
        raise RuntimeError('Unsupported NN checkpoint version')
    if d.get('nn_arch_version') != ARCHITECTURE_VERSION:
        raise RuntimeError('NN architecture version mismatch')
    weights, bn = [], []
    i = 0
    while f'w_{i}' in d:
        weights.append((d[f'w_{i}'], d[f'b_{i}']))
        bn.append((d[f'bn_scale_{i}'], d[f'bn_shift_{i}'])
                  if f'bn_scale_{i}' in d else None)
        i += 1
    return NNInterpolator(weights, bn, d['pc_w'], d['pc_b'], d['mean'],
                          d['std'], (d['hull_eq_0'], d['hull_eq_1']),
                          nonlinearity=str(d['nonlinearity']),
                          device=device, dtype=dtype)
