"""The program's side of set-up: the benchmark's template grids handed
to rvspecfit_torch as TemplateModels (through its public GridInterpState
and SplineGeometry, so that the grid stays on the card and is never
copied through the host) and the CCF banks built by its
pipeline/make_ccf.build_bank and convert.ccf_bank, as the upstream
make_ccf builds them from a library."""
import itertools
import time

import numpy as np
import torch

from benchlib import generator, reference


def template_models(ctx, cfg, dtype=torch.float64):
    """({setup: TemplateModel}, {setup: reference.Grid}, {setup: (lam,
    logspec)}) of every template setup of ``cfg`` on ctx.device; the
    reference's grids read the same float64 tensors."""
    from rvspecfit_torch.interp.api import TemplateModel
    from rvspecfit_torch.interp.grid import GridInterpState
    from rvspecfit_torch.ops.spline import SplineGeometry
    dev = ctx.device
    nodes = generator.grid_nodes(cfg)
    lens = tuple(len(u) for u in nodes)
    mapped = [np.log10(nodes[0])] + nodes[1:]
    vecs = np.array([m.ravel() for m in np.meshgrid(*mapped,
                                                      indexing='ij')])
    ptp = np.ptp(vecs, axis=1)
    to = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=dev)
    models, grids, raw = {}, {}, {}
    for setup in cfg['templates']['setups']:
        lam, logspec = generator.template_grid(cfg, setup, dev)
        raw[setup] = (lam, logspec)
        grids[setup] = reference.Grid(lam, logspec, nodes)
        state = GridInterpState(
            uvecs=tuple(to(u) for u in mapped),
            idgrid=torch.arange(int(np.prod(lens)), device=dev),
            vecs_scaled=to((vecs / ptp[:, None]).T), ptp_inv=to(1.0 / ptp),
            dats=logspec if dtype == torch.float64 else logspec.to(dtype),
            lens=lens, log_spec=True,
            strides=torch.tensor([int(np.prod(lens[i + 1:]))
                                  for i in range(4)], device=dev),
            corners=torch.tensor(list(itertools.product((False, True),
                                                        repeat=4)),
                                 device=dev))
        geom = SplineGeometry.from_knots(lam, log_step=True, device=dev,
                                         dtype=dtype)
        models[setup] = TemplateModel(state=state, geom=geom,
                                      parnames=generator.PARNAMES,
                                      log_ids=(0,), kind='grid')
    return models, grids, raw


def ccf_banks(ctx, cfg, raw, dtype=torch.float64):
    """{setup: bank} on ctx.device: every ``ccf.every``-th template in
    Morton order, at each of ``ccf.vsinis``, through make_ccf.build_bank
    over the setup's CCF range at its step.  build_bank's own selection
    (make_ccf.get_mortoncurve_id) picks the templates first, so that only
    those are copied to the host and exponentiated."""
    from rvspecfit_torch import convert
    from rvspecfit_torch.pipeline import make_ccf
    nodes = generator.grid_nodes(cfg)
    vec = np.array([m.ravel() for m in np.meshgrid(*nodes, indexing='ij')])
    ccf = cfg['ccf']
    every = int(ccf['every'])
    inds = np.argsort(make_ccf.get_mortoncurve_id(vec.T))[::every]
    banks = {}
    for setup, st in cfg['templates']['setups'].items():
        lam, logspec = raw[setup]
        npoints = make_ccf.to_power_two(
            int((st['lam1'] - st['lam0']) / cfg['templates']['step']))
        ccfconf = make_ccf.get_ccf_config(
            logl0=np.log(st['lam0']), logl1=np.log(st['lam1']),
            npoints=npoints, splinestep=1000)
        sel = torch.as_tensor(inds, device=logspec.device)
        specs = torch.exp(logspec[sel]).cpu().numpy()
        _, ffts, fft2s, info = make_ccf.build_bank(
            dict(vec=vec[:, inds], specs=specs, lam=lam,
                 parnames=list(generator.PARNAMES), log_spec=False),
            ccfconf, every=1, vsinis=ccf.get('vsinis'), device=ctx.device)
        banks[setup] = convert.ccf_bank(ffts, fft2s, info, device=ctx.device,
                                        dtype=dtype)
    return banks


def kernel_b_calls(ctx):
    """A span recorder for ops/ccf_chisq.ccf_chisq (kernel B's entry)
    that keeps each call's B, T, F, V and form while the run traces."""
    def record(args, kwargs, out):
        if ctx.tracing:
            ctx.kernel_calls.append((time.time(), 'kernel_b', dict(
                nb=args[2].shape[0], nt=args[0].shape[0],
                nf=args[0].shape[1], nv=args[4].shape[1],
                form='float64' if args[0].dtype == torch.complex128
                else 'float32')))
        return {}
    return record
