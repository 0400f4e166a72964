"""FLOP accounting and model-FLOP utilization of the Nelder-Mead phase.

Counterpart of rvspecfit_tpu/perf.py.  The NM phase's device work is
(objective trials) x (FLOPs per fiber-trial).  ``run_neldermead``
returns ``obj_evals``, the fiber-trials it dispatched; this module
prices one trial and turns the product into an achieved FLOP/s figure
and, where the card's peak is known, a utilization.

A trial is priced by running one objective call under
``torch.utils.flop_counter.FlopCounterMode`` and adding kernel A's
arithmetic, which the counter cannot see (a ctypes launch on the card;
on the CPU its plain version is elementwise and gathers, which the
counter does not count either).  Caveat, printed with the estimate:
the counter prices matrix products and convolutions only, so the
elementwise work, the 10x10 Cholesky solves and the gathers are left
out and the utilization is a lower bound.

The peaks are NVIDIA's published data-sheet figures for the H100 SXM
(dense, without sparsity, at the card's full 700 W): a card set to a
lower power limit runs slower under load.
"""
from __future__ import annotations

import logging
import os

import numpy as np

# dense TFLOP/s of one card by name substring (NVIDIA H100 SXM data
# sheet): FP64 on the tensor cores, FP64 outside them, FP32
PEAK_TFLOPS = (
    ('h100', dict(fp64_tensor=67.0, fp64=34.0, fp32=67.0)),
)
# kernel A's arithmetic per evaluated point, counted from its plain
# version (ops/spline_eval.spline_eval_index_plain): the interval split,
# the offsets (with exp/expm1 on a log grid) and the four-term cubic
SPLINE_POINT_FLOPS = dict(log=21, linear=16)


def device_peak_tflops(device=None, unit='fp64_tensor'):
    """The peak of ``device`` (a CUDA torch.device, its name, or None
    for the current card) in ``unit`` (fp64_tensor, fp64 or fp32).

    ``RVST_PEAK_TFLOPS`` overrides.  Returns (tflops, label), or (None,
    name) for a card that is not in the table (or for the CPU)."""
    env = os.environ.get('RVST_PEAK_TFLOPS')
    if env:
        return float(env), 'RVST_PEAK_TFLOPS'
    if isinstance(device, str) and not device.startswith(('cuda', 'cpu')):
        name = device
    else:
        import torch
        device = torch.device('cuda' if device is None else device)
        if device.type != 'cuda':
            return None, device.type
        name = torch.cuda.get_device_name(device)
    for sub, peaks in PEAK_TFLOPS:
        if sub in name.lower():
            return peaks[unit], f'{name} {unit} (data sheet)'
    return None, name


def objective_flops_per_trial(bf, mapper, width=None, ncand=4,
                              priors=None):
    """FLOPs of ONE fiber-trial of the NM objective of the fitter
    ``bf``: one call at ``width`` fibers (default the tile width, else
    every fiber) x ``ncand`` trial points at the mapper's start vector,
    counted by FlopCounterMode, plus kernel A's analytic count, divided
    by width x ncand."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    w = int(width or (bf.microbatch or bf.nfibers))
    idx = torch.arange(w, device=bf.device) % bf.nfibers
    obj = bf._objective(mapper, priors, idx)
    x = torch.as_tensor(np.tile(mapper.start_vector(0.0), (w, ncand, 1)),
                        dtype=bf.dtype, device=bf.device)
    with FlopCounterMode(display=False) as counter:
        obj(x)
    counted = float(counter.get_total_flops())
    spline = sum(
        a.npix * SPLINE_POINT_FLOPS['log' if bf.templates[a.setup].geom
                                    .log_step else 'linear']
        for a in bf.arms) * w * ncand
    if counted <= 0:
        logging.warning('FlopCounterMode counted no FLOPs in the NM '
                        'objective')
    return (counted + spline) / (w * ncand)


def mfu_report(nm_flops, nm_seconds, device=None, unit='fp64_tensor'):
    """One line: the NM phase's counted FLOPs, its achieved FLOP/s and
    its share of the card's peak in ``unit``."""
    achieved = nm_flops / max(nm_seconds, 1e-9)
    peak, label = device_peak_tflops(device, unit)
    msg = (f'NM phase: {nm_flops / 1e12:.4f} TFLOP (counted: matmuls, '
           f'convolutions and kernel A; a lower bound) in '
           f'{nm_seconds:.2f} s = {achieved / 1e12:.4f} TFLOP/s')
    if peak:
        msg += (f' = {100.0 * achieved / (peak * 1e12):.2f}% of '
                f'{peak:.0f} TFLOP/s ({label})')
    else:
        msg += f' (no peak known for {label!r})'
    return msg
