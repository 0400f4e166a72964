#!/usr/bin/env python3
"""Time the fitter sharded over the host's cards against one card.

Usage (from the root of a checkout, on a machine with CUDA cards):

    python3 tools/torch_mesh_cards.py [--fibers 1000] [--repeats 2]

Fits one exposure of ``--fibers`` fibers (simulation.make_exposure,
seed 7, S/N 50, chip_smoke.py's 3 arms, 864-template model and CCF bank,
float64) through survey/desi._run_group_fit with the tail deferred, as
the drivers defer it, and collected at once: unsharded on card 0
(RVST_NO_MESH=1), and sharded by parallel/mesh over the first 2, 4, ...
cards of the host (each power of two up to torch.cuda.device_count();
on a one-card host, the card named twice).  Each configuration first
fits 64 fibers once (kernel modules and template models onto its
cards), then runs ``--repeats`` rounds, the order reversed every other
round.  Checks every fiber of a sharded fit within chip_smoke.SAME_SIGMA
of the unsharded one.  Prints per run the wall, the phases, the kernel
launches and each card's peak memory, then one JSON line of every run.
"""
import argparse
import json
import os
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

WARM_FIBERS = 64


def meshes():
    """{name: devices or None (unsharded)} of this host."""
    import torch
    n = torch.cuda.device_count()
    out = {'one card': None}
    if n < 2:
        out['card 0 twice'] = ['cuda:0', 'cuda:0']
    k = 2
    while k <= n:
        out[f'{k} cards'] = [f'cuda:{i}' for i in range(k)]
        k *= 2
    return out


def exposure(nfib):
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit.batch import BatchArm
    arms_data, truth = simulation.make_exposure(
        nfib, npix_arm=cs.NPIX_ARM, snr=50.0, seed=7)
    return [BatchArm(n, lam, fl, iv) for n, (lam, fl, iv)
            in arms_data.items()], truth


def fit(arms, tm, bank_d, devices):
    """One deferred group fit, collected, on ``devices`` (None: card 0
    alone): its result, wall, launches and each card's peak (GB)."""
    import torch
    from rvspecfit_torch.parallel import mesh as pmesh
    from rvspecfit_torch.survey import desi
    ncards = torch.cuda.device_count()
    for d in range(ncards):
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    real = pmesh.auto_shard
    patch = mock.patch.dict(os.environ, RVST_NO_MESH='1') \
        if devices is None else mock.patch.object(
            desi.pmesh, 'auto_shard', lambda bf: real(bf, devices=devices))
    cs.reset_counts()
    t0 = time.perf_counter()
    with patch:
        out = desi._run_group_fit(arms, {a.name: tm for a in arms},
                                  cs.CONFIG, cs.OPTIONS,
                                  banks={a.name: bank_d for a in arms})
        out = out.materialize()
    for d in range(ncards):
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    return out, dict(wall=wall, counts=cs.kernel_counts()['float64'],
                     peak_gb=[torch.cuda.max_memory_allocated(d) / 1e9
                              for d in range(ncards)])


def main():
    import torch
    from rvspecfit_torch import convert
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--fibers', type=int, default=1000)
    parser.add_argument('--repeats', type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_mesh_cards: no CUDA card', file=sys.stderr)
        return 2
    print(cs.environment())
    cs.build_kernels()
    device = torch.device('cuda', 0)
    tm, _, _, bank = cs.make_workload(device)
    bank_d = convert.ccf_bank(*bank, device=device)
    arms, truth = exposure(args.fibers)
    warm, _ = exposure(WARM_FIBERS)
    configs = meshes()
    for name, devices in configs.items():
        _, r = fit(warm, tm, bank_d, devices)
        print(f'{name:>14} warm-up ({WARM_FIBERS} fibers): '
              f'{r["wall"]:.3f} s', flush=True)
    results, want = [], None
    names = list(configs)
    for rnd in range(args.repeats):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            out, r = fit(arms, tm, bank_d, configs[name])
            vals = np.column_stack([out['ref']['best_vel'], out['params']])
            if configs[name] is None and want is None:
                want = (vals, np.column_stack([out['ref']['vel_err'],
                                               out['errs']]))
            ok = np.abs(out['ref']['best_vel'] - truth['vel']) < np.maximum(
                10.0, 5 * out['ref']['vel_err'])
            results.append(dict(config=name, round=rnd, vals=vals,
                                recovered=int(ok.sum()),
                                phases=out['phases'], **r))
            print(f'{name:>14} round {rnd}: {r["wall"]:.3f} s ('
                  + ' '.join(f'{k}={v:.3f}s' for k, v in
                             out['phases'].items())
                  + f'); launches {r["counts"]}; peak GB per card '
                  f'{[round(p, 2) for p in r["peak_gb"]]}; RV recovery '
                  f'{int(ok.sum())}/{args.fibers}', flush=True)
    worst = 0.0
    for r in results:
        d = cs.sigma_spread(r.pop('vals'), *want)
        r['max_sigma'] = float(np.nanmax(d))
        worst = max(worst, r['max_sigma'])
    print(f'every run against the first unsharded one: largest difference '
          f'{worst:.3g} sigma (limit {cs.SAME_SIGMA})')
    print(json.dumps(results))
    return 0 if worst <= cs.SAME_SIGMA else 1


if __name__ == '__main__':
    sys.exit(main())
