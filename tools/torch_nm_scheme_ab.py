#!/usr/bin/env python3
"""A/B of Nelder-Mead's candidate schemes (RVST_NM_SCHEME) on the card.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 tools/torch_nm_scheme_ab.py [--fibers 500] [--repeats 2]

The port's counterpart of tools/ab_nm_scheme.py.  ``scan2`` evaluates
the reflection, then one second candidate derived from it: two (B, 1)
objective calls per iteration; ``cand4`` evaluates the reflection, the
expansion and both contractions in one (B, 4) call.  On chip_smoke.py's
exposure (``--fibers`` fibers, seed 7, S/N 50, 3 arms, the 864-template
model and CCF bank, float64) the CCF start runs once, then
BatchedFitter.run_neldermead from it under each scheme, ``--repeats``
rounds of scan2, cand4, cand4, scan2 (one configuration drifts within a
process, so the order alternates), after one untimed run of each.
Prints per run the NM wall, iterations, obj_evals, the kernel launches
and the peak device memory; then the median and 95th percentile of
each fiber's NM optimum under scan2 minus under cand4 (Δχ², first
rounds' runs), and one JSON line of every run.
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

ORDER = ('scan2', 'cand4', 'cand4', 'scan2')


def run_nm(bf, mapper, ccf, scheme):
    """One run_neldermead from the CCF start under ``scheme``: (result,
    numbers)."""
    import torch
    x0 = np.concatenate([ccf['best_vel'][:, None], ccf['best_params']], 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_counts()
    acc = {}
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, RVST_NM_SCHEME=scheme), \
            cs.nm_accounting(acc):
        out = bf.run_neldermead(mapper, ccf['best_vel'], x0=x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, dict(scheme=scheme, wall=wall, iterations=acc['steps'],
                     fiber_iterations=acc['fiber_iters'],
                     obj_evals=int(out['obj_evals']),
                     converged=int(out['converged'].sum()),
                     counts=cs.kernel_counts()['float64'],
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def main():
    import torch
    from rvspecfit_torch import convert
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit import ccf as ccf_mod
    from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
    from rvspecfit_torch.fit.vel_fit import ParamMapper
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--fibers', type=int, default=cs.NFIBERS)
    parser.add_argument('--repeats', type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_nm_scheme_ab: no CUDA card', file=sys.stderr)
        return 2
    print(cs.environment())
    cs.build_kernels()
    device = torch.device('cuda', 0)
    tm, _, _, bank = cs.make_workload(device)
    bank_d = convert.ccf_bank(*bank, device=device)
    arms_data, _ = simulation.make_exposure(args.fibers, npix_arm=cs.NPIX_ARM,
                                            snr=50.0, seed=7)
    arms = [BatchArm(n, lam, fl, iv) for n, (lam, fl, iv)
            in arms_data.items()]
    bf = BatchedFitter(arms, {a.name: tm for a in arms}, cs.CONFIG,
                       options=cs.OPTIONS)
    ccf = ccf_mod.fit_batch([(a.name, a.lam, a.flux, 1.0 / np.sqrt(a.ivar),
                              None) for a in arms], cs.CONFIG,
                            {a.name: bank_d for a in arms})
    mapper = ParamMapper(tm.parnames, cs.START, [], None, False)
    for scheme in ORDER[:2]:
        run_nm(bf, mapper, ccf, scheme)
    results, optima = [], {}
    for rnd in range(args.repeats):
        for scheme in ORDER:
            out, r = run_nm(bf, mapper, ccf, scheme)
            optima.setdefault(scheme, out['fun'])
            results.append(dict(r, round=rnd))
            print(f'{scheme} round {rnd}: NM {r["wall"]:.3f} s, '
                  f'{r["iterations"]} iterations, {r["fiber_iterations"]} '
                  f'fiber-iterations, obj_evals {r["obj_evals"]}, converged '
                  f'{r["converged"]}/{args.fibers}; launches {r["counts"]}; '
                  f'peak {r["peak_gb"]:.2f} GB', flush=True)
    dchi = optima['scan2'] - optima['cand4']
    for scheme in ('scan2', 'cand4'):
        walls = [r['wall'] for r in results if r['scheme'] == scheme]
        print(f'{scheme}: NM wall median {np.median(walls):.3f} s over '
              f'{len(walls)} runs (min {min(walls):.3f}, max '
              f'{max(walls):.3f})')
    print(f'optimum scan2 - cand4 per fiber: median {np.median(dchi):.3g}, '
          f'95th percentile {np.percentile(dchi, 95):.3g}, max |.| '
          f'{np.abs(dchi).max():.3g}')
    print(json.dumps(dict(runs=results,
                          median_dchi2=float(np.median(dchi)),
                          p95_dchi2=float(np.percentile(dchi, 95)))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
