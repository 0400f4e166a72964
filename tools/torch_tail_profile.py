#!/usr/bin/env python3
"""Where the group fit's tail spends its time on one card: each stage
after Nelder-Mead profiled alone, at the main path's shapes.

Usage (from the root of a checkout, on a machine with one NVIDIA card
and the CUDA toolkit):

    python3 tools/torch_tail_profile.py

Builds chip_smoke.py's workload (500 fibers x 3 arms x 1024 px, the
864-template grid, npoly 10), runs the group fit once (cold), then
runs each stage of the tail from that fit's Nelder-Mead optima again
under torch.profiler: the polish (2 steps), the velocity refinement,
the AD Hessian errors and the best-fit models, and one objective call
of 4 trials per fiber (the polish's candidate evaluation) for scale.
For each it prints the wall time of an unprofiled call and of the
profiled one, the device's busy time (the sum of its kernels' times:
one stream, so they do not overlap) and its share of the unprofiled
wall, the number of kernels, and the five kernels with the most device
time.
Prints last a JSON object of the same numbers.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def profiled(fn):
    """(wall s, device busy s, kernel count, top-5 [(name, ms, calls)])
    of one call of fn() under torch.profiler (chip_smoke.device_activity:
    kernels and memory copies; the wall with the profiler on)."""
    import torch
    wall = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    activity = chip_smoke.device_activity(timed)
    return (wall[0], 1e-3 * sum(t for t, _ in activity.values()),
            sum(n for _, n in activity.values()),
            chip_smoke.top_activity(activity))


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('torch_tail_profile: no CUDA device', file=sys.stderr)
        return 2
    from rvspecfit_torch import convert
    from rvspecfit_torch.fit.batch import BatchedFitter
    from rvspecfit_torch.fit.vel_fit import ParamMapper
    device = torch.device('cuda', 0)
    smi = chip_smoke.environment()
    chip_smoke.build_kernels()
    tm, arms, _, bank = chip_smoke.make_workload(device)
    banks = {a.name: convert.ccf_bank(*bank, device=device) for a in arms}
    out = chip_smoke.run_group_fit(tm, arms, banks)
    parnames = tm.parnames
    bf = BatchedFitter(arms, {a.name: tm for a in arms}, chip_smoke.CONFIG,
                       options=chip_smoke.OPTIONS)
    start = dict(zip(parnames, out['params'].mean(axis=0)))
    mapper = ParamMapper(parnames, start, [], None, False)
    x, fun = out['nm']['x'], out['nm']['fun']
    vel, params, vsini = mapper.unpack_host(out['x'])
    ref_vel = out['ref']['best_vel']
    objective = bf._objective(mapper, None,
                              torch.arange(bf.nfibers, device=device))
    cand = torch.as_tensor(np.repeat(x[:, None], 4, 1), dtype=torch.float32,
                           device=device)
    stages = dict(
        objective_4_trials=lambda: objective(cand),
        polish=lambda: bf.run_polish(mapper, x, fun0=fun),
        refine=lambda: bf.refine_velocities(vel, params, vsinis=vsini),
        hessian=lambda: bf.hessian_errors(ref_vel, params, vsinis=vsini,
                                          parnames=parnames),
        models=lambda: bf.best_models(ref_vel, params, vsinis=vsini))
    result = {}
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        unprofiled = time.perf_counter() - t0
        wall, busy, nkern, top = profiled(fn)
        result[name] = dict(wall_s=unprofiled, profiled_wall_s=wall,
                            device_busy_s=busy, busy_share=busy / unprofiled,
                            kernels=nkern, top=top)
        chip_smoke.log(f'{name}: wall {unprofiled:.4f} s ({wall:.4f} s '
                       f'profiled), device busy {busy:.4f} s '
                       f'({100 * busy / unprofiled:.1f}% of the unprofiled '
                       f'wall), {nkern} kernels; top: {top}')
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
