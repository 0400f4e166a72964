#!/usr/bin/env python3
"""Time the DESI driver before and after a torch.profiler session.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 tools/torch_profiler_drift.py [--files 6] [--no-profile]

Writes ``--files`` coadds of 500 fibers (chip_smoke.py's phase-17 cell:
seeds 100..., in-memory models and banks, float64, coalesce 2) and runs
survey/desi.proc_many over them with the overlap switches at 0, then
at their defaults; then once over 4 files under torch.profiler
(chip_smoke.device_busy), or, with ``--no-profile``, the same run
without the profiler; then at the defaults and at 0 again.  Prints
per run the steady s/file from the status stamps, the cold group and
the wall, then one JSON line of every run.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from rvspecfit_torch import convert
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--files', type=int, default=cs.OVERLAP_FILES)
    parser.add_argument('--no-profile', action='store_true')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_profiler_drift: no CUDA card', file=sys.stderr)
        return 2
    print(cs.environment())
    cs.build_kernels()
    device = torch.device('cuda', 0)
    tm, arms, _, bank = cs.make_workload(device)
    bank_d = convert.ccf_bank(*bank, device=device)
    cs.run_group_fit(tm, arms, {a.name: bank_d for a in arms})
    results = []
    with tempfile.TemporaryDirectory() as workdir:
        files, _ = cs.driver_inputs(workdir, nfiles=args.files,
                                    seed0=cs.OVERLAP_SEED0)

        def run(tag, subset, on):
            with cs.overlap_switches(on):
                return cs.overlap_run(subset, os.path.join(workdir, tag),
                                      os.path.join(workdir, f'{tag}.txt'),
                                      tm, bank_d)
        for stage, order in (('before', cs.OVERLAP_ORDER[:2]),
                             ('after', cs.OVERLAP_ORDER[2:])):
            for key, on in order:
                out = run(f'{stage}-{key}', files, on)
                results.append(dict(stage=stage, run=key,
                                    steady=out['steady'], cold=out['cold'],
                                    wall=out['wall']))
                print(f'{stage:>6} {key:>8}: steady {out["steady"]:.3f} '
                      f's/file, cold group {out["cold"]:.3f} s, wall '
                      f'{out["wall"]:.3f} s', flush=True)
            if stage == 'after':
                break
            sub = files[:cs.OVERLAP_PROFILED_FILES]
            if args.no_profile:
                out = run('middle', sub, False)
                print(f'middle run without the profiler: wall '
                      f'{out["wall"]:.3f} s', flush=True)
            else:
                _, busy = cs.device_busy(lambda: run('middle', sub, False))
                print(f'middle run under the profiler: wall '
                      f'{busy["wall_ms"] / 1e3:.3f} s, busy share '
                      f'{busy["busy_share"]:.4f}', flush=True)
    print(json.dumps(dict(profile=not args.no_profile, runs=results)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
