#!/usr/bin/env python3
"""Time the DESI driver's overlaps one switch at a time on a CUDA card.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 tools/torch_overlap_ab.py [--files 6] [--repeats 2]

Writes ``--files`` coadds of 500 fibers in bench.py's format (seeds
100...) into a temporary directory and runs survey/desi.proc_many over
them at coalesce 2 (chip_smoke.py's phase-17 cell: in-memory models
and banks, float64), once per configuration of the switches
RVST_PIPELINE_PREP, RVST_DEFER_TAIL and RVST_ASYNC_WRITE: all at 0,
each alone at its default, all at their defaults.  The configurations
run in turn, ``--repeats`` rounds, the order reversed every other round
so that drifts of the host show.  Prints per run the steady s/file from
the status file's completion stamps, the cold group, the wall and the
peak device memory, then one JSON line of every run.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

SWITCHES = cs.OVERLAP_SWITCHES
CONFIGS = {'none': (), **{k.split('_', 1)[1].lower(): (k,)
                          for k in SWITCHES}, 'all': SWITCHES}


def run(files, workdir, tag, tm, bank_d, on):
    """One proc_many run with the switches ``on`` at their defaults and
    the others at 0."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        if k in on:
            os.environ.pop(k, None)
        else:
            os.environ[k] = '0'
    try:
        return cs.overlap_run(files, os.path.join(workdir, f'out-{tag}'),
                              os.path.join(workdir, f'status-{tag}.txt'),
                              tm, bank_d)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main():
    import torch
    from rvspecfit_torch import convert
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--files', type=int, default=cs.OVERLAP_FILES)
    parser.add_argument('--repeats', type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_overlap_ab: no CUDA card', file=sys.stderr)
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
        names = list(CONFIGS)
        for r in range(args.repeats):
            for name in (names if r % 2 == 0 else names[::-1]):
                t0 = time.perf_counter()
                out = run(files, workdir, f'{name}{r}', tm, bank_d,
                          CONFIGS[name])
                res = dict(config=name, round=r, steady=out['steady'],
                           cold=out['cold'], wall=out['wall'],
                           peak_gb=out['peak_gb'])
                results.append(res)
                print(f'{name:>14} round {r}: steady {out["steady"]:.3f} '
                      f's/file, cold group {out["cold"]:.3f} s, wall '
                      f'{out["wall"]:.3f} s, peak {out["peak_gb"]:.2f} GB '
                      f'({time.perf_counter() - t0:.1f} s)', flush=True)
    print(json.dumps(results))
    return 0


if __name__ == '__main__':
    sys.exit(main())
