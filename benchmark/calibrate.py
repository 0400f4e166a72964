#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison: one process fits one
group (or object) per reading, with the window opened as set-up ends,
as the program runs soundly, as the precision control (its float32
path) and with each planted fault of benchlib/faults.py; every compared
number of every judged answer goes to a JSON line of ``--out``.  The
float64 template models and banks are built once for all readings.
The benchmark's own runs never run it.

    python3 benchmark/calibrate.py --workload <name> --out <file> \\
        --reading sound:<seed> --reading control:<seed> \\
        --reading truncated:<seed> ...
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--out', required=True)
    ap.add_argument('--reading', action='append', required=True,
                    help='mode:seed, mode sound, control or a fault')
    ap.add_argument('--files', type=int, default=4,
                    help='coadds written a reading (two groups at '
                         'coalesce 2: the second is never fitted)')
    ap.add_argument('--bench-dir', default=None,
                    help='another copy of the benchmark (its tests)')
    ap.add_argument('--device', default=None,
                    help='default: the first CUDA card')
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    import torch
    from benchlib import program
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the float64 template models and banks are built once for all
    # readings (the float32 control's are built anew each time)
    memo = {}

    def once(fn):
        def call(ctx, cfg, *a):
            if (a[-1] if a else torch.float64) != torch.float64:
                return fn(ctx, cfg, *a)
            if fn.__name__ not in memo:
                memo[fn.__name__] = fn(ctx, cfg, *a)
            return memo[fn.__name__]
        return call
    real = program.template_models, program.ccf_banks
    program.template_models, program.ccf_banks = map(once, real)
    try:
        _readings(args)
    finally:
        program.template_models, program.ccf_banks = real
    return 0


def _readings(args):
    import numpy as np
    import torch
    from benchlib import faults, harness, spec
    for reading in args.reading:
        mode, seed = reading.split(':')
        cell = spec.Cell(args.workload, args.bench_dir or spec.BENCH_DIR)
        if 'files' in cell.traffic:
            cell.traffic['files'] = args.files
        t0 = time.time()
        per = {}
        try:
            with contextlib.ExitStack() as stack:
                if mode not in ('sound', 'control'):
                    for p in faults.patches(cell.traffic['driver'], mode):
                        stack.enter_context(p)
                res = harness.run(
                    args.workload, int(seed), 0.0, 0, t0, cell=cell,
                    device=args.device, bench_dir=cell.bench_dir,
                    dtype=(torch.float32 if mode == 'control'
                           else torch.float64),
                    open_at_start=True, per_answer=per)
        except Exception as exc:         # a crash is a reading too
            harness.log(f'reading {mode}:{seed} raised {exc!r}')
            with open(args.out, 'a') as fp:
                fp.write(json.dumps(dict(mode=mode, seed=int(seed),
                                         error=repr(exc))) + '\n')
            gc.collect()
            continue
        line = dict(mode=mode, seed=int(seed), seconds=time.time() - t0,
                    checks={k: c['value'] for k, c in res['checks'].items()},
                    attempted=res['attempted'], failed=res['failed'],
                    numbers={k: np.asarray(v).tolist()
                             for k, v in per['numbers'].items()},
                    truth=[a.get('truth') for a in per['answers']])
        with open(args.out, 'a') as fp:
            fp.write(json.dumps(line) + '\n')
        harness.log(f'reading {mode}:{seed} ' + json.dumps(line['checks']))
        del res, per
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == '__main__':
    sys.exit(main())
