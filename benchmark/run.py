#!/usr/bin/env python3
"""Run one cell of the benchmark once, on this machine's CUDA card(s):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It sets up (makes the template grids and the inputs from the seed,
builds the program's models and banks on the card), measures a window
of ``--seconds``, judges what the window produced against the plain
reference, and prints the result as one JSON line, the last of
standard output; the numbers compared, each beside its limit, are the
last lines of standard error.  ``--trace 1`` measures the per-layer
metrics under torch.profiler instead of the end-to-end ones.  It
exits 3 without a result where the cell's cards are missing, and 4
where the JAX package or JAX is loaded in this process."""
import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault('USE_FLAX', '0')
    os.environ.setdefault('TRITON_CACHE_DIR',
                          os.path.join(ROOT, '.bench_cache', 'triton'))
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    from benchlib import harness
    result = harness.run(args.workload, args.seed, args.seconds, args.trace,
                         T_START)
    found = harness.forbidden_modules()
    if found:
        print(f'loaded in this process: {", ".join(found)}', file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
