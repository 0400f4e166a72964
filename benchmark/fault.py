#!/usr/bin/env python3
"""A run of a cell with one fault planted in the program's timed path
(benchlib/faults.py), which the comparison has to judge not correct;
the benchmark's own runs never run it.

    python3 benchmark/fault.py --workload <name> --seed <n> --seconds <s> --fault stuck|half|altered|truncated|ccf
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--fault', required=True,
                    choices=('stuck', 'half', 'altered', 'truncated', 'ccf'))
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    from benchlib import faults, harness, spec
    cell = spec.Cell(args.workload)
    with contextlib.ExitStack() as stack:
        for p in faults.patches(cell.traffic['driver'], args.fault):
            stack.enter_context(p)
        result = harness.run(args.workload, args.seed, args.seconds, 0,
                             T_START, cell=cell)
    result['fault'] = args.fault
    harness.emit(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
