#!/usr/bin/env python3
"""The precision control of a cell: the same run as benchmark/run.py,
with the program's own float32 path switched on (its template models
and CCF banks in float32, TF32 off), which the comparison has to judge
not correct.  The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <name> --seed <n> --seconds <s>
"""
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
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    import torch
    from benchlib import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(args.workload, args.seed, args.seconds, 0, T_START,
                         dtype=torch.float32)
    result['control'] = 'float32'
    harness.emit(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
