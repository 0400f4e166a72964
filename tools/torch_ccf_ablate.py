#!/usr/bin/env python3
"""Where kernel B's time goes: the kernel against builds of its own
source with parts taken out, at the main path's shapes, on one card.

Usage (from the root of a checkout, on a machine with one NVIDIA card
and the CUDA toolkit):

    python3 tools/torch_ccf_ablate.py

Variants, each built from rvspecfit_torch/csrc/ccf_chisq.cu with the
source's own RVST_ABLATE switch (see the top of the source):

* kernel (RVST_ABLATE=0): the kernel as the port builds it;
* no_copies (1): no cp.async (the shared-memory tiles keep whatever
  they hold): forming the A tile, the fragment loads and splits, the
  MMAs;
* mma_only (2): no copies, no A forming, no per-chunk barrier,
  fragments made in registers: the rate of the 3xTF32 mma.sync
  instruction stream at this tiling, the ceiling of the design;
* mma_only_1pass (3): the same with only the hi*hi product: the rate
  of single-pass TF32 mma.sync.

Only `kernel` computes the function; the others time parts of it.
Each is timed with CUDA events (10 launches after one) in the order
listed and then again in reverse.  Prints one line per variant and,
last, a JSON object.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# variant -> (RVST_ABLATE level, TF32 passes per tile product)
VARIANTS = dict(kernel=(0, 3), no_copies=(1, 3), mma_only=(2, 3),
                mma_only_1pass=(3, 1))


def build(name, level):
    """ctypes launcher of ccf_chisq.cu built with RVST_ABLATE=level, and
    the registers ptxas reports for its two instantiations."""
    from rvspecfit_torch.ops import ccf_chisq, cuda_build
    out_dir = cuda_build.BUILD / 'ablate'
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f'lib{name}.so'
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           f'-DRVST_ABLATE={level}', '-o', str(lib),
                           str(cuda_build.CSRC / 'ccf_chisq.cu')],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed on {name}:\n{proc.stderr}')
    fn = ctypes.CDLL(str(lib)).rvst_ccf_chisq
    fn.argtypes = ccf_chisq.build().argtypes
    fn.restype = ctypes.c_int
    return fn, re.findall(r'Used (\d+) registers', proc.stderr)


def main():
    import torch
    if not torch.cuda.is_available():
        print('torch_ccf_ablate: no CUDA device', file=sys.stderr)
        return 2
    from rvspecfit_torch import convert
    from rvspecfit_torch.ops import ccf_chisq, cuda_build
    device = torch.device('cuda', 0)
    smi = chip_smoke.environment()
    fns, regs = {}, {}
    for name, (level, _) in VARIANTS.items():
        fns[name], regs[name] = build(name, level)
    arms, _ = chip_smoke.make_arms()
    kargs, cont = chip_smoke.kernel_b_args(
        arms, convert.ccf_bank(*chip_smoke.make_bank(), device=device))
    ops = ccf_chisq.kernel_operands(*kargs)
    nt, nf = kargs[0].shape
    nb, nv = kargs[2].shape[0], kargs[4].shape[1]
    out = torch.empty((nb, nt, nv), dtype=torch.float32, device=device)
    stream = cuda_build.current_stream(out)
    gemm_flop = 2.0 * nb * nt * nv * 2 * nf
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        fn = fns[name]

        def call():
            err = fn(*(x.data_ptr() for x in ops), out.data_ptr(), nb, nt,
                     nf, nv, int(cont), stream)
            cuda_build.check_launch(err, name)
        times[name].append(chip_smoke.cuda_time(call, 10))
        if name == 'kernel':
            want = ccf_chisq.ccf_chisq_plain(*kargs, continuum=cont)
            err = float((out - want).abs().max() / want.abs().max())
            chip_smoke.check(err <= 1e-4, f'kernel disagrees: {err}')
    rows = []
    for name, (_, passes) in VARIANTS.items():
        ms = sum(times[name]) / len(times[name])
        rate = passes * gemm_flop / (ms * 1e-3) / 1e12
        rows.append(dict(variant=name, ms=ms, tflops=rate, passes=passes,
                         registers=regs[name]))
        chip_smoke.log(f'{name}: {ms:.3f} ms ({times[name]}), '
                       f'{rate:.1f} TFLOP/s of {passes}-pass TF32 MMA, '
                       f'registers {regs[name]}')
    print(json.dumps(dict(card=smi, shape=[nb, nt, nf, nv], variants=rows)))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as exc:
        print(f'torch_ccf_ablate: FAILED: {exc}', file=sys.stderr)
        sys.exit(1)
