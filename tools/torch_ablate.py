#!/usr/bin/env python3
"""Where a CUDA kernel's time goes: the kernel against builds of its own
source with parts taken out, at the main path's shapes, on one card.

Usage (from the root of a checkout, on a machine with one NVIDIA card
and the CUDA toolkit):

    python3 tools/torch_ablate.py ccf_chisq
    python3 tools/torch_ablate.py spline_eval_adjoint

Each variant is a build of the kernel's source with its own RVST_ABLATE
switch (the top of each source says what each level leaves out).

ccf_chisq, kernel B (rvspecfit_torch/csrc/ccf_chisq.cu), timed with CUDA
events (10 launches after one), each line with its TF32 MMA rate:

* kernel (RVST_ABLATE=0): the kernel as the port builds it;
* no_copies (1): no cp.async (the shared-memory tiles keep whatever
  they hold): forming the A tile, the fragment loads and splits, the
  MMAs;
* mma_only (2): no copies, no A forming, no per-chunk barrier,
  fragments made in registers: the rate of the 3xTF32 mma.sync
  instruction stream at this tiling, the ceiling of the design;
* mma_only_1pass (3): the same with only the hi*hi product: the rate
  of single-pass TF32 mma.sync.

spline_eval_adjoint, kernel A's adjoint (rvspecfit_torch/csrc/
spline_eval.cu), at the polish's shape (500 x 1024 queries -> (500, 4,
4095)), timed from HBM as chip_smoke.check_adjoint times it (CUDA-graph
replays over L2_COPIES copies of the inputs and output), each line with
its share of the bound:

* kernel (0): the kernel;
* output_only (1): the output's dense writes alone (zeros everywhere,
  nothing read);
* no_zero_writes (2): the rest: the work on the queries and the writes
  of their sums, into an output zeroed once beforehand, without writing
  the zeros.

Only `kernel` computes the function; it is checked against the plain
version first.  The variants are timed in the order listed and then
again in reverse.  Prints one line per variant and, last, a JSON
object.
"""
import argparse
import collections
import concurrent.futures
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# kernel -> (source in csrc, C launcher, name of its __global__ function,
# {variant: RVST_ABLATE level})
KERNELS = dict(
    ccf_chisq=('ccf_chisq.cu', 'rvst_ccf_chisq', 'ccf_chisq_kernel',
               dict(kernel=0, no_copies=1, mma_only=2, mma_only_1pass=3)),
    spline_eval_adjoint=('spline_eval.cu', 'rvst_spline_adjoint',
                         'spline_adjoint_kernel',
                         dict(kernel=0, output_only=1, no_zero_writes=2)),
)
# ccf_chisq: TF32 passes per tile product of each variant
CCF_PASSES = dict(kernel=3, no_copies=3, mma_only=3, mma_only_1pass=1)

# one kernel's inputs at the path's shape: its launcher's argtypes, the
# shape, time(fn, name) -> ms of one variant, check(fn) of the kernel
# against its plain version, report(name, ms) -> ({extra keys}, text)
Bench = collections.namedtuple('Bench', 'argtypes shape time check report')


def registers(ptxas, entry):
    """What ptxas reports (registers, spills) for the kernels whose
    mangled names hold ``entry``, from nvcc's -Xptxas -v output."""
    return [' | '.join(line.split(':', 1)[-1].strip()
                       for line in chunk.splitlines()
                       if 'registers' in line or 'spill' in line)
            for chunk in ptxas.split('Compiling entry function')[1:]
            if entry in chunk.splitlines()[0]]


def build(kernel, name, level, argtypes):
    """ctypes launcher of the kernel's source built with
    RVST_ABLATE=level, and what ptxas reports for the kernel."""
    from rvspecfit_torch.ops import cuda_build
    source, launcher, entry, _ = KERNELS[kernel]
    out_dir = cuda_build.BUILD / 'ablate' / kernel
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f'lib{name}.so'
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           f'-DRVST_ABLATE={level}', '-o', str(lib),
                           str(cuda_build.CSRC / source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed on {kernel} {name}:\n{proc.stderr}')
    fn = getattr(ctypes.CDLL(str(lib)), launcher)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn, registers(proc.stderr, entry)


def ccf_bench(device):
    """Kernel B, continuum, at the main path's shapes."""
    import torch
    from rvspecfit_torch import convert
    from rvspecfit_torch.ops import ccf_chisq, cuda_build
    arms, _ = chip_smoke.make_arms()
    kargs, cont = chip_smoke.kernel_b_args(
        arms, convert.ccf_bank(*chip_smoke.make_bank(), device=device))
    ops = ccf_chisq.kernel_operands(*kargs)
    nt, nf = kargs[0].shape
    nb, nv = kargs[2].shape[0], kargs[4].shape[1]
    out = torch.empty((nb, nt, nv), dtype=torch.float32, device=device)
    stream = cuda_build.current_stream(out)
    gemm_flop = 2.0 * nb * nt * nv * 2 * nf

    def launch(fn, name):
        err = fn(*(x.data_ptr() for x in ops), out.data_ptr(), nb, nt, nf,
                 nv, int(cont), stream)
        cuda_build.check_launch(err, name)

    def check(fn):
        launch(fn, 'kernel')
        want = ccf_chisq.ccf_chisq_plain(*kargs, continuum=cont)
        err = float((out - want).abs().max() / want.abs().max())
        chip_smoke.check(err <= 1e-4, f'kernel disagrees: {err}')

    def report(name, ms):
        passes = CCF_PASSES[name]
        rate = passes * gemm_flop / (ms * 1e-3) / 1e12
        return (dict(tflops=rate, passes=passes),
                f'{rate:.1f} TFLOP/s of {passes}-pass TF32 MMA')
    return Bench(ccf_chisq.ARGTYPES, [nb, nt, nf, nv],
                 lambda fn, name: chip_smoke.cuda_time(
                     lambda: launch(fn, name), 10),
                 check, report)


def adjoint_bench(device):
    """Kernel A's adjoint at the polish's shape."""
    import torch
    from rvspecfit_torch.ops import cuda_build, spline_eval
    tm = chip_smoke.make_template_model(device)
    arms, truth = chip_smoke.make_arms()
    u, g, nm1 = chip_smoke.adjoint_inputs(tm, arms, truth, device)
    geo = (int(tm.geom.log_step), tm.geom.x0, tm.geom.step,
           math.expm1(tm.geom.step) if tm.geom.log_step else 0.0)
    out = torch.zeros((u.shape[0], 4, nm1), dtype=torch.float32,
                      device=device)
    bound = chip_smoke.adjoint_bound_ms(u, nm1)

    def launcher(fn, name):
        def call(uu, gg, oo):
            err = fn(uu.data_ptr(), gg.data_ptr(), oo.data_ptr(), uu.shape[0],
                     uu.shape[1], nm1, *geo, cuda_build.current_stream(uu))
            cuda_build.check_launch(err, name)
            return oo
        return call

    def check(fn):
        got = launcher(fn, 'kernel')(u, g, torch.empty_like(out))
        want = spline_eval.spline_eval_index_vjp_plain(tm.geom, u, g, nm1)
        err, scale = chip_smoke.compare(got, want)
        chip_smoke.check(err <= 1e-5 * scale,
                         f'kernel disagrees: {err} of {scale}')

    def report(name, ms):
        return (dict(bound_ms=bound, share=bound / ms),
                f'{100 * bound / ms:.1f}% of the {bound:.4f} ms bound')
    return Bench(spline_eval.ADJOINT_ARGTYPES, [u.shape[0], u.shape[1], nm1],
                 lambda fn, name: chip_smoke.cuda_time(
                     chip_smoke.cold_inputs(launcher(fn, name), u, g, out),
                     2 * chip_smoke.L2_COPIES, graph=True),
                 check, report)


BENCHES = dict(ccf_chisq=ccf_bench, spline_eval_adjoint=adjoint_bench)


def main():
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('kernel', choices=list(KERNELS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_ablate: no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    smi = chip_smoke.environment()
    bench = BENCHES[args.kernel](device)
    variants = KERNELS[args.kernel][3]
    with concurrent.futures.ThreadPoolExecutor() as ex:
        built = dict(zip(variants, ex.map(
            lambda kv: build(args.kernel, *kv, bench.argtypes),
            variants.items())))
    bench.check(built['kernel'][0])
    times = {name: [] for name in variants}
    for name in list(variants) + list(variants)[::-1]:
        times[name].append(bench.time(built[name][0], name))
    rows = []
    for name, level in variants.items():
        ms = sum(times[name]) / len(times[name])
        extra, text = bench.report(name, ms)
        rows.append(dict(variant=name, level=level, ms=ms, runs=times[name],
                         ptxas=built[name][1], **extra))
        chip_smoke.log(f'{name} (RVST_ABLATE={level}): {ms:.4f} ms '
                       f'({[round(t, 4) for t in times[name]]}), {text}, '
                       f'ptxas: {built[name][1]}')
    print(json.dumps(dict(card=smi, kernel=args.kernel, shape=bench.shape,
                          variants=rows)))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as exc:
        print(f'torch_ablate: FAILED: {exc}', file=sys.stderr)
        sys.exit(1)
