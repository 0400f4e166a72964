#!/usr/bin/env python3
"""A/B timing of rvspecfit_torch's CUDA kernels (kernel A, its adjoint,
kernel B) against a baseline build of other sources of them, at the
main path's shapes, on one card.

Usage (from the root of a checkout, on a machine with one NVIDIA card
and the CUDA toolkit):

    python3 tools/torch_kernel_ab.py --baseline-csrc OTHER/rvspecfit_torch/csrc

OTHER is, for example, an earlier commit unpacked with ``git archive``
into a git-ignored directory.  The baseline's C launchers must have the
current sources' parameter lists, or (kernel B) the one of its first
port, which took Ecos and Esin apart; the tool refuses any other.  The
adjoint is compared where the baseline's spline_eval.cu has one (with
the current parameters).  Both versions are built with the same nvcc
flags (the baseline into ``rvspecfit_torch/_build/baseline/``), checked
against the plain versions, and timed with CUDA events in the order
baseline, current, current, baseline (kernel A's per-row mode and the
adjoint, a few microseconds, from CUDA-graph replays over copies of
their inputs, chip_smoke.cold_inputs); the plain versions and, for
kernel B with continuum, one fp32 torch.matmul of the materialized
contraction (the library yardstick) are timed beside them.  The inputs
are chip_smoke.py's: the 500-fiber, 3-arm exposure of bench.py's
workload.  Prints one line per case and, last, a JSON object.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

REPS = dict(kernel=20, plain=5, library=5)

# kernel B's C launcher in its first port: T, T2, S, IV, Ecos, Esin apart
SEPARATE_DFT = ('const float* tfft, const float* t2fft, const float* '
                'sfft_conj, const float* ivfft_conj, const float* ecos, '
                'const float* esin, float* out, int nb, int nt, int nf, '
                'int nv, int continuum, void* stream')


def c_params(path, name):
    """Parameter list of ``extern "C" int rvst_<name>(...)`` in the
    source at ``path``, whitespace collapsed (None if absent)."""
    m = re.search(rf'extern "C" int rvst_{name}\(([^)]*)\)',
                  Path(path).read_text())
    return ' '.join(m.group(1).split()) if m else None


def baseline_interface(csrc, name):
    """'current' where the baseline's launcher takes the current
    sources' parameters, 'separate_dft' for kernel B's first port;
    refuses any other."""
    from rvspecfit_torch.ops import cuda_build
    got = c_params(Path(csrc) / f'{name}.cu', name)
    if got == c_params(cuda_build.CSRC / f'{name}.cu', name):
        return 'current'
    if name == 'ccf_chisq' and got == SEPARATE_DFT:
        return 'separate_dft'
    raise SystemExit(f'torch_kernel_ab: the baseline rvst_{name} takes '
                     f'({got}), an interface this tool cannot call')


def baseline_has_adjoint(csrc):
    """Whether the baseline's spline_eval.cu has the adjoint with the
    current parameters (False where it has none); refuses another
    interface."""
    from rvspecfit_torch.ops import cuda_build
    got = c_params(Path(csrc) / 'spline_eval.cu', 'spline_adjoint')
    if got is None:
        return False
    if got == c_params(cuda_build.CSRC / 'spline_eval.cu', 'spline_adjoint'):
        return True
    raise SystemExit(f'torch_kernel_ab: the baseline rvst_spline_adjoint '
                     f'takes ({got}), an interface this tool cannot call')


def build_baseline(csrc):
    """ctypes launchers of the baseline sources, bound through their
    own interfaces (the adjoint's as 'spline_eval_adjoint', where the
    baseline has one); returns ({name: (fn, interface)}, {name: ptxas
    report})."""
    import ctypes
    from rvspecfit_torch.ops import ccf_chisq, cuda_build, spline_eval
    out = cuda_build.BUILD / 'baseline'
    out.mkdir(parents=True, exist_ok=True)
    fns, ptxas = {}, {}
    for name, mod in (('spline_eval', spline_eval), ('ccf_chisq', ccf_chisq)):
        interface = baseline_interface(csrc, name)
        types = mod.build().argtypes if interface == 'current' else \
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib = out / f'lib{name}.so'
        proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                               '-o', str(lib), str(Path(csrc) / f'{name}.cu')],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on the baseline {name}:\n'
                               f'{proc.stderr}')
        handle = ctypes.CDLL(str(lib))
        fn = getattr(handle, f'rvst_{name}')
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = (fn, interface)
        ptxas[name] = proc.stderr.strip()
        if name == 'spline_eval' and baseline_has_adjoint(csrc):
            fn = handle.rvst_spline_adjoint
            fn.argtypes = spline_eval.ADJOINT_ARGTYPES
            fn.restype = ctypes.c_int
            fns['spline_eval_adjoint'] = (fn, 'current')
    return fns, ptxas


def baseline_spline(fn, geom, coeffs, u, rpc):
    """The baseline kernel A through its C interface (the current
    one)."""
    import math
    import torch
    from rvspecfit_torch.ops import cuda_build
    fn = fn[0]
    out = torch.empty_like(u)
    err = fn(coeffs.data_ptr(), u.data_ptr(), out.data_ptr(), u.shape[0],
             u.shape[1], coeffs.shape[-1], rpc, int(geom.log_step), geom.x0,
             geom.step, math.expm1(geom.step) if geom.log_step else 0.0,
             cuda_build.current_stream(u))
    cuda_build.check_launch(err, 'baseline spline_eval')
    return out


def baseline_adjoint(fn, geom, u, g, nm1):
    """The baseline adjoint through the current C interface."""
    import math
    import torch
    from rvspecfit_torch.ops import cuda_build
    out = torch.empty((u.shape[0], 4, nm1), dtype=u.dtype, device=u.device)
    err = fn[0](u.data_ptr(), g.data_ptr(), out.data_ptr(), u.shape[0],
                u.shape[1], nm1, int(geom.log_step), geom.x0, geom.step,
                math.expm1(geom.step) if geom.log_step else 0.0,
                cuda_build.current_stream(u))
    cuda_build.check_launch(err, 'baseline spline_eval_adjoint')
    return out


def baseline_ccf(fn, args, continuum):
    """The baseline kernel B through its C interface: the current
    operand layouts (ccf_chisq.kernel_operands), or the six inputs as
    they are."""
    import torch
    from rvspecfit_torch.ops import ccf_chisq, cuda_build
    fn, interface = fn
    nt, nf = args[0].shape
    nb, nv = args[2].shape[0], args[4].shape[1]
    ops = ccf_chisq.kernel_operands(*args) if interface == 'current' \
        else args
    out = torch.empty((nb, nt, nv), dtype=torch.float32,
                      device=args[0].device)
    err = fn(*(x.data_ptr() for x in ops), out.data_ptr(), nb, nt, nf, nv,
             int(continuum), cuda_build.current_stream(out))
    cuda_build.check_launch(err, 'baseline ccf_chisq')
    return out


def ab_times(baseline, current, graph=False):
    """(baseline ms, current ms), each the mean of two runs taken in the
    order baseline, current, current, baseline; ``graph``: from graph
    replays over 2 L2_COPIES calls."""
    t = {baseline: [], current: []}
    reps = 2 * chip_smoke.L2_COPIES if graph else REPS['kernel']
    for fn in (baseline, current, current, baseline):
        t[fn].append(chip_smoke.cuda_time(fn, reps, graph))
    return sum(t[baseline]) / 2, sum(t[current]) / 2


def check_both(baseline, current, plain, tol):
    """Max |diff| / max|plain| of baseline and current."""
    import torch
    want = plain()
    errs = []
    for fn in (baseline, current):
        got = fn()
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max())
                    / float(want.abs().max()))
    chip_smoke.check(all(e <= tol for e in errs),
                     f'a build disagrees with the plain version: {errs}')
    return errs


def main():
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--baseline-csrc', required=True,
                        help='directory holding the baseline '
                             'spline_eval.cu and ccf_chisq.cu')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_kernel_ab: no CUDA device', file=sys.stderr)
        return 2
    from rvspecfit_torch import convert
    from rvspecfit_torch.ops import ccf_chisq, cuda_build, spline_eval
    device = torch.device('cuda', 0)
    smi = chip_smoke.environment()
    chip_smoke.build_kernels()
    t0 = time.perf_counter()
    base, base_ptxas = build_baseline(args.baseline_csrc)
    chip_smoke.log(f'baseline build: {time.perf_counter() - t0:.2f} s')
    for name, text in base_ptxas.items():
        chip_smoke.log(f'  baseline {name}: ' + ' | '.join(
            line.strip() for line in text.splitlines()
            if 'registers' in line or 'spill' in line))
    tm, arms, truth, bank = chip_smoke.make_workload(device)
    rows = []
    coeffs, cases = chip_smoke.kernel_a_cases(tm, arms, truth, device)
    for mode, u, rpc in cases:
        def call(c, uu):
            return spline_eval.spline_eval_index(tm.geom, c, uu, rpc)

        def old_call(c, uu):
            return baseline_spline(base['spline_eval'], tm.geom, c, uu, rpc)
        plain = lambda: spline_eval.spline_eval_index_plain(tm.geom, coeffs,
                                                            u, rpc)
        errs = check_both(lambda: old_call(coeffs, u),
                          lambda: call(coeffs, u), plain, 1e-5)
        if rpc == 1:
            old, new = ab_times(chip_smoke.cold_inputs(old_call, coeffs, u),
                                chip_smoke.cold_inputs(call, coeffs, u),
                                graph=True)
        else:
            old, new = ab_times(lambda: old_call(coeffs, u),
                                lambda: call(coeffs, u))
        rows.append(dict(kernel='spline_eval', mode=mode,
                         shape=list(u.shape), baseline_ms=old, ms=new,
                         plain_ms=chip_smoke.cuda_time(plain, REPS['plain']),
                         library_ms=None, bound_kind='hbm_bytes',
                         bound_ms=chip_smoke.spline_bound_ms(
                             u, coeffs.shape[-1], rpc),
                         rel_err_baseline=errs[0], rel_err=errs[1]))
    if 'spline_eval_adjoint' in base:
        u, g, nm1 = chip_smoke.adjoint_inputs(tm, arms, truth, device)

        def call(uu, gg):
            return spline_eval.spline_eval_index_vjp(tm.geom, uu, gg, nm1)

        def old_call(uu, gg):
            return baseline_adjoint(base['spline_eval_adjoint'], tm.geom, uu,
                                    gg, nm1)
        plain = lambda: spline_eval.spline_eval_index_vjp_plain(tm.geom, u,
                                                                g, nm1)
        errs = check_both(lambda: old_call(u, g), lambda: call(u, g), plain,
                          1e-5)
        old, new = ab_times(chip_smoke.cold_inputs(old_call, u, g),
                            chip_smoke.cold_inputs(call, u, g), graph=True)
        rows.append(dict(kernel='spline_eval_adjoint', mode='per-row',
                         shape=[u.shape[0], u.shape[1], nm1],
                         baseline_ms=old, ms=new,
                         plain_ms=chip_smoke.cuda_time(plain, REPS['plain']),
                         library_ms=None, bound_kind='hbm_bytes',
                         bound_ms=chip_smoke.adjoint_bound_ms(u, nm1),
                         rel_err_baseline=errs[0], rel_err=errs[1]))
    banks = [('continuum', convert.ccf_bank(*bank, device=device)),
             ('no-continuum', chip_smoke.make_nocont_bank(device))]
    for mode, bank_d in banks:
        kargs, cont = chip_smoke.kernel_b_args(arms, bank_d)
        call = lambda: ccf_chisq.ccf_chisq(*kargs, continuum=cont)
        plain = lambda: ccf_chisq.ccf_chisq_plain(*kargs, continuum=cont)
        old_call = lambda: baseline_ccf(base['ccf_chisq'], kargs, cont)
        errs = check_both(old_call, call, plain, 1e-4)
        old, new = ab_times(old_call, call)
        library_ms = None
        if cont:
            ops, e = ccf_chisq.contraction_operands(*kargs, continuum=True)
            library_ms = chip_smoke.cuda_time(lambda: torch.matmul(ops[0], e),
                                              REPS['library'])
            del ops, e
        shape = [kargs[2].shape[0], kargs[0].shape[0], kargs[0].shape[1],
                 kargs[4].shape[1]]
        rows.append(dict(kernel='ccf_chisq', mode=mode, shape=shape,
                         baseline_ms=old, ms=new,
                         plain_ms=chip_smoke.cuda_time(plain, REPS['plain']),
                         library_ms=library_ms, bound_kind='tf32x3_flops',
                         bound_ms=chip_smoke.ccf_bound_ms(*shape,
                                                          1 if cont else 2),
                         rel_err_baseline=errs[0], rel_err=errs[1]))
    for r in rows:
        chip_smoke.log(
            f'{r["kernel"]} {r["mode"]} {r["shape"]}: baseline '
            f'{r["baseline_ms"]:.4f} ms, current {r["ms"]:.4f} ms, plain '
            f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]}, bound '
            f'{r["bound_ms"]:.4f} ms ({r["bound_kind"]}): current at '
            f'{100 * r["bound_ms"] / r["ms"]:.1f}% of the bound')
    print(json.dumps(dict(card=smi, ptxas={
        **{k: v['ptxas'] for k, v in cuda_build.build_log.items()},
        **{f'baseline_{k}': v for k, v in base_ptxas.items()}},
        kernels=rows)))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as exc:
        print(f'torch_kernel_ab: FAILED: {exc}', file=sys.stderr)
        sys.exit(1)
