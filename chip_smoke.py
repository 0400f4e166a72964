#!/usr/bin/env python3
"""Drive the rvspecfit_torch fit slice on one CUDA card and check it.

Usage (from the root of a checkout, on a machine with one NVIDIA card
and the CUDA toolkit):

    python3 chip_smoke.py

1. Builds both CUDA kernels from rvspecfit_torch/csrc with nvcc
   (sm_90a) into rvspecfit_torch/_build/.
2. Compares each kernel with its plain PyTorch version on the card at
   the main path's shapes (kernel B in both its modes), and times both
   with CUDA events beside the least time the card could take for the
   work (bound_ms) and, for kernel B, one fp32 torch.matmul of its
   materialized contraction (library_ms, a yardstick the port never
   calls).
3. Drives the fit slice of bench.py's workload through the port's
   entry points: a synthetic 500-fiber, 3-arm exposure -> batched CCF
   first guess (kernel B) -> batched Nelder-Mead (kernel A) ->
   velocity refinement (kernel A, shared mode) -> best-fit models; a
   cold pass, then a timed warm pass whose kernel launches are
   counted.
4. Checks RV recovery against the injected velocities, and the slice
   on 8 fibers against the CPU float64 run of the same code.

Prints, last, a JSON line of the kernels and then the ok line.  Exits
non-zero, printing no result, without a CUDA device or on any failure.
"""
import contextlib
import itertools
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

NFIBERS = 500
NPIX_ARM = 1024
CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2)
START = dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5)


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_time(fn, reps, graph=False):
    """Mean ms per call of fn() on the card, after one warm-up call.

    Eager calls time the host's dispatch too where it is slower than
    the device; ``graph=True`` captures ``reps`` calls in a CUDA graph
    (each output in memory of its own) and replays it 10 times, which
    times the device alone (for launches of a few microseconds).
    """
    import torch
    fn()
    torch.cuda.synchronize()
    run, calls = fn, reps
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            kept = [fn() for _ in range(reps)]  # noqa: F841
        g.replay()
        torch.cuda.synchronize()
        run, calls = g.replay, 10
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (calls * (reps if graph else 1))


def environment():
    import torch
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    from rvspecfit_torch.ops import cuda_build
    nvcc = subprocess.run([cuda_build.nvcc_path(), '--version'],
                          capture_output=True, text=True, check=True)
    try:
        import triton
        triton_state = f'imports ({triton.__version__})'
    except ImportError:
        triton_state = 'does not import'
    log(f'card: {smi[0]}')
    log(f'torch {torch.__version__}, torch.version.cuda '
        f'{torch.version.cuda}, nvcc: {nvcc.stdout.strip().splitlines()[-1]}'
        f', triton {triton_state}')
    log(f'device: {torch.cuda.get_device_name(0)}, count '
        f'{torch.cuda.device_count()}')
    return smi[0]


def build_kernels():
    from rvspecfit_torch.ops import ccf_chisq, cuda_build, spline_eval
    t0 = time.perf_counter()
    spline_eval.build()
    ccf_chisq.build()
    log(f'kernel build: {time.perf_counter() - t0:.2f} s')
    for name, info in cuda_build.build_log.items():
        log(f'  {name}: nvcc {info["seconds"]:.2f} s; ptxas: '
            + ' | '.join(line.strip() for line in info['ptxas'].splitlines()
                         if 'registers' in line or 'spill' in line))


# L2 of one H100 is 50 MB: a timing that must read its inputs from HBM
# cycles through this many copies of them (at least ~4 L2s in all)
L2_COPIES = 16


def cold_inputs(call, *tensors):
    """A function of no arguments that runs call(*copy) on the next of
    L2_COPIES copies of ``tensors`` in turn: timed over 2 L2_COPIES
    calls, each call finds its inputs evicted from L2."""
    copies = itertools.cycle([tuple(t.clone() for t in tensors)
                              for _ in range(L2_COPIES)])
    return lambda: call(*next(copies))


def make_arms():
    """The 500-fiber, 3-arm exposure: ([BatchArm], truth)."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit.batch import BatchArm
    arms_data, truth = simulation.make_exposure(NFIBERS, npix_arm=NPIX_ARM,
                                                snr=50.0, seed=7)
    return ([BatchArm(n, lam, fl, iv) for n, (lam, fl, iv)
             in arms_data.items()], truth)


def make_bank(continuum=True):
    """The CCF bank as numpy (tfft, t2fft, info).  It is an offline
    artifact: built in float64 on the CPU, as the reference's pipeline
    builds it, then moved to a device by convert.ccf_bank."""
    from rvspecfit_torch import simulation
    return simulation.build_ccf_bank(6, 6, 6, 4, npix=4096, lam0=4550.0,
                                     lam1=5450.0, every=8,
                                     continuum=continuum, device='cpu')


def make_workload(device):
    from rvspecfit_torch import simulation
    t0 = time.perf_counter()
    tm = simulation.build_template_model(6, 6, 6, 4, npix=4096, lam0=4550.0,
                                         lam1=5450.0, device=device)
    arms, truth = make_arms()
    bank = make_bank()
    log(f'workload: {NFIBERS} fibers x {len(arms)} arms x {NPIX_ARM} px, '
        f'{tm.state.dats.shape[0]} templates x {tm.geom.n} px, CCF bank '
        f'{bank[0].shape[0]} x {bank[0].shape[1]} frequencies '
        f'({time.perf_counter() - t0:.1f} s)')
    return tm, arms, truth, bank


# peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s and
# TF32 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12


def spline_bound_ms(u, nm1, rpc):
    """Least time of kernel A's work on these inputs from HBM: u read
    and out written once, plus the 16 B of (A, B, C, D) of every
    distinct interval each coefficient row's queries touch."""
    import torch
    idx = torch.clamp(torch.floor(torch.nan_to_num(u)), 0, nm1 - 1)
    idx = idx.reshape(-1, rpc * u.shape[1]).sort(1).values
    knots = float((idx.diff(dim=1) != 0).sum()) + idx.shape[0]
    nbytes = 2 * 4 * u.numel() + 16 * knots
    return 1e3 * nbytes / HBM_BYTES_PER_S


def ccf_bound_ms(nb, nt, nf, nv, naccumulators):
    """Least time of kernel B's work: its GEMM (M = B T, N = V, K = 2F,
    one per accumulator) issued three times (3xTF32) at the TF32 peak,
    against the bytes of its inputs and output."""
    flops = 3 * naccumulators * 2.0 * nb * nt * nv * 2 * nf
    nbytes = 8 * 2 * (nt + nb) * nf + 4 * 2 * nf * nv + 4 * nb * nt * nv
    return 1e3 * max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def compare(got, want):
    """(max|got - want|, max|want|) after a synchronize."""
    import torch
    torch.cuda.synchronize()
    return (float((got - want).abs().max()), float(want.abs().max()))


def make_nocont_bank(device):
    """A bank without continuum normalization from the same grid, on
    ``device``."""
    from rvspecfit_torch import convert
    return convert.ccf_bank(*make_bank(continuum=False), device=device)


def kernel_a_cases(tm, arms, truth, device):
    """Kernel A's inputs at the NM-step shape (one trial per fiber) and
    the refinement's full-pass shape (401 shared rows per fiber):
    (coeffs, [(mode, u, rows_per_coeff), ...])."""
    import torch
    from rvspecfit_torch.fit.likelihood import doppler_u, template_stage
    from rvspecfit_torch.fit.spec_data import ArmState
    arm = ArmState.from_host('B', 'B', arms[0].lam, arms[0].flux,
                             1.0 / np.sqrt(arms[0].ivar), tm.geom,
                             device=device)
    params = torch.as_tensor(np.stack([truth[k] for k in
                                       ('teff', 'logg', 'feh', 'alpha')], 1),
                             dtype=torch.float32, device=device)
    coeffs = template_stage(tm, params, None, False, None)[0]
    vels = torch.as_tensor(truth['vel'], dtype=torch.float32, device=device)
    u_row = doppler_u(arm, tm.geom, vels)                       # (500, 1024)
    grid = torch.linspace(-1000, 1000, 401, device=device)
    u_shared = doppler_u(arm, tm.geom, grid.repeat(NFIBERS))  # (200500, 1024)
    return coeffs, [('per-row', u_row, 1), ('shared', u_shared, 401)]


def check_kernel_a(tm, arms, truth, device):
    """Kernel A vs plain on the card at both of the path's shapes.

    Both modes are timed with inputs read from HBM, as the bound
    assumes: the shared mode's 820 MB of u exceed L2; the per-row mode
    (4 us) is timed from CUDA-graph replays over L2_COPIES copies of
    its inputs, and also eagerly, one call at a time (the host's
    dispatch, as the path launches it)."""
    from rvspecfit_torch.ops import spline_eval
    coeffs, cases = kernel_a_cases(tm, arms, truth, device)
    result = {}
    for mode, u, rpc in cases:
        def call(c, uu):
            return spline_eval.spline_eval_index(tm.geom, c, uu, rpc)
        err, scale = compare(
            call(coeffs, u),
            spline_eval.spline_eval_index_plain(tm.geom, coeffs, u, rpc))
        eager_ms = cuda_time(lambda: call(coeffs, u), 20)
        ms = eager_ms if rpc > 1 else cuda_time(
            cold_inputs(call, coeffs, u), 2 * L2_COPIES, graph=True)
        plain_ms = cuda_time(lambda: spline_eval.spline_eval_index_plain(
            tm.geom, coeffs, u, rpc), 5)
        bound = spline_bound_ms(u, coeffs.shape[-1], rpc)
        log(f'kernel A {mode}: rows {u.shape[0]} x {u.shape[1]} px, '
            f'coeffs {tuple(coeffs.shape)}: max|diff| {err:.3e} '
            f'(limit 1e-5 x max|out| = {1e-5 * scale:.3e}); kernel '
            f'{ms:.4f} ms (eager {eager_ms:.4f} ms), plain {plain_ms:.4f} '
            f'ms, bound {bound:.4f} ms (HBM bytes) -> '
            f'{100 * bound / ms:.1f}% of it')
        check(np.isfinite(err) and err <= 1e-5 * scale,
              f'kernel A ({mode}) disagrees with its plain version')
        check(ms >= bound, f'kernel A ({mode}) ran under its bound: the '
              'bound or the timing is wrong')
        result[mode] = dict(max_abs_err=err, ms=ms, eager_ms=eager_ms,
                            plain_ms=plain_ms, bound_ms=bound)
    return result


def kernel_b_args(arms, bank):
    """Kernel B's inputs for the first arm of the exposure against a
    device bank: (args, continuum)."""
    from rvspecfit_torch.fit import ccf
    a = arms[0]
    p = ccf.prepare_arm_batch(a.name, a.lam, a.flux, 1.0 / np.sqrt(a.ivar),
                              None, CONFIG, bank)
    return [p['tfft'], p['t2fft'], p['sfft_conj'], p['ivfft_conj'],
            p['ecos'], p['esin']], p['continuum']


def check_kernel_b(arms, bank_d, bank_nocont_d, device):
    """Kernel B vs plain at the full exposure (500 fibers, one arm) in
    the path's continuum mode and, from a bank without continuum built
    from the same grid, in no-continuum mode; times both, and the
    continuum contraction as one fp32 torch.matmul (library_ms)."""
    import torch
    from rvspecfit_torch.ops import ccf_chisq
    result = {}
    for mode, bank in (('continuum', bank_d), ('no-continuum', bank_nocont_d)):
        args, cont = kernel_b_args(arms, bank)
        check(cont == (mode == 'continuum'),
              f'the {mode} bank has continuum={cont}')
        err, scale = compare(ccf_chisq.ccf_chisq(*args, continuum=cont),
                             ccf_chisq.ccf_chisq_plain(*args, continuum=cont))
        ms = cuda_time(lambda: ccf_chisq.ccf_chisq(*args, continuum=cont), 10)
        plain_ms = cuda_time(lambda: ccf_chisq.ccf_chisq_plain(
            *args, continuum=cont), 3)
        shape = (args[2].shape[0], args[0].shape[0], args[0].shape[1],
                 args[4].shape[1])
        bound = ccf_bound_ms(*shape, 1 if cont else 2)
        library_ms = None
        if cont:
            ops, e = ccf_chisq.contraction_operands(*args, continuum=True)
            library_ms = cuda_time(lambda: torch.matmul(ops[0], e), 5)
            del ops, e
        log(f'kernel B {mode}: at B,T,F,V = {shape}: max|diff| {err:.3e}, '
            f'{err / scale:.3e} of max|out| (limit 1e-4); kernel '
            f'{ms:.3f} ms, plain {plain_ms:.3f} ms, library '
            f'{library_ms if library_ms is None else round(library_ms, 3)}'
            f' ms, bound {bound:.3f} ms (3xTF32 FLOP) -> '
            f'{100 * bound / ms:.1f}% of it')
        check(np.isfinite(err) and err <= 1e-4 * scale,
              f'kernel B ({mode}) disagrees with its plain version')
        result[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, library_ms=library_ms)
    return result


def run_slice(bf, mapper, arms, banks, sync, x0=None):
    """CCF -> Nelder-Mead -> refinement -> models; per-phase seconds.
    ``x0`` replaces the CCF's starts of Nelder-Mead."""
    from rvspecfit_torch.fit import ccf
    t = [time.perf_counter()]

    def mark():
        sync()
        t.append(time.perf_counter())

    with np.errstate(divide='ignore'):
        cres = ccf.fit_batch(
            [(a.name, a.lam, a.flux,
              1.0 / np.sqrt(np.maximum(a.ivar, 1e-30)), None) for a in arms],
            CONFIG, banks)
    mark()
    if x0 is None:
        x0 = np.concatenate([cres['best_vel'][:, None],
                             cres['best_params']], axis=1)
    nmres = bf.run_neldermead(mapper, x0=x0)
    mark()
    vel_b, params_b, _ = mapper.unpack_host(nmres['x'])
    ref = bf.refine_velocities(vel_b, params_b)
    mark()
    mods = bf.best_models(ref['best_vel'], params_b)
    mark()
    phases = dict(zip(('ccf', 'nm', 'refine', 'models'), np.diff(t)))
    return dict(ccf=cres, x0=x0, nm=nmres, ref=ref, models=mods,
                phases=phases)


def make_fitter(tm, arms):
    from rvspecfit_torch.fit.batch import BatchedFitter
    from rvspecfit_torch.fit.vel_fit import ParamMapper
    bf = BatchedFitter(arms, {a.name: tm for a in arms}, CONFIG,
                       options={'npoly': 10})
    return bf, ParamMapper(tm.parnames, START, [], None, False)


def check_outputs(out, nfib, npix):
    for key in ('best_vel', 'vel_err'):
        check(out['ref'][key].shape == (nfib,)
              and np.isfinite(out['ref'][key]).all(),
              f'refinement {key}: non-finite or wrong shape')
    for name, m in out['models']['models'].items():
        check(m.shape == (nfib, npix) and np.isfinite(m).all(),
              f'model of arm {name}: non-finite or wrong shape')


@contextlib.contextmanager
def plain_versions():
    """The slice's calls of both kernels run their plain versions
    instead (a witness run: it launches no kernel)."""
    from rvspecfit_torch.fit import batch, likelihood
    from rvspecfit_torch.ops import ccf_chisq, spline_eval
    plain = spline_eval.spline_eval_index_plain
    with mock.patch.object(likelihood, 'spline_eval_index', plain), \
            mock.patch.object(batch, 'spline_eval_index', plain), \
            mock.patch.object(ccf_chisq, 'ccf_chisq',
                              ccf_chisq.ccf_chisq_plain):
        yield


def check_against_cpu(tm, arms, bank, device):
    """The slice on 8 fibers: CUDA float32 (kernels) against the CPU
    float64 run of the plain versions.  A witness beside it: the CUDA
    float32 slice with the plain versions in place of the kernels, from
    the kernel run's Nelder-Mead starts, tells float32 arithmetic from a
    kernel at fault."""
    import torch
    from rvspecfit_torch import convert, simulation
    from rvspecfit_torch.fit.batch import BatchArm
    from rvspecfit_torch.ops import ccf_chisq, spline_eval
    cpu = torch.device('cpu')
    sub = [BatchArm(a.name, a.lam, a.flux[:8], a.ivar[:8]) for a in arms]
    tm_cpu = simulation.build_template_model(6, 6, 6, 4, npix=4096,
                                             lam0=4550.0, lam1=5450.0,
                                             device=cpu)
    small, fitters = {}, {}
    for dev, tm_d in ((device, tm), (cpu, tm_cpu)):
        banks_d = {a.name: convert.ccf_bank(*bank, device=dev) for a in sub}
        bf_d, mapper_d = make_fitter(tm_d, sub)
        fitters[dev.type] = (bf_d, mapper_d, banks_d)
        small[dev.type] = run_slice(bf_d, mapper_d, sub, banks_d,
                                    torch.cuda.synchronize)
    bf_g, mapper_g, banks_g = fitters['cuda']
    counts = (spline_eval.launches, ccf_chisq.launches)
    with plain_versions():
        plain32 = run_slice(bf_g, mapper_g, sub, banks_g,
                            torch.cuda.synchronize, x0=small['cuda']['x0'])
    check(counts == (spline_eval.launches, ccf_chisq.launches),
          'the witness run launched a kernel')
    vg, vc = small['cuda']['ref']['best_vel'], small['cpu']['ref']['best_vel']
    vp = plain32['ref']['best_vel']
    lim = np.maximum(1.0, 0.5 * small['cpu']['ref']['vel_err'])
    same_id = (small['cuda']['ccf']['best_id']
               == small['cpu']['ccf']['best_id']).sum()
    log(f'8-fiber slice, CUDA float32 vs CPU float64: max|dv| '
        f'{np.abs(vg - vc).max():.4f} km/s (limit max(1, 0.5 sigma)); '
        f'same CCF template {int(same_id)}/8')
    for i in range(len(vc)):
        log(f'  fiber {i}: CPU float64 {vc[i]:.4f} km/s; CUDA float32 '
            f'kernels {vg[i]:.4f} (|dv| {abs(vg[i] - vc[i]):.4f}, limit '
            f'{lim[i]:.4f}); CUDA float32 plain versions from the same '
            f'starts {vp[i]:.4f} (|dv| {abs(vp[i] - vc[i]):.4f})')
    check((np.abs(vg - vc) <= lim).all(),
          'the CUDA slice disagrees with the CPU float64 slice')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this '
              'script runs only on a CUDA card', file=sys.stderr)
        return 2
    try:
        from rvspecfit_torch import convert
        from rvspecfit_torch.ops import ccf_chisq, spline_eval
    except ImportError as exc:
        print(f'chip_smoke: rvspecfit_torch is not importable ({exc}); '
              'run from the root of a checkout', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    smi = environment()
    build_kernels()
    tm, arms, truth, bank = make_workload(device)
    banks = {a.name: convert.ccf_bank(*bank, device=device) for a in arms}
    res_a = check_kernel_a(tm, arms, truth, device)
    bank_nocont = make_nocont_bank(device)
    res_b = check_kernel_b(arms, banks[arms[0].name], bank_nocont, device)

    bf, mapper = make_fitter(tm, arms)
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    run_slice(bf, mapper, arms, banks, sync)
    log(f'slice cold pass: {time.perf_counter() - t0:.2f} s')
    spline_eval.launches = 0
    ccf_chisq.launches = 0
    out = run_slice(bf, mapper, arms, banks, sync)
    counts = dict(spline_eval=spline_eval.launches,
                  ccf_chisq=ccf_chisq.launches)
    total = sum(out['phases'].values())
    log('slice warm pass: ' + ' '.join(
        f'{k}={v:.3f}s' for k, v in out['phases'].items())
        + f' total={total:.3f}s -> {NFIBERS / total:.1f} fibers/s')
    log(f'NM: {int(out["nm"]["converged"].sum())}/{NFIBERS} converged, '
        f'{out["nm"]["obj_evals"]} objective trials; refinement passes '
        f'{int(out["ref"]["iterations"][0])}')
    log(f'kernel launches in the warm pass: {counts}')
    check(all(v > 0 for v in counts.values()),
          f'a kernel of the slice was not launched: {counts}')
    check_outputs(out, NFIBERS, NPIX_ARM)

    dv = out['ref']['best_vel'] - truth['vel']
    ok = np.abs(dv) < np.maximum(10.0, 5 * out['ref']['vel_err'])
    log(f'RV recovery: {int(ok.sum())}/{NFIBERS} within max(10, 5 sigma); '
        f'median |dv| {np.median(np.abs(dv)):.3f} km/s, median sigma_v '
        f'{np.median(out["ref"]["vel_err"]):.3f} km/s')
    check(ok.sum() >= 490, 'RV recovery below 490/500')

    check_against_cpu(tm, arms, bank, device)

    check('jax' not in sys.modules and 'rvspecfit_tpu' not in sys.modules,
          'the run imported jax or the JAX package')
    shared, row = res_a['shared'], res_a['per-row']
    cont, nocont = res_b['continuum'], res_b['no-continuum']
    kernels = [
        dict(name='spline_eval', route='cuda',
             source='rvspecfit_torch/csrc/spline_eval.cu',
             replaces='rvspecfit_tpu/ops/pallas_spline.py:200',
             launches=counts['spline_eval'],
             max_abs_err=max(r['max_abs_err'] for r in res_a.values()),
             ms=shared['ms'], plain_ms=shared['plain_ms'],
             bound_ms=shared['bound_ms'], bound_by='bytes',
             bound_kind='hbm_bytes', library_ms=None,
             ms_per_row_mode=row['ms'],
             ms_per_row_mode_eager=row['eager_ms'],
             plain_ms_per_row_mode=row['plain_ms'],
             bound_ms_per_row_mode=row['bound_ms']),
        dict(name='ccf_chisq', route='cuda',
             source='rvspecfit_torch/csrc/ccf_chisq.cu',
             replaces='rvspecfit_tpu/ops/pallas_ccf.py:159',
             launches=counts['ccf_chisq'],
             max_abs_err=cont['max_abs_err'], ms=cont['ms'],
             plain_ms=cont['plain_ms'], bound_ms=cont['bound_ms'],
             bound_by='operations', bound_kind='tf32x3_flops',
             library_ms=cont['library_ms'],
             max_abs_err_no_continuum=nocont['max_abs_err'],
             ms_no_continuum=nocont['ms'],
             plain_ms_no_continuum=nocont['plain_ms'],
             bound_ms_no_continuum=nocont['bound_ms']),
    ]
    print(smi)
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps(dict(ok=True, device=dict(
        platform='gpu', kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f'chip_smoke: FAILED: {exc}', file=sys.stderr)
        sys.exit(1)
