#!/usr/bin/env python3
"""Drive the rvspecfit_torch group fit, DESI and WEAVE drivers and the
single-object fit on one CUDA card and check them.

Usage (from the root of a checkout, on a machine with one NVIDIA card
and the CUDA toolkit):

    python3 chip_smoke.py

1. Builds the CUDA kernels from rvspecfit_torch/csrc with nvcc
   (sm_90a, one nvcc per source, all started together) into
   rvspecfit_torch/_build/.
2. Compares each kernel with its plain PyTorch version on the card at
   the main path's shapes (kernel A in both modes, its adjoint at the
   polish's shape, kernel B in both modes), and times both with CUDA
   events beside the least time the card could take for the work
   (bound_ms) and, for kernel B, one fp32 torch.matmul of its
   materialized contraction (library_ms, a yardstick the port never
   calls).
3. Drives survey/desi._run_group_fit on bench.py's workload: a
   synthetic 500-fiber, 3-arm exposure against the 864-template grid
   (built through pipeline/library.template_model_from_artifacts) ->
   batched CCF first guess (kernel B) -> Nelder-Mead (kernel A) ->
   gradient polish (kernel A and its adjoint, AD Hessians) -> velocity
   refinement (kernel A, shared mode) -> AD Hessian errors -> best-fit
   models; a cold pass, then a timed warm pass whose kernel launches
   are counted (kernel A's per mode and in all).
4. Checks RV recovery against the injected velocities, that the polish
   raised no fiber's objective, and the group fit on 8 fibers
   (velocities, polished parameters, errors) against the CPU float64
   run of the same code.
5. Drives the DESI driver, survey/desi.proc_many, over 4 coadd files of
   500 fibers in bench.py's format, written with the port's FITS module
   into a temporary directory, at coalesce 2 (two groups of 1000
   fibers, the first cold) with crash isolation off and in-memory
   models and banks (the card's machine has no h5py); its kernel
   launches are counted per run and per group.  Checks the status
   lines, the RVTAB schema and rows, RV recovery per file and RVMOD;
   prints per-file seconds, the steady fibers/s from the status file's
   completion times and each group's phases.  Then holds the three
   kernels against their plain versions at a 1000-fiber group's shapes,
   and the driver's RVTAB on the card against the CPU float64 run for
   an 8-fiber coadd and a 64-fiber coadd with per-fiber resolution
   matrices (--resolution_matrix, width-11 Gaussian bands).  Beside
   each, witnesses of the Nelder-Mead's end points: the plain versions
   in float32, and in float64 on the card from the card's and from the
   CPU's CCF starts (ROADMAP C.1).
6. The single-object fit on 8 objects of the 3-arm layout at full
   width: fit/ccf.fit (kernel B at one fiber row) -> vel_fit.process
   (scan, float64-bookkept Nelder-Mead, BFGS with the autograd
   gradient, refinement, models, AD Hessian: kernel A in both modes
   and its adjoint), firstguess on 2 of them and one process with a
   Gaussian resolution matrix per arm; kernel B timed at B = 1.  Checks
   RV recovery, every kernel launched, and the card against the CPU
   float64 run of the same calls; prints seconds per call and stage,
   BFGS calls and launches per call.
7. The WEAVE driver, survey/weave.proc_many, over a 500-fiber red +
   blue pair (two 1024-px arms inside the synthetic grid's range):
   status line, WEAVE_RV columns, RV recovery, fibers/s; an 8-fiber
   pair on the card against the CPU.
8. The DESI driver with ``--param_init bruteforce`` (ccf_init=False) on
   an 8-fiber coadd: RVTAB schema and RV recovery.

Every path's kernel launches are counted from 0 just before it runs.
Prints, last, the card, a JSON line of the kernels and then the ok
line.  Exits non-zero, printing no result, without a CUDA device or on
any failure.
"""
import concurrent.futures
import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

NFIBERS = 500
NPIX_ARM = 1024
CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2, second_minimizer=True)
OPTIONS = {'npoly': 10}
START = dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5)
PHASES = ('ccf', 'nm', 'polish', 'refine', 'hessian', 'models')


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
    with concurrent.futures.ThreadPoolExecutor() as ex:
        list(ex.map(cuda_build.load, ('spline_eval', 'ccf_chisq')))
    spline_eval.build()
    spline_eval.build_adjoint()
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


def make_template_model(device, wresol=2.0, dtype=None):
    """The 864-template grid at 4096 px with lines broadened by a
    Gaussian of ``wresol`` A, through the library's artifact path (a
    regular-grid library's arrays, made in memory); ``dtype`` overrides
    the device's working dtype (float64 on the card for a witness)."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.pipeline.library import \
        template_model_from_artifacts
    return template_model_from_artifacts(
        *simulation.template_artifacts(6, 6, 6, 4, npix=4096, lam0=4550.0,
                                       lam1=5450.0, wresol=wresol),
        device=device, dtype=dtype)


def make_workload(device):
    t0 = time.perf_counter()
    tm = make_template_model(device)
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


def ccf_bound(nb, nt, nf, nv, naccumulators):
    """Least time of kernel B's work and what bounds it: its GEMM (M =
    B T, N = V, K = 2F, one per accumulator) issued three times
    (3xTF32) at the TF32 peak, against the bytes of its inputs and
    output.  Returns (ms, 'operations' or 'bytes')."""
    flops = 3 * naccumulators * 2.0 * nb * nt * nv * 2 * nf
    nbytes = 8 * 2 * (nt + nb) * nf + 4 * 2 * nf * nv + 4 * nb * nt * nv
    t_ops, t_bytes = flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def ccf_bound_ms(nb, nt, nf, nv, naccumulators):
    return ccf_bound(nb, nt, nf, nv, naccumulators)[0]


def compare(got, want):
    """(max|got - want|, max|want|) after a synchronize."""
    import torch
    torch.cuda.synchronize()
    return (float((got - want).abs().max()), float(want.abs().max()))


def adjoint_bound_ms(u, nm1):
    """Least time of the adjoint's work from HBM: u and g read once and
    the dense (R, 4, nm1) float32 output written once."""
    return 1e3 * (2 * 4 * u.numel() + 16 * u.shape[0] * nm1) \
        / HBM_BYTES_PER_S


def make_nocont_bank(device):
    """A bank without continuum normalization from the same grid, on
    ``device``."""
    from rvspecfit_torch import convert
    return convert.ccf_bank(*make_bank(continuum=False), device=device)


def kernel_a_cases(tm, arms, truth, device):
    """Kernel A's inputs at the NM-step shape (one trial per fiber) and
    the refinement's full-pass shape (401 shared rows per fiber), for
    the B fibers of ``arms``: (coeffs, [(mode, u, rows_per_coeff),
    ...])."""
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
    u_row = doppler_u(arm, tm.geom, vels)                       # (B, 1024)
    grid = torch.linspace(-1000, 1000, 401, device=device)
    # (401 B, 1024)
    u_shared = doppler_u(arm, tm.geom, grid.repeat(arm.dvec.shape[0]))
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
                              a.badmask, CONFIG, bank)
    return [p['tfft'], p['t2fft'], p['sfft_conj'], p['ivfft_conj'],
            p['ecos'], p['esin']], p['continuum']


def check_kernel_b(arms, banks, device):
    """Kernel B vs plain on the first arm of ``arms`` (all its fibers)
    with each of ``banks`` ({mode: device bank}; the path's continuum
    mode and, from a bank without continuum built from the same grid,
    the no-continuum mode); see kernel_b_case."""
    result = {}
    for mode, bank in banks.items():
        args, cont = kernel_b_args(arms, bank)
        check(cont == (mode == 'continuum'),
              f'the {mode} bank has continuum={cont}')
        result[mode] = kernel_b_case(args, cont, f'kernel B {mode}')
    return result


def kernel_b_case(args, cont, label, graph=False):
    """Kernel B's wrapper vs its plain version on ``args``, both timed,
    and the continuum contraction as one fp32 torch.matmul
    (library_ms).  ``graph``: time the wrapper from CUDA-graph replays
    over L2_COPIES copies of its inputs (calls of a few microseconds,
    inputs from HBM), beside the eager time."""
    import torch
    from rvspecfit_torch.ops import ccf_chisq

    def call(*a):
        return ccf_chisq.ccf_chisq(*a, continuum=cont)
    err, scale = compare(call(*args),
                         ccf_chisq.ccf_chisq_plain(*args, continuum=cont))
    eager_ms = cuda_time(lambda: call(*args), 10)
    ms = cuda_time(cold_inputs(call, *args), 2 * L2_COPIES, graph=True) \
        if graph else eager_ms
    plain_ms = cuda_time(lambda: ccf_chisq.ccf_chisq_plain(
        *args, continuum=cont), 3)
    shape = (args[2].shape[0], args[0].shape[0], args[0].shape[1],
             args[4].shape[1])
    bound, bound_by = ccf_bound(*shape, 1 if cont else 2)
    library_ms = None
    if cont:
        ops, e = ccf_chisq.contraction_operands(*args, continuum=True)
        library_ms = cuda_time(lambda: torch.matmul(ops[0], e), 5)
        del ops, e
    log(f'{label}: at B,T,F,V = {shape}: max|diff| {err:.3e}, '
        f'{err / scale:.3e} of max|out| (limit 1e-4); kernel '
        f'{ms:.4f} ms (eager {eager_ms:.4f} ms), plain {plain_ms:.3f} ms, '
        f'library '
        f'{library_ms if library_ms is None else round(library_ms, 4)}'
        f' ms, bound {bound:.4f} ms ({bound_by}) -> '
        f'{100 * bound / ms:.1f}% of it')
    check(np.isfinite(err) and err <= 1e-4 * scale,
          f'{label} disagrees with its plain version')
    return dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=library_ms)


def adjoint_inputs(tm, arms, truth, device):
    """The adjoint's inputs at the polish's shape (one row per fiber,
    500 x 1024 queries on 4095 intervals): (u, g, nm1), g a seeded
    upstream gradient."""
    import torch
    coeffs, cases = kernel_a_cases(tm, arms, truth, device)
    u = cases[0][1]
    g = torch.as_tensor(np.random.RandomState(1).normal(size=u.shape),
                        dtype=torch.float32, device=device)
    return u, g, coeffs.shape[-1]


def check_adjoint(tm, arms, truth, device):
    """Kernel A's adjoint vs its plain version at the polish's shape
    with a seeded upstream gradient (adjoint_inputs); timed from HBM
    (CUDA-graph replays over L2_COPIES copies of its inputs) and
    eagerly; two launches must give the same bits."""
    import torch
    from rvspecfit_torch.ops import spline_eval
    u, g, nm1 = adjoint_inputs(tm, arms, truth, device)

    def call(uu, gg):
        return spline_eval.spline_eval_index_vjp(tm.geom, uu, gg, nm1)
    got = call(u, g)
    err, scale = compare(got, spline_eval.spline_eval_index_vjp_plain(
        tm.geom, u, g, nm1))
    check(torch.equal(got, call(u, g)),
          'the adjoint gave other bits on a second launch')
    ms = cuda_time(cold_inputs(call, u, g), 2 * L2_COPIES, graph=True)
    eager_ms = cuda_time(lambda: call(u, g), 20)
    plain_ms = cuda_time(lambda: spline_eval.spline_eval_index_vjp_plain(
        tm.geom, u, g, nm1), 5)
    bound = adjoint_bound_ms(u, nm1)
    log(f'adjoint: rows {u.shape[0]} x {u.shape[1]} px -> (R, 4, {nm1}): '
        f'max|diff| {err:.3e} (limit 1e-5 x max|out| = {1e-5 * scale:.3e});'
        f' kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), plain '
        f'{plain_ms:.4f} ms, bound {bound:.4f} ms (HBM bytes) -> '
        f'{100 * bound / ms:.1f}% of it; bit-equal on relaunch')
    check(np.isfinite(err) and err <= 1e-5 * scale,
          'the adjoint disagrees with its plain version')
    check(ms >= bound, 'the adjoint ran under its bound: the bound or '
          'the timing is wrong')
    return dict(max_abs_err=err, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, bound_ms=bound)


def run_group_fit(tm, arms, banks):
    """The port's main path: survey/desi._run_group_fit on the exposure
    (all arms share the template model and the bank)."""
    from rvspecfit_torch.survey import desi
    return desi._run_group_fit(arms, {a.name: tm for a in arms}, CONFIG,
                               OPTIONS, banks=banks)


def check_outputs(out, nfib, npix):
    for key in ('best_vel', 'vel_err'):
        check(out['ref'][key].shape == (nfib,)
              and np.isfinite(out['ref'][key]).all(),
              f'refinement {key}: non-finite or wrong shape')
    check(out['errs'].shape == (nfib, 4)
          and np.isfinite(out['errs'][~out['bad_hess']]).all(),
          'Hessian errors: wrong shape or non-finite on a good Hessian')
    for name, m in out['mods']['models'].items():
        check(m.shape == (nfib, npix) and np.isfinite(m).all(),
              f'model of arm {name}: non-finite or wrong shape')
    worse = out['fun'] > out['nm']['fun']
    check(not worse.any(), f'the polish raised the objective of '
          f'{int(worse.sum())} fibers')


def kernel_counts():
    from rvspecfit_torch.ops import ccf_chisq, spline_eval
    return dict(spline_eval=spline_eval.launches,
                spline_eval_per_row=spline_eval.row_launches,
                spline_eval_shared=spline_eval.shared_launches,
                ccf_chisq=ccf_chisq.launches,
                spline_eval_adjoint=spline_eval.adjoint_launches)


def reset_counts():
    from rvspecfit_torch.ops import ccf_chisq, spline_eval
    spline_eval.launches = spline_eval.adjoint_launches = 0
    spline_eval.row_launches = spline_eval.shared_launches = 0
    ccf_chisq.launches = 0


@contextlib.contextmanager
def plain_versions():
    """The path's calls of the kernels run their plain versions instead
    (a witness run: it launches no kernel; the polish and the Hessian
    differentiate the plain evaluation)."""
    from rvspecfit_torch.fit import likelihood
    from rvspecfit_torch.ops import ccf_chisq, spline_eval
    plain = spline_eval.spline_eval_index_plain
    with mock.patch.object(likelihood, 'spline_eval_index', plain), \
            mock.patch.object(ccf_chisq, 'ccf_chisq',
                              ccf_chisq.ccf_chisq_plain):
        yield


@contextlib.contextmanager
def ccf_result(record=None, replay=None):
    """Record the group fit's CCF result into the list ``record``, or
    hand it ``replay`` in place of running the CCF."""
    from rvspecfit_torch.fit import ccf
    from rvspecfit_torch.survey import desi
    real = ccf.fit_batch

    def fit_batch(*args, **kwargs):
        if replay is not None:
            return replay
        record.append(real(*args, **kwargs))
        return record[-1]
    with mock.patch.object(desi.ccf_mod, 'fit_batch', fit_batch):
        yield


def check_against_cpu(arms, bank, device, tm):
    """The group fit on 8 fibers: CUDA float32 (kernels) against the
    CPU float64 run of the plain versions, for the velocities and the
    polished parameters, and the Hessian errors at one point (see
    hessians_at_one_point).  A witness beside it:
    the CUDA float32 fit with the plain versions in place of the
    kernels, from the kernel run's CCF result (so from the same NM
    starts), tells float32 arithmetic from a kernel at fault."""
    import torch
    from rvspecfit_torch import convert
    from rvspecfit_torch.fit.batch import BatchArm
    cpu = torch.device('cpu')
    sub = [BatchArm(a.name, a.lam, a.flux[:8], a.ivar[:8]) for a in arms]
    tm_cpu = make_template_model(cpu)
    small, cres, banks = {}, {}, {}
    for dev, tm_d in ((device, tm), (cpu, tm_cpu)):
        banks[dev.type] = {a.name: convert.ccf_bank(*bank, device=dev)
                           for a in sub}
        rec = []
        with ccf_result(record=rec):
            small[dev.type] = run_group_fit(tm_d, sub, banks[dev.type])
        cres[dev.type] = rec[0]
    counts = kernel_counts()
    with plain_versions(), ccf_result(replay=cres['cuda']):
        plain32 = run_group_fit(tm, sub, banks['cuda'])
    check(counts == kernel_counts(), 'the witness run launched a kernel')
    gk, gc = small['cuda'], small['cpu']
    vg, vc = gk['ref']['best_vel'], gc['ref']['best_vel']
    vp = plain32['ref']['best_vel']
    lim = np.maximum(1.0, 0.5 * gc['ref']['vel_err'])
    same_id = (cres['cuda']['best_id'] == cres['cpu']['best_id']).sum()
    log(f'8-fiber group fit, CUDA float32 vs CPU float64: max|dv| '
        f'{np.abs(vg - vc).max():.4f} km/s (limit max(1, 0.5 sigma)); '
        f'same CCF template {int(same_id)}/8')
    for i in range(len(vc)):
        log(f'  fiber {i}: CPU float64 {vc[i]:.4f} km/s; CUDA float32 '
            f'kernels {vg[i]:.4f} (|dv| {abs(vg[i] - vc[i]):.4f}, limit '
            f'{lim[i]:.4f}); CUDA float32 plain versions from the same '
            f'starts {vp[i]:.4f} (|dv| {abs(vp[i] - vc[i]):.4f})')
    check((np.abs(vg - vc) <= lim).all(),
          'the CUDA velocities disagree with the CPU float64 ones')
    # polished parameters: within half the CPU's error of the CPU's
    plim = 0.5 * gc['errs']
    dp, dpp = np.abs(gk['params'] - gc['params']), \
        np.abs(plain32['params'] - gc['params'])
    log(f'  polished parameters |dp| / sigma_CPU per fiber (limit 0.5), '
        f'kernels: {np.round((dp / gc["errs"]).max(1), 4).tolist()}; '
        f'plain versions: {np.round((dpp / gc["errs"]).max(1), 4).tolist()}')
    check((dp <= plim).all(), 'the CUDA polished parameters disagree with '
          'the CPU float64 ones')
    hessians_at_one_point(sub, {'cuda': tm, 'cpu': tm_cpu}, gc)
    # each run's errors at its own optimum: logged, not checked.  The
    # grid interpolation is multilinear, so the Hessian changes across
    # cell edges, and the float32 and float64 optima lie up to ~0.3
    # sigma apart; the witness shows the same spread without a kernel.
    rel = np.abs(gk['errs'] / gc['errs'] - 1).max(1)
    relp = np.abs(plain32['errs'] / gc['errs'] - 1).max(1)
    log(f'  Hessian errors at each run\'s own optimum, max over parameters '
        f'of |err_CUDA / err_CPU - 1| per fiber: kernels '
        f'{np.round(rel, 4).tolist()}, plain versions '
        f'{np.round(relp, 4).tolist()}; BAD_HESSIAN CUDA '
        f'{gk["bad_hess"].astype(int).tolist()}, plain '
        f'{plain32["bad_hess"].astype(int).tolist()}, CPU '
        f'{gc["bad_hess"].astype(int).tolist()}')
    return tm_cpu


# the float32 Hessian errors against float64 at one point
ERR_TOL = 0.02
# the float32 chi-square against float64 at one point: the change of
# chi-square over half a standard error in one parameter
CHI_TOL = 0.25


def hessians_at_one_point(sub, tms, gc):
    """The chi-square and the Hessian at the CPU run's refined
    velocities and polished parameters, on the card (float32, kernels)
    and on the CPU: their difference is float32 arithmetic alone.  The
    chi-squares may differ by at most CHI_TOL.  In correlation form (D
    H D, D = |diag H_CPU|^-1/2) the Hessians' difference is E; a
    fiber's BAD_HESSIAN flag may differ only where the CPU Hessian's
    smallest |eigenvalue| in that form is within 4 max|E| of 0 (Weyl: a
    perturbation E moves an eigenvalue by at most ||E||_2 <= 4 max|E|
    for 4 x 4)."""
    from rvspecfit_torch.fit.batch import BatchedFitter
    from rvspecfit_torch.fit.vel_fit import uncertainties_from_hessian
    h, chi = {}, {}
    vel, params = gc['ref']['best_vel'], gc['params']
    for key, tm_d in tms.items():
        bf = BatchedFitter(sub, {a.name: tm_d for a in sub}, CONFIG,
                           options=OPTIONS)
        h[key] = bf.hessians(vel, params).double().cpu().numpy()
        chi[key] = bf.chisq(vel[:, None], params[:, None, :])[:, 0] \
            .double().cpu().numpy()
    dchi = np.abs(chi['cuda'] - chi['cpu'])
    d = np.abs(np.diagonal(h['cpu'], axis1=1, axis2=2))**-0.5
    scale = d[:, :, None] * d[:, None, :]
    e = np.abs((h['cuda'] - h['cpu']) * scale).max((1, 2))
    lam = np.abs(np.linalg.eigvalsh(h['cpu'] * scale)).min(1)
    res = {k: [uncertainties_from_hessian(x) for x in v]
           for k, v in h.items()}
    errs = {k: np.array([r[0] for r in v]) for k, v in res.items()}
    bad = {k: np.array([r[2] for r in v]) for k, v in res.items()}
    good = ~(bad['cuda'] | bad['cpu'])
    rel = np.abs(errs['cuda'] / errs['cpu'] - 1).max(1)
    may_flip = lam <= 4 * e

    def show(x):
        return ([float(f'{v:.3g}') for v in x] if len(x) <= 8
                else f'max {np.max(x):.3g}')
    log(f'  at one point (the CPU optimum), float32 vs float64: |dchi2| '
        f'{show(dchi)} (limit {CHI_TOL}); Hessians max|E| per fiber '
        f'{show(e)}; CPU min|eigenvalue| {show(lam)} (min '
        f'{lam.min():.3g}); errors max |rel diff| (limit {ERR_TOL}, good '
        f'Hessians) {show(rel[good])}; BAD_HESSIAN card '
        f'{int(bad["cuda"].sum())}, CPU {int(bad["cpu"].sum())}, '
        f'differing {int((bad["cuda"] != bad["cpu"]).sum())}')
    check((dchi <= CHI_TOL).all(),
          'the card\'s chi-square at one point disagrees with float64')
    check(((bad['cuda'] == bad['cpu']) | may_flip).all(),
          'a BAD_HESSIAN flag differs where float32 cannot flip it')
    check((rel[good] <= ERR_TOL).all(),
          'the CUDA Hessian errors at one point disagree with float64')


# ------------------------------------------------------------------
# the DESI driver: coadd files -> survey/desi.proc_many -> RVTAB/RVMOD

NFILES = 4
COALESCE = 2
SETUPS = ('b', 'r', 'z')
TID0 = 39620000000
# RVTAB columns that need an EXPID column or a redrock file
OPTIONAL_COLUMNS = ('EXPID', 'RR_Z', 'RR_SPECTYPE', 'RR_SUBTYPE')
# the resolution-matrix comparison: NFIB_RES fibers, each smeared by a
# Gaussian LSF of its own (sigma 0.35-0.5 A, 1.4-2 px) given as
# width-RES_WIDTH bands, against templates of RES_SIGMA0 A lines
NFIB_RES = 64
RES_WIDTH = 11
RES_SIGMA0 = 0.25
C_KMS = 299792.458


def write_coadd(path, arms_data, bands=None):
    """A DESI coadd in bench.py's _build_e2e_coadd format (B/R/Z flux,
    ivar, mask and wavelength, FIBERMAP, SCORES), written with the
    port's fitsio; ``bands`` optionally {arm: (B, w, npix)} RESOLUTION
    extensions."""
    from rvspecfit_torch.io import fitsio
    nfib = next(iter(arms_data.values()))[1].shape[0]
    hdus = [dict(kind='image', data=None)]
    for s, (lam, flux, ivar) in arms_data.items():
        su = s.upper()
        hdus += [
            dict(kind='image', data=lam, name=f'{su}_WAVELENGTH'),
            dict(kind='image', data=flux.astype(np.float32),
                 name=f'{su}_FLUX'),
            dict(kind='image', data=ivar.astype(np.float32),
                 name=f'{su}_IVAR'),
            dict(kind='image', data=np.zeros(flux.shape, np.int32),
                 name=f'{su}_MASK')]
        if bands is not None:
            hdus.append(dict(kind='image', data=bands[s].astype(np.float32),
                             name=f'{su}_RESOLUTION'))
    hdus.append(dict(kind='table', name='FIBERMAP', data=[
        ('TARGETID', np.arange(nfib, dtype=np.int64) + TID0),
        ('TARGET_RA', np.linspace(0, 359, nfib)),
        ('TARGET_DEC', np.zeros(nfib)),
        ('FIBER', np.arange(nfib, dtype=np.int32)),
        ('OBJTYPE', np.array(['TGT'] * nfib)),
        ('FIBERSTATUS', np.zeros(nfib, np.int32)),
        ('DESI_TARGET', np.full(nfib, 1 << 61, np.int64))]))
    hdus.append(dict(kind='table', name='SCORES', data=[
        ('MEDIAN_CALIB_SNR_' + s.upper(), np.full(nfib, 50.0))
        for s in arms_data]))
    fitsio.write(path, hdus)
    return path


def resolution_exposure(nfib, seed):
    """``nfib`` fibers of the 3-arm layout at S/N 50, each smeared by
    its own Gaussian LSF, and that LSF as dia-convention bands
    (offsets +w..-w, each column summing to 1): (arms_data, bands,
    truth)."""
    from rvspecfit_torch import simulation
    rng = np.random.RandomState(seed)
    truth = dict(vel=rng.uniform(-500, 500, nfib),
                 teff=rng.uniform(4500, 9500, nfib),
                 logg=rng.uniform(1.0, 4.8, nfib),
                 feh=rng.uniform(-1.9, -0.1, nfib),
                 alpha=rng.uniform(0.05, 0.95, nfib))
    sigmas = np.linspace(0.35, 0.5, nfib)
    w2 = RES_WIDTH // 2
    offs = np.arange(w2, -w2 - 1, -1)
    arms, bands = {}, {}
    for name, (l0, l1) in simulation.THREE_ARM_LAYOUT.items():
        lam = np.linspace(l0, l1, NPIX_ARM)
        flux = np.zeros((nfib, NPIX_ARM))
        for i in range(nfib):
            flux[i] = simulation.fake_spectrum(
                lam / (1 + truth['vel'][i] / C_KMS), truth['teff'][i],
                truth['logg'][i], truth['feh'][i], truth['alpha'][i],
                wresol=sigmas[i])
        esp = flux / 50.0
        arms[name] = (lam, flux + rng.normal(size=flux.shape) * esp,
                      1.0 / esp**2)
        g = np.exp(-0.5 * (offs[None, :] * (lam[1] - lam[0])
                           / sigmas[:, None])**2)
        g /= g.sum(1, keepdims=True)
        bands[name] = np.repeat(g[:, :, None], NPIX_ARM, axis=2)
    return arms, bands, truth


def per_setup(x):
    return {f'desi_{s}': x for s in SETUPS}


@contextlib.contextmanager
def group_fits(records):
    """Append to ``records``, for each group fit the driver runs, its
    fibers, phases, wall time, kernel launches, arms and result."""
    from rvspecfit_torch.survey import desi
    real = desi._run_group_fit

    def run(arms, templates, config, options, **kw):
        before = kernel_counts()
        t0 = time.perf_counter()
        out = real(arms, templates, config, options, **kw)
        wall = time.perf_counter() - t0
        after = kernel_counts()
        records.append(dict(
            nfibers=arms[0].nfibers, phases=out['phases'], wall=wall,
            launches={k: after[k] - before[k] for k in after}, arms=arms,
            out=out))
        return out
    with mock.patch.object(desi, '_run_group_fit', run):
        yield


def read_status(path):
    with open(path) as fp:
        return [ln.split() for ln in fp.read().strip().splitlines()]


def run_driver(workdir, tm, bank_d):
    """The slice's main path on the card: NFILES 500-fiber coadds
    through the port's proc_many at coalesce 2 (two groups of 1000
    fibers, the first cold), crash isolation off.  Checks the status
    lines, the RVTAB schema and rows, RV recovery per file and RVMOD,
    and that every kernel of the path was launched."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.io import fitsio
    from rvspecfit_torch.survey import desi
    t0 = time.perf_counter()
    files, truths = [], []
    for i in range(NFILES):
        arms_data, truth = simulation.make_exposure(
            NFIBERS, npix_arm=NPIX_ARM, snr=50.0, seed=100 + i)
        files.append(write_coadd(
            os.path.join(workdir, f'coadd-bench{i}.fits'), arms_data))
        truths.append(truth)
    log(f'driver inputs: {NFILES} coadds of {NFIBERS} fibers x 3 arms x '
        f'{NPIX_ARM} px ({time.perf_counter() - t0:.1f} s)')
    outdir = os.path.join(workdir, 'out')
    status = os.path.join(workdir, 'status.txt')
    records = []
    reset_counts()
    t_start = time.time()
    t0 = time.perf_counter()
    with group_fits(records):
        desi.proc_many(files, outdir, config=CONFIG, options=OPTIONS,
                       status_fname=status, coalesce=COALESCE,
                       templates=per_setup(tm), banks=per_setup(bank_d),
                       throw_exceptions=True)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    log(f'driver: {NFILES} files at coalesce {COALESCE} in {wall:.3f} s; '
        f'kernel launches {counts}')
    check(all(v > 0 for v in counts.values()),
          f'a kernel of the driver path was not launched: {counts}')

    lines = read_status(status)
    check([ln[0] for ln in lines] == files
          and all(ln[1:3] == ['SUCCESS', str(NFIBERS)] and len(ln) == 5
                  for ln in lines),
          f'status lines: {lines}')
    stamps = [float(ln[4]) for ln in lines]
    steady = (stamps[-1] - stamps[COALESCE - 1]) / (NFILES - COALESCE)
    cold = stamps[COALESCE - 1] - t_start
    log(f'driver status: per-file seconds {[float(ln[3]) for ln in lines]};'
        f' cold group {cold:.3f} s ({COALESCE} files); steady '
        f'{steady:.3f} s/file from completion times -> '
        f'{NFIBERS / steady:.1f} fibers/s')
    check(len(records) == NFILES // COALESCE
          and all(r['nfibers'] == COALESCE * NFIBERS for r in records),
          f'group fits: {[r["nfibers"] for r in records]}')
    for g, r in enumerate(records):
        log(f'  group {g} ({r["nfibers"]} fibers): ' + ' '.join(
            f'{k}={r["phases"][k]:.3f}s' for k in PHASES)
            + f' fit={r["wall"]:.3f}s; launches {r["launches"]}')

    desc = desi.get_column_desc([s.upper() for s in SETUPS])
    recovered = []
    for f, truth in zip(files, truths):
        tab_path, mod_path = desi.output_paths(f, outdir)
        rv = fitsio.read(tab_path)['RVTAB'].data
        check(np.array_equal(rv['TARGETID'], np.arange(NFIBERS) + TID0),
              f'{f}: RVTAB rows are not the {NFIBERS} targets in order')
        for k, (dtype, _, _) in desc.items():
            check(k in OPTIONAL_COLUMNS
                  or (k in rv and rv[k].dtype == np.dtype(dtype)),
                  f'{f}: RVTAB column {k} missing or not {dtype}')
        ok = np.abs(rv['VRAD'] - truth['vel']) < np.maximum(
            10.0, 5 * rv['VRAD_ERR'])
        recovered.append(int(ok.sum()))
        check(ok.sum() >= 0.98 * NFIBERS,
              f'{f}: RV recovery {ok.sum()}/{NFIBERS}')
        mod = fitsio.read(mod_path)
        for s in SETUPS:
            m = mod[f'{s.upper()}_MODEL'].data
            check(m.shape == (NFIBERS, NPIX_ARM) and m.dtype == np.float32
                  and np.isfinite(m).all(), f'{f}: {s} RVMOD')
    log(f'driver RV recovery per file (of {NFIBERS}, within max(10, 5 '
        f'sigma)): {recovered}; RVTAB has every column of '
        f'get_column_desc with its dtype; RVMOD ({NFIBERS}, {NPIX_ARM}) '
        'float32 per arm')
    group_truth = {k: np.concatenate([t[k] for t in truths[-COALESCE:]])
                   for k in truths[0]}
    return dict(counts=counts, records=records, steady=steady, cold=cold,
                wall=wall, recovered=recovered, truth=group_truth)


def runs_with_witnesses(name, run, tms, witness64=None):
    """One driver run per key of the card-vs-CPU comparison, each
    through ``run(key, template model, device) -> output table``:
    'cuda' (float32, kernels), 'cpu' (float64, plain versions) and
    'witness', the card in float32 with the plain versions in place of
    the kernels (it launches none), which tells float32 arithmetic from
    a kernel at fault.  ``witness64``, a float64 template model on the
    card, adds 'witness64' and 'witness64cpu', the plain versions in
    float64 on the card (a float64 objective) from the kernel run's CCF
    starts and from the CPU run's (which tells the starts from the
    arithmetic), and 'cpustarts', the kernel run again from the CPU
    run's CCF starts.  Returns {key: table}."""
    tabs, cres = {}, {'cuda': [], 'cpu': []}
    keys = ('cuda', 'cpu', 'witness') + (
        ('witness64', 'witness64cpu', 'cpustarts') if witness64 else ())
    for key in keys:
        dev = 'cpu' if key == 'cpu' else 'cuda'
        tm_k = witness64 if key.startswith('witness64') else tms[dev]
        counts = kernel_counts()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if key.startswith('witness'):
                stack.enter_context(plain_versions())
            if key in cres:
                stack.enter_context(ccf_result(record=cres[key]))
            if key.startswith('witness64') or key == 'cpustarts':
                stack.enter_context(ccf_result(
                    replay=cres['cuda' if key == 'witness64' else
                                'cpu'][0]))
            tabs[key] = run(key, tm_k, dev)
        log(f'{name}: driver on {key} {time.perf_counter() - t0:.2f} s')
        if key.startswith('witness'):
            check(counts == kernel_counts(),
                  f'the {key} run launched a kernel')
    return tabs


def spread_against_cpu(name, tabs, vel, pars, err):
    """Each run of ``tabs`` against the CPU's: |dv| over max(1 km/s,
    sigma/2) and |dp| / sigma per fiber and parameter, sigma the CPU's
    errors (columns ``vel``, each parameter of ``pars``, and each with
    the suffix ``err``), logged for the card's run and every witness.
    Returns (dv, dp) of the card's run and the dict of NM end-point
    numbers (max |dp|/sigma and fibers over 0.5 for each run)."""
    c = tabs['cpu']
    lim = np.maximum(1.0, 0.5 * c[vel + err])

    def spread(t):
        dv = np.abs(t[vel] - c[vel]) / lim
        dp = np.stack([np.abs(t[p] - c[p]) / c[p + err] for p in pars], 1)
        return dv, dp
    (dv, dp), (wdv, wdp) = spread(tabs['cuda']), spread(tabs['witness'])
    good = np.isfinite(dp).all(1)
    over = (dp > 0.5).any(1)
    log(f'{name}: {len(c[vel])} fibers, card float32 vs CPU float64: max '
        f'|dv|/limit {dv.max():.4f} (limit max(1 km/s, sigma/2)); max '
        f'|dp|/sigma {np.nanmax(dp):.4f}, over 0.5 for {int(over.sum())} '
        f'fibers ({int(good.sum())} with finite CPU errors); witness '
        f'(float32, plain versions): max |dv|/limit {wdv.max():.4f}, max '
        f'|dp|/sigma {np.nanmax(wdp):.4f}, over 0.5 for '
        f'{int((wdp > 0.5).any(1).sum())}')
    nm_check = dict(max_dp=float(np.nanmax(dp)), over=int(over.sum()),
                    witness32_max_dp=float(np.nanmax(wdp)),
                    witness32_over=int((wdp > 0.5).any(1).sum()))
    for key, what in (
            ('witness64', 'a float64 objective (plain versions in float64 '
             'on the card) from the kernel run\'s CCF starts'),
            ('witness64cpu', 'a float64 objective from the CPU run\'s CCF '
             'starts'),
            ('cpustarts', 'the kernels (float32) from the CPU run\'s CCF '
             'starts')):
        if key not in tabs:
            continue
        w64dv, w64dp = spread(tabs[key])
        nm_check[key + '_max_dp'] = float(np.nanmax(w64dp))
        nm_check[key + '_over'] = int((w64dp > 0.5).any(1).sum())
        log(f'{name}: {what}: max |dv|/limit {w64dv.max():.4f}, max '
            f'|dp|/sigma {np.nanmax(w64dp):.4f}, over 0.5 for '
            f'{int((w64dp > 0.5).any(1).sum())} fibers; at the '
            f'{int(over.sum())} fibers the kernel run left over 0.5: '
            f'{np.round(np.nanmax(w64dp[over], 1), 4).tolist()}')
    return dv, dp, nm_check


def driver_against_cpu(workdir, name, arms_data, tms, banks, bands=None,
                       config=CONFIG, check_params=True, witness64=None):
    """One coadd through proc_many on the card (float32, kernels) and on
    the CPU (float64, plain versions), with the witnesses of
    runs_with_witnesses: same columns, TARGETID and SUCCESS; RVS_WARN
    equal but for BAD_HESSIAN, whose flips are held to the one-point
    test (hessians_at_one_point, which also holds the chi-square at the
    CPU optimum); |dv| <= max(1 km/s, sigma/2), sigma the CPU's errors.
    With ``check_params``, the parameters within sigma/2 of the CPU's
    too; else logged only."""
    from rvspecfit_torch.io import fitsio
    from rvspecfit_torch.survey import desi
    path = write_coadd(os.path.join(workdir, f'coadd-{name}.fits'),
                       arms_data, bands)
    recs = {}

    def run(key, tm_k, dev):
        records = []
        outdir = os.path.join(workdir, f'out-{name}-{key}')
        with group_fits(records):
            desi.proc_many([path], outdir, config=config, options=OPTIONS,
                           coalesce=COALESCE, templates=per_setup(tm_k),
                           banks=per_setup(banks[dev]),
                           throw_exceptions=True,
                           use_resolution_matrix=bands is not None)
        recs[key] = records[0]
        return fitsio.read(desi.output_paths(path, outdir)[0])[
            'RVTAB'].data
    tabs = runs_with_witnesses(name, run, tms, witness64)
    g, c = tabs['cuda'], tabs['cpu']
    bh = desi.bitmasks['BAD_HESSIAN']
    check(list(g) == list(c), f'{name}: RVTAB columns differ')
    check(np.array_equal(g['TARGETID'], c['TARGETID']),
          f'{name}: TARGETID differs')
    check(np.array_equal(g['SUCCESS'], c['SUCCESS']),
          f'{name}: SUCCESS differs')
    check(np.array_equal(g['RVS_WARN'] & ~bh, c['RVS_WARN'] & ~bh),
          f'{name}: RVS_WARN differs beyond BAD_HESSIAN')
    dv, dp, nm_check = spread_against_cpu(
        name, tabs, 'VRAD', ('TEFF', 'LOGG', 'FEH', 'ALPHAFE'), '_ERR')
    flips = int(((g['RVS_WARN'] ^ c['RVS_WARN']) & bh).astype(bool).sum())
    log(f'{name}: BAD_HESSIAN flips at own optima {flips}; SUCCESS '
        f'{int(g["SUCCESS"].sum())}/{len(g["SUCCESS"])} on both')
    check((dv <= 1).all(), f'{name}: card velocities disagree with CPU')
    if check_params:
        good = np.isfinite(dp).all(1)
        check((dp[good] <= 0.5).all(),
              f'{name}: card parameters disagree with CPU')
    hessians_at_one_point(recs['cpu']['arms'], tms, recs['cpu']['out'])
    return nm_check


# ------------------------------------------------------------------
# the single-object fit: SpecData -> ccf.fit -> vel_fit.process

NOBJ = 8
NFIRSTGUESS = 2
# the resolution-matrix object: resolution_exposure's first fiber, whose
# lines are RES_OBJ_SIGMA A wide, fitted with the narrow templates'
# RES_SIGMA0 A lines and the Gaussian LSF that makes up the difference
RES_OBJ_SIGMA = 0.35


def single_objects(seed=7):
    """NOBJ objects of the 3-arm layout at S/N 50, each as 3 SpecData:
    (objects, truth)."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit.spec_data import SpecData
    arms_data, truth = simulation.make_exposure(NOBJ, npix_arm=NPIX_ARM,
                                                snr=50.0, seed=seed)
    return [[SpecData(n, lam, fl[i], 1.0 / np.sqrt(iv[i]))
             for n, (lam, fl, iv) in arms_data.items()]
            for i in range(NOBJ)], truth


@contextlib.contextmanager
def process_stages(record):
    """Append to ``record`` {stage: [seconds]} for each stage of
    vel_fit.process (scan, nm, bfgs, refine, models, hessian; each
    waits for the card) and {'bfgs_calls': [objective-and-gradient
    calls]}."""
    import scipy.optimize
    import torch
    from rvspecfit_torch.fit import likelihood, vel_fit

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.setdefault(name, []).append(time.perf_counter() - t0)
            if name == 'bfgs':
                record.setdefault('bfgs_calls', []).append(out.nfev)
            return out
        return run
    with mock.patch.object(vel_fit, 'find_best',
                           timed('scan', vel_fit.find_best)), \
            mock.patch.object(vel_fit.nm, 'minimize_batch',
                              timed('nm', vel_fit.nm.minimize_batch)), \
            mock.patch.object(scipy.optimize, 'minimize',
                              timed('bfgs', scipy.optimize.minimize)), \
            mock.patch.object(vel_fit, '_minimum_sampler',
                              timed('refine', vel_fit._minimum_sampler)), \
            mock.patch.object(likelihood.FusedChisq, 'full_output',
                              timed('models',
                                    likelihood.FusedChisq.full_output)), \
            mock.patch.object(likelihood.FusedChisq, 'hessian',
                              timed('hessian',
                                    likelihood.FusedChisq.hessian)):
        yield


def single_at_one_point(sds, templates, res_cpu, resol=None):
    """The chi-square and the Hessian errors of one object at the CPU
    run's optimum, on the card (float32, kernels) and on the CPU: |dchi2|
    and max |rel diff| of the errors, and each side's BAD_HESSIAN."""
    from rvspecfit_torch.fit.likelihood import FusedChisq
    from rvspecfit_torch.fit.vel_fit import uncertainties_from_hessian
    names = templates['cpu'][sds[0].name].parnames
    params = np.array([res_cpu['param'][p] for p in names])
    chi, err, bad = {}, {}, {}
    for key, tms in templates.items():
        f = FusedChisq(sds, tms, CONFIG, options=OPTIONS,
                       resol_mats=resol and resol[key])
        chi[key] = f.chisq_one(res_cpu['vel'], params)
        h = f.hessian(res_cpu['vel'], params)
        err[key], _, bad[key] = uncertainties_from_hessian(
            h.double().cpu().numpy())
    rel = float(np.abs(err['cuda'] / err['cpu'] - 1).max())
    return abs(chi['cuda'] - chi['cpu']), rel, bad['cuda'], bad['cpu']


def run_single_object(models, banks):
    """The single-object path on the card: ccf.fit -> vel_fit.process on
    each of NOBJ objects, firstguess on NFIRSTGUESS of them and one
    process with a Gaussian resolution matrix per arm (resolParams); its
    kernel launches counted from 0.  Then the CPU float64 run of the same
    calls.  Checks RV recovery, every kernel launched, and the card
    against the CPU (velocities within max(1 km/s, sigma/2); chi-square
    within CHI_TOL and Hessian errors within ERR_TOL at the CPU optimum;
    parameters logged, see ROADMAP C.1)."""
    import torch
    from rvspecfit_torch.fit import ccf, vel_fit
    from rvspecfit_torch.fit.spec_data import SpecData
    from rvspecfit_torch.ops.resolution import gaussian_resolution_matrix
    objs, truth = single_objects()
    names = [sd.name for sd in objs[0]]
    tms = {k: {n: models[k] for n in names} for k in ('cuda', 'cpu')}
    bks = {k: {n: banks[k] for n in names} for k in ('cuda', 'cpu')}
    res_objs, res_truth = resolution_exposure(1, seed=12)[::2]
    res_sds = [SpecData(n, lam, fl[0], 1.0 / np.sqrt(iv[0]))
               for n, (lam, fl, iv) in res_objs.items()]
    narrow = {k: {n: models['narrow_' + k] for n in names}
              for k in ('cuda', 'cpu')}
    width = np.sqrt(RES_OBJ_SIGMA**2 - RES_SIGMA0**2)
    resol = {k: {sd.name: gaussian_resolution_matrix(sd.lam, width=width)
                 for sd in res_sds} for k in ('cuda', 'cpu')}

    out = {}
    for key in ('cuda', 'cpu'):
        calls, guesses = [], []
        if key == 'cuda':
            reset_counts()
            torch.cuda.synchronize()
        t_phase = time.perf_counter()
        for sds in objs:
            rec = {}
            c0 = kernel_counts()
            t0 = time.perf_counter()
            g = ccf.fit(sds, CONFIG, banks=bks[key])
            t1 = time.perf_counter()
            c1 = kernel_counts()
            with process_stages(rec):
                r = vel_fit.process(sds, g['best_par'], config=CONFIG,
                                    options=OPTIONS, templates=tms[key])
            t2 = time.perf_counter()
            c2 = kernel_counts()
            calls.append(dict(
                res=r, ccf=g, ccf_s=t1 - t0, process_s=t2 - t1,
                stages={k: float(np.sum(v)) for k, v in rec.items()},
                ccf_launches={k: c1[k] - c0[k] for k in c0},
                process_launches={k: c2[k] - c1[k] for k in c0}))
        t_fit = time.perf_counter()
        # the CPU's float64 firstguess takes ~20 s an object: one is
        # enough to compare with
        for sds in objs[:NFIRSTGUESS if key == 'cuda' else 1]:
            guesses.append(vel_fit.firstguess(sds, config=CONFIG,
                                              options=OPTIONS,
                                              templates=tms[key]))
        t_guess = time.perf_counter()
        r_res = vel_fit.process(res_sds, START, config=CONFIG,
                                options=OPTIONS, templates=narrow[key],
                                resolParams=resol[key])
        t_end = time.perf_counter()
        out[key] = dict(calls=calls, guesses=guesses, res=r_res,
                        seconds=dict(fit=t_fit - t_phase,
                                     firstguess=t_guess - t_fit,
                                     resolution=t_end - t_guess,
                                     phase=t_end - t_phase))
        if key == 'cuda':
            out['counts'] = kernel_counts()
        log(f'single-object phase on {key}: ' + ' '.join(
            f'{k}={v:.3f}s' for k, v in out[key]['seconds'].items()))

    counts = out['counts']
    log(f'single-object phase kernel launches: {counts}')
    check(all(v > 0 for v in counts.values()),
          f'a kernel of the single-object path was not launched: {counts}')
    card, cpu = out['cuda'], out['cpu']
    # a witness of ccf.fit: the plain version of kernel B on the card
    # (float32) tells float32 arithmetic from the kernel's own error
    counts0 = kernel_counts()
    with plain_versions():
        plain = [ccf.fit(sds, CONFIG, banks=bks['cuda']) for sds in objs]
    check(counts0 == kernel_counts(), 'the plain ccf.fit launched a kernel')
    fits = {'kernel': [c['ccf'] for c in card['calls']], 'plain': plain,
            'cpu': [c['ccf'] for c in cpu['calls']]}
    vel = {k: np.array([r['best_vel'] for r in v]) for k, v in fits.items()}
    same = {k: sum(r['best_par'] == q['best_par']
                   for r, q in zip(fits[k], fits['cpu']))
            for k in ('kernel', 'plain')}
    dvel = lambda a, b: np.abs(vel[a] - vel[b]).max()
    dcurve = lambda a, b: max(np.abs(x['best_ccf'] - y['best_ccf']).max()
                              for x, y in zip(fits[a], fits[b]))
    rise = [np.partition(r['best_ccf'] - r['best_ccf'].min(), 2)[1:3]
            for r in fits['cpu']]
    log(f'single-object ccf.fit best_vel, max over objects: |kernel B - '
        f'CPU| {dvel("kernel", "cpu"):.4f} km/s, |plain float32 - CPU| '
        f'{dvel("plain", "cpu"):.4f}, |kernel B - plain float32| '
        f'{dvel("kernel", "plain"):.4f}; same template as the CPU: kernel '
        f'B {same["kernel"]}/{NOBJ}, plain float32 {same["plain"]}/{NOBJ}; '
        f'best curves max|kernel B - plain float32| '
        f'{dcurve("kernel", "plain"):.4g}, max|plain float32 - CPU| '
        f'{dcurve("plain", "cpu"):.4g}; the CPU curves\' two next-lowest '
        f'points lie {np.min(rise):.4g}..{np.max(rise):.4g} above their '
        f'minimum')
    for i, (c, p) in enumerate(zip(card['calls'], cpu['calls'])):
        r = c['res']
        log(f'  object {i}: ccf.fit {c["ccf_s"]:.3f} s, process '
            f'{c["process_s"]:.3f} s (' + ' '.join(
                f'{k}={v:.3f}s' for k, v in c['stages'].items()
                if k != 'bfgs_calls')
            + '; BFGS objective+gradient calls '
            f'{c["stages"].get("bfgs_calls", 0):.0f}); launches ccf.fit {c["ccf_launches"]}, process '
            f'{c["process_launches"]}; vel {r["vel"]:.3f} +- '
            f'{r["vel_err"]:.3f} (truth {truth["vel"][i]:.3f}, CPU '
            f'{p["res"]["vel"]:.3f}); CPU process {p["process_s"]:.3f} s')
    rv = np.array([c['res']['vel'] for c in card['calls']])
    sig = np.array([c['res']['vel_err'] for c in card['calls']])
    ok = np.abs(rv - truth['vel']) < np.maximum(10.0, 5 * sig)
    check(ok.all(), f'single-object RV recovery {int(ok.sum())}/{NOBJ}')
    vc = np.array([p['res']['vel'] for p in cpu['calls']])
    sc = np.array([p['res']['vel_err'] for p in cpu['calls']])
    dv = np.abs(rv - vc) / np.maximum(1.0, 0.5 * sc)
    dchi, rel, flips = [], [], 0
    for sds, p in zip(objs, cpu['calls']):
        d, e, bc, bp = single_at_one_point(sds, tms, p['res'])
        dchi.append(d)
        rel.append(e if not (bc or bp) else 0.0)
        flips += int(bc != bp)
    d, e, bc, bp = single_at_one_point(res_sds, narrow, cpu['res'], resol)
    dchi.append(d)
    rel.append(e if not (bc or bp) else 0.0)
    flips += int(bc != bp)
    names4 = list(card['calls'][0]['res']['param'])
    dp = np.array([[abs(c['res']['param'][k] - p['res']['param'][k])
                    / p['res']['param_err'][k] for k in names4]
                   for c, p in zip(card['calls'] + [dict(res=card['res'])],
                                   cpu['calls'] + [dict(res=cpu['res'])])])
    r_res = card['res']
    dv_res = abs(r_res['vel'] - cpu['res']['vel']) / max(
        1.0, 0.5 * cpu['res']['vel_err'])
    log(f'single-object: RV recovery {int(ok.sum())}/{NOBJ} within max(10, '
        f'5 sigma); card vs CPU float64: max |dv|/limit '
        f'{max(dv.max(), dv_res):.4f} (limit max(1 km/s, sigma/2)); at the '
        f'CPU optimum |dchi2| max {max(dchi):.4g} (limit {CHI_TOL}), errors '
        f'max |rel diff| {max(rel):.4g} (limit {ERR_TOL}, good Hessians), '
        f'BAD_HESSIAN differing {flips} (logged); parameters at each run\'s own optimum max '
        f'|dp|/sigma {np.nanmax(dp):.4f}, over 0.5 for '
        f'{int((dp > 0.5).any(1).sum())} of {len(dp)} (logged: ROADMAP C.1)')
    log(f'  resolution-matrix object: vel {r_res["vel"]:.3f} +- '
        f'{r_res["vel_err"]:.3f} (truth {res_truth["vel"][0]:.3f}, CPU '
        f'{cpu["res"]["vel"]:.3f}); firstguess card '
        f'{card["guesses"]}, CPU {cpu["guesses"]}')
    check((dv <= 1).all() and dv_res <= 1,
          'single-object velocities on the card disagree with the CPU')
    check(abs(r_res['vel'] - res_truth['vel'][0]) < max(
        10.0, 5 * r_res['vel_err']), 'resolution-matrix object: RV')
    check(max(dchi) <= CHI_TOL, 'single-object chi-square at the CPU '
          'optimum disagrees with float64')
    check(max(rel) <= ERR_TOL, 'single-object Hessian errors at the CPU '
          'optimum disagree with float64')
    out['max_dp'] = float(np.nanmax(dp))
    for gs in card['guesses']:
        check(set(gs) >= set(names4), f'firstguess gave {gs}')
    return out


def kernel_b_single(sd, bank):
    """Kernel B at one fiber row, as ccf.fit launches it on the
    SpecData ``sd`` (prepare_arm_batch at B = 1)."""
    from rvspecfit_torch.fit.batch import BatchArm
    args, cont = kernel_b_args([BatchArm(sd.name, sd.lam, sd.spec[None],
                                         sd.espec[None]**-2.0)], bank)
    return kernel_b_case(args, cont, 'kernel B at B = 1 (ccf.fit)',
                         graph=True)


# ------------------------------------------------------------------
# the WEAVE driver: file pairs -> survey/weave.proc_many -> WEAVE_RV

WEAVE_LAYOUT = {'b': (4600.0, 4900.0), 'r': (4900.0, 5150.0)}
WEAVE_NFIB = 500
WEAVE_OPTIONS = {'npoly': 15}


def write_weave_pair(workdir, nfib, seed):
    """A WEAVE RED + BLUE pair of ``nfib`` fibers x NPIX_ARM px on
    WEAVE_LAYOUT (inside the synthetic grid's 4550-5450 A) in
    tests/test_weave.py's layout, written with the port's fitsio:
    (comma-joined names, truth)."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.io import fitsio
    arms, truth = simulation.make_exposure(nfib, npix_arm=NPIX_ARM,
                                           snr=50.0, seed=seed,
                                           layout=WEAVE_LAYOUT)
    fnames = []
    for s, cam in (('r', 'RED'), ('b', 'BLUE')):
        lam, flux, ivar = arms[s]
        hd = [('CAMERA', f'WEAVE{cam}', ''), ('OBID', 'smoke_ob.01', ''),
              ('CRVAL1', lam[0] * 1e-10, ''),
              ('CD1_1', (lam[1] - lam[0]) * 1e-10, ''),
              ('CRPIX1', 1.0, ''), ('CUNIT1', 'm', '')]
        fib = [('TARGID', np.array([f'"star_{i}"' for i in range(nfib)])),
               ('TARGCAT', np.array(['GA_LRhighlat'] * nfib))]
        fname = os.path.join(workdir, f'weave{seed}_{cam}.fits')
        fitsio.write(fname, [
            dict(kind='image', data=None, header=hd),
            dict(kind='image', data=flux.astype(np.float32),
                 name=f'{cam}_DATA', header=hd),
            dict(kind='image', data=ivar.astype(np.float32),
                 name=f'{cam}_IVAR'),
            dict(kind='table', data=fib, name='FIBTABLE')])
        fnames.append(fname)
    return ','.join(fnames), truth


def weave_columns(parnames, setups):
    """The WEAVE_RV columns the reference writes
    (rvspecfit_tpu/survey/weave.py:197-208), in order."""
    cols = ['brickname', 'target_id', 'vrad', 'vrad_err', 'vsini']
    for p in parnames:
        cols += [p, p + '_err']
    cols.append('chisq_tot')
    for s in setups:
        cols += [f'chisq_{s}', f'chisq_c_{s}', f'sn_{s}']
    return cols


def run_weave(workdir, models, banks, witness64):
    """survey/weave.proc_many over a WEAVE_NFIB-fiber pair on the card,
    launches counted from 0: the status line, the WEAVE_RV columns, RV
    recovery; then an 8-fiber pair on the card against the CPU with the
    witnesses of runs_with_witnesses (``witness64`` the float64 template
    model on the card): velocities within max(1 km/s, sigma/2),
    parameters logged."""
    import torch
    from rvspecfit_torch.io import fitsio
    from rvspecfit_torch.survey import weave
    grp, truth = write_weave_pair(workdir, WEAVE_NFIB, seed=40)
    kw = lambda k: dict(options=WEAVE_OPTIONS, throw_exceptions=True,
                        templates={f'weave_{s}': models[k]
                                   for s in WEAVE_LAYOUT},
                        banks={f'weave_{s}': banks[k]
                               for s in WEAVE_LAYOUT})
    outdir = os.path.join(workdir, 'weave-out')
    status = os.path.join(workdir, 'weave-status.txt')
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    weave.proc_many([grp], outdir, CONFIG, status_fname=status, **kw('cuda'))
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    log(f'WEAVE: {WEAVE_NFIB} fibers x 2 arms x {NPIX_ARM} px in '
        f'{wall:.3f} s -> {WEAVE_NFIB / wall:.1f} fibers/s; kernel '
        f'launches {counts}')
    check(all(v > 0 for v in counts.values()),
          f'a kernel of the WEAVE path was not launched: {counts}')
    ofname = weave.output_path(grp, outdir)
    lines = read_status(status)
    check(len(lines) == 1 and lines[0][:3] == [ofname, 'SUCCESS',
                                              str(WEAVE_NFIB)],
          f'WEAVE status lines: {lines}')
    tab = fitsio.read(ofname)['WEAVE_RV'].data
    parnames = models['cuda'].parnames
    check(list(tab) == weave_columns(parnames, sorted(WEAVE_LAYOUT)),
          f'WEAVE_RV columns {list(tab)}')
    ok = np.abs(tab['vrad'] - truth['vel']) < np.maximum(
        10.0, 5 * tab['vrad_err'])
    log(f'WEAVE RV recovery {int(ok.sum())}/{WEAVE_NFIB} within max(10, 5 '
        f'sigma); WEAVE_RV has the reference\'s {len(tab)} columns; status '
        f'{lines[0][:4]}')
    check(ok.sum() >= 0.98 * WEAVE_NFIB,
          f'WEAVE RV recovery {ok.sum()}/{WEAVE_NFIB}')

    grp8, _ = write_weave_pair(workdir, 8, seed=41)

    def run8(key, tm_k, dev):
        out8 = os.path.join(workdir, f'weave8-{key}')
        kw8 = dict(kw(dev), templates={f'weave_{s}': tm_k
                                       for s in WEAVE_LAYOUT})
        weave.proc_many([grp8], out8, CONFIG, device=dev, **kw8)
        return fitsio.read(weave.output_path(grp8, out8))['WEAVE_RV'].data
    tabs = runs_with_witnesses('WEAVE 8-fiber pair', run8, models,
                               witness64)
    g, c = tabs['cuda'], tabs['cpu']
    check(list(g) == list(c) and np.array_equal(g['target_id'],
                                                c['target_id']),
          'WEAVE 8-fiber pair: columns or targets differ')
    dv, dp, nm_check = spread_against_cpu('WEAVE 8-fiber pair', tabs,
                                          'vrad', parnames, '_err')
    for key, t in tabs.items():
        dpk = np.stack([np.abs(t[p] - c[p]) / c[p + '_err']
                        for p in parnames], 1)
        log(f'WEAVE 8-fiber pair, {key}: per fiber max |dp|/sigma_CPU '
            f'{np.round(np.nanmax(dpk, 1), 4).tolist()}, vsini '
            f'{np.round(t["vsini"], 3).tolist()} km/s')
    log('WEAVE 8-fiber pair: parameters logged, not checked (PERF.md)')
    check((dv <= 1).all(), 'WEAVE velocities on the card disagree with CPU')
    return dict(counts=counts, wall=wall, recovered=int(ok.sum()),
                nm_check=nm_check)


def run_bruteforce(workdir, tm, bank_d):
    """The DESI driver with ``--param_init bruteforce`` (ccf_init=False)
    on an 8-fiber coadd on the card, launches counted from 0: the RVTAB
    schema (no CCF columns but VRAD_CCF) and RV recovery."""
    import torch
    from rvspecfit_torch import simulation
    from rvspecfit_torch.io import fitsio
    from rvspecfit_torch.survey import desi
    arms_data, truth = simulation.make_exposure(8, npix_arm=NPIX_ARM,
                                                snr=50.0, seed=9)
    path = write_coadd(os.path.join(workdir, 'coadd-bruteforce.fits'),
                       arms_data)
    outdir = os.path.join(workdir, 'out-bruteforce')
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    desi.proc_many([path], outdir, config=CONFIG, options=OPTIONS,
                   coalesce=COALESCE, templates=per_setup(tm),
                   banks=per_setup(bank_d), throw_exceptions=True,
                   ccf_init=False)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    log(f'DESI --param_init bruteforce: 8 fibers in {wall:.3f} s; kernel '
        f'launches {counts}')
    check(counts['ccf_chisq'] == 0 and all(
        v > 0 for k, v in counts.items() if k != 'ccf_chisq'),
        f'bruteforce path launches: {counts}')
    rv = fitsio.read(desi.output_paths(path, outdir)[0])['RVTAB'].data
    desc = desi.get_column_desc([s.upper() for s in SETUPS])
    want = [k for k in desc if k not in OPTIONAL_COLUMNS
            and not (k.endswith('_CCF') and k != 'VRAD_CCF')]
    check(set(rv) == set(want) and all(
        rv[k].dtype == np.dtype(desc[k][0]) for k in want),
        f'bruteforce RVTAB columns {sorted(rv)}')
    ok = np.abs(rv['VRAD'] - truth['vel']) < np.maximum(
        10.0, 5 * rv['VRAD_ERR'])
    log(f'DESI bruteforce RV recovery {int(ok.sum())}/8; RVTAB has the '
        'schema without the CCF columns but VRAD_CCF')
    check(ok.sum() >= 0.98 * 8, f'bruteforce RV recovery {ok.sum()}/8')
    return dict(counts=counts, wall=wall)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this '
              'script runs only on a CUDA card', file=sys.stderr)
        return 2
    try:
        from rvspecfit_torch import convert
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
    res_adj = check_adjoint(tm, arms, truth, device)
    bank_nocont = make_nocont_bank(device)
    res_b = check_kernel_b(arms, {'continuum': banks[arms[0].name],
                                  'no-continuum': bank_nocont}, device)

    t0 = time.perf_counter()
    run_group_fit(tm, arms, banks)
    log(f'group fit cold pass: {time.perf_counter() - t0:.2f} s')
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_group_fit(tm, arms, banks)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    log('group fit warm pass: ' + ' '.join(
        f'{k}={out["phases"][k]:.3f}s' for k in PHASES)
        + f' total={wall:.3f}s -> {NFIBERS / wall:.1f} fibers/s')
    log(f'NM: {int(out["nm"]["converged"].sum())}/{NFIBERS} converged, '
        f'{out["nm"]["obj_evals"]} objective trials; polish moved '
        f'{int((out["fun"] < out["nm"]["fun"]).sum())}/{NFIBERS}; '
        f'refinement passes {int(out["ref"]["iterations"][0])}; '
        f'BAD_HESSIAN {int(out["bad_hess"].sum())}/{NFIBERS}')
    log(f'kernel launches in the warm pass: {counts}')
    check(all(v > 0 for v in counts.values()),
          f'a kernel of the path was not launched: {counts}')
    check_outputs(out, NFIBERS, NPIX_ARM)

    dv = out['ref']['best_vel'] - truth['vel']
    ok = np.abs(dv) < np.maximum(10.0, 5 * out['ref']['vel_err'])
    log(f'RV recovery: {int(ok.sum())}/{NFIBERS} within max(10, 5 sigma); '
        f'median |dv| {np.median(np.abs(dv)):.3f} km/s, median sigma_v '
        f'{np.median(out["ref"]["vel_err"]):.3f} km/s')
    check(ok.sum() >= 490, 'RV recovery below 490/500')

    tm_cpu = check_against_cpu(arms, bank, device, tm)
    del out

    from rvspecfit_torch import simulation
    cpu = torch.device('cpu')
    bank_d = banks[arms[0].name]
    bank_cpu = convert.ccf_bank(*bank, device=cpu)
    with tempfile.TemporaryDirectory() as workdir:
        drv = run_driver(workdir, tm, bank_d)
        group = drv['records'][-1]
        log(f'kernels at the shapes of a {group["nfibers"]}-fiber driver '
            'group:')
        res_a_grp = check_kernel_a(tm, group['arms'], drv['truth'], device)
        res_adj_grp = check_adjoint(tm, group['arms'], drv['truth'], device)
        res_b_grp = check_kernel_b(group['arms'], {'continuum': bank_d},
                                   device)['continuum']
        per_group = [r['launches'] for r in drv['records']]
        drv['records'] = group = None
        cmp_arms, _ = simulation.make_exposure(8, npix_arm=NPIX_ARM,
                                               snr=50.0, seed=7)
        # ROADMAP C.1: the Nelder-Mead's end points (float64 bookkeeping)
        # against the float64 run, beside float32 and float64 witnesses
        tm64 = make_template_model(device, dtype=torch.float64)
        nm8 = driver_against_cpu(workdir, 'coadd8', cmp_arms,
                                 {'cuda': tm, 'cpu': tm_cpu},
                                 {'cuda': bank_d, 'cpu': bank_cpu},
                                 witness64=tm64)
        res_data, bands, _ = resolution_exposure(NFIB_RES, seed=8)
        narrow = {key: make_template_model(d, wresol=RES_SIGMA0)
                  for key, d in (('cuda', device), ('cpu', cpu))}
        narrow64 = make_template_model(device, wresol=RES_SIGMA0,
                                       dtype=torch.float64)
        # parameters at each run's own optimum are logged, not checked:
        # over 64 fibers the Nelder-Mead ends up to ~0.8 sigma from the
        # float64 one with or without the kernels, and with a float64
        # objective from the card's CCF starts too (the witnesses,
        # PERF.md, ROADMAP C.1); the chi-square and the Hessian are
        # checked at one point instead
        nm64 = driver_against_cpu(
            workdir, f'coadd{NFIB_RES}res', res_data, narrow,
            {'cuda': bank_d, 'cpu': bank_cpu}, bands=bands,
            config=dict(CONFIG, lsf_sigma0_angstrom={
                s: RES_SIGMA0 for s in SETUPS}), check_params=False,
            witness64=narrow64)
        del narrow64
        log(f'NM end points (ROADMAP C.1), max |dp|/sigma and fibers over '
            f'0.5: coadd8 {nm8}; coadd{NFIB_RES}res {nm64}')

        models = {'cuda': tm, 'cpu': tm_cpu, 'narrow_cuda': narrow['cuda'],
                  'narrow_cpu': narrow['cpu']}
        bks = {'cuda': bank_d, 'cpu': bank_cpu}
        single = run_single_object(models, bks)
        objs, _ = single_objects()
        res_b1 = kernel_b_single(objs[0][0], bank_d)
        wv = run_weave(workdir, models, bks, tm64)
        del tm64
        bf = run_bruteforce(workdir, tm, bank_d)

    check('jax' not in sys.modules and 'rvspecfit_tpu' not in sys.modules,
          'the run imported jax or the JAX package')
    dc = drv['counts']
    shared, row = res_a['shared'], res_a['per-row']
    cont, nocont = res_b['continuum'], res_b['no-continuum']
    g_shared, g_row = res_a_grp['shared'], res_a_grp['per-row']
    group_n = COALESCE * NFIBERS
    sc, wc, bc = single['counts'], wv['counts'], bf['counts']
    calls = single['cuda']['calls']

    def per_call(name, key='process_launches'):
        return [c[key][name] for c in calls]
    kernels = [
        dict(name='spline_eval', route='cuda',
             source='rvspecfit_torch/csrc/spline_eval.cu',
             replaces='rvspecfit_tpu/ops/pallas_spline.py:200',
             launches=dc['spline_eval'],
             launches_per_row_mode=dc['spline_eval_per_row'],
             launches_shared_mode=dc['spline_eval_shared'],
             launches_per_driver_group=[g['spline_eval'] for g in per_group],
             launches_group_fit_warm_pass=counts['spline_eval'],
             launches_single_object_phase=sc['spline_eval'],
             launches_per_process_call_per_row_mode=per_call(
                 'spline_eval_per_row'),
             launches_per_process_call_shared_mode=per_call(
                 'spline_eval_shared'),
             launches_weave_file=wc['spline_eval'],
             launches_weave_file_per_row_mode=wc['spline_eval_per_row'],
             launches_weave_file_shared_mode=wc['spline_eval_shared'],
             launches_desi_bruteforce=bc['spline_eval'],
             max_abs_err=max(r['max_abs_err'] for r in
                             (*res_a.values(), *res_a_grp.values())),
             ms=shared['ms'], plain_ms=shared['plain_ms'],
             bound_ms=shared['bound_ms'], bound_by='bytes',
             library_ms=None,
             ms_per_row_mode=row['ms'],
             ms_per_row_mode_eager=row['eager_ms'],
             plain_ms_per_row_mode=row['plain_ms'],
             bound_ms_per_row_mode=row['bound_ms'],
             **{f'{k}_B{group_n}': v for k, v in (
                 ('ms', g_shared['ms']), ('plain_ms', g_shared['plain_ms']),
                 ('bound_ms', g_shared['bound_ms']),
                 ('ms_per_row_mode', g_row['ms']),
                 ('plain_ms_per_row_mode', g_row['plain_ms']),
                 ('bound_ms_per_row_mode', g_row['bound_ms']))}),
        dict(name='ccf_chisq', route='cuda',
             source='rvspecfit_torch/csrc/ccf_chisq.cu',
             replaces='rvspecfit_tpu/ops/pallas_ccf.py:159',
             launches=dc['ccf_chisq'],
             launches_per_driver_group=[g['ccf_chisq'] for g in per_group],
             launches_group_fit_warm_pass=counts['ccf_chisq'],
             launches_single_object_phase=sc['ccf_chisq'],
             launches_per_ccf_fit=per_call('ccf_chisq', 'ccf_launches'),
             launches_weave_file=wc['ccf_chisq'],
             launches_desi_bruteforce=bc['ccf_chisq'],
             max_abs_err=max(cont['max_abs_err'], res_b_grp['max_abs_err'],
                             res_b1['max_abs_err']),
             ms=cont['ms'],
             plain_ms=cont['plain_ms'], bound_ms=cont['bound_ms'],
             bound_by=cont['bound_by'], library_ms=cont['library_ms'],
             max_abs_err_no_continuum=nocont['max_abs_err'],
             ms_no_continuum=nocont['ms'],
             plain_ms_no_continuum=nocont['plain_ms'],
             bound_ms_no_continuum=nocont['bound_ms'],
             **{f'{k}_B{group_n}': res_b_grp[k] for k in (
                 'ms', 'plain_ms', 'bound_ms', 'library_ms')},
             **{f'{k}_B1': res_b1[k] for k in (
                 'max_abs_err', 'ms', 'eager_ms', 'plain_ms', 'bound_ms',
                 'bound_by', 'library_ms')}),
        dict(name='spline_eval_adjoint', route='cuda',
             source='rvspecfit_torch/csrc/spline_eval.cu',
             replaces='rvspecfit_tpu/fit/batch.py:396',
             launches=dc['spline_eval_adjoint'],
             launches_per_driver_group=[g['spline_eval_adjoint']
                                        for g in per_group],
             launches_group_fit_warm_pass=counts['spline_eval_adjoint'],
             launches_single_object_phase=sc['spline_eval_adjoint'],
             launches_per_process_call=per_call('spline_eval_adjoint'),
             launches_weave_file=wc['spline_eval_adjoint'],
             launches_desi_bruteforce=bc['spline_eval_adjoint'],
             max_abs_err=max(res_adj['max_abs_err'],
                             res_adj_grp['max_abs_err']),
             ms=res_adj['ms'],
             plain_ms=res_adj['plain_ms'], bound_ms=res_adj['bound_ms'],
             bound_by='bytes', library_ms=None,
             ms_eager=res_adj['eager_ms'],
             **{f'{k}_B{group_n}': res_adj_grp[k] for k in (
                 'ms', 'plain_ms', 'bound_ms')}),
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
