#!/usr/bin/env python3
"""Drive the rvspecfit_torch group fit, DESI and WEAVE drivers, the
single-object fit, the NN trainer and a trained NN template library,
the RV pull harness and the offline template pipeline on one CUDA
card, in float64 (the port's working type), and check them.

Usage (from the root of a checkout, on a machine with one NVIDIA card
and the CUDA toolkit):

    python3 chip_smoke.py

1. Builds the CUDA kernels from rvspecfit_torch/csrc with nvcc
   (sm_90a, one nvcc per source, all started together) into
   rvspecfit_torch/_build/.
2. Compares each kernel, in its float64 and its float32 form, with its
   plain PyTorch version on the card at the main path's shapes (kernel
   A in both modes, and per-row in float64 at Nelder-Mead's cand4
   shape, four trial rows per fiber: 2000 and 4000 x 1024; its adjoint
   at the polish's shape, kernel B with and without continuum, two
   launches bit-equal), and times both with
   CUDA events beside the least time the card could take for the work
   (bound_ms) and, for kernel B, one torch.matmul of its materialized
   contraction in the same dtype (library_ms, a yardstick the port
   never calls, timed as the kernel is).
3. Drives survey/desi._run_group_fit on bench.py's workload: a
   synthetic 500-fiber, 3-arm exposure against the 864-template grid
   (built through pipeline/library.template_model_from_artifacts) ->
   batched CCF first guess (kernel B) -> Nelder-Mead (kernel A) ->
   gradient polish (kernel A and its adjoint, AD Hessians) -> velocity
   refinement (kernel A, shared mode) -> AD Hessian errors -> best-fit
   models; a cold pass, then a timed warm pass whose kernel launches
   are counted, in float64 (only float64 kernels may launch) and then
   in float32 (a template model and bank built with dtype=float32: the
   float32 kernels), for the cost of float64.
4. Checks RV recovery against the injected velocities, that the polish
   raised no fiber's objective, and the group fit on 8 fibers
   (velocities and polished parameters within sigma/2, the Hessian at
   one point) against the CPU float64 run of the same code; the
   float32 run of the same 8 fibers is logged beside it.
5. Drives the DESI driver, survey/desi.proc_many, over 4 coadd files of
   500 fibers in bench.py's format, written with the port's FITS module
   into a temporary directory, at coalesce 2 (two groups of 1000
   fibers, the first cold) with crash isolation off and in-memory
   models and banks (the card's machine has no h5py); its kernel
   launches are counted per run and per group.  Checks the status
   lines, the RVTAB schema and rows, RV recovery per file and RVMOD;
   prints per-file seconds, the steady fibers/s from the status file's
   completion times and each group's phases; then the same files in
   float32 for the time.  Holds the kernels against their plain
   versions at a 1000-fiber group's shapes, and the driver's RVTAB on
   the card against the CPU float64 run for an 8-fiber coadd and a
   8-fiber coadd with per-fiber resolution matrices
   (--resolution_matrix, width-11 Gaussian bands): velocities and
   parameters within sigma/2 (ROADMAP C.1).
6. The single-object fit on 2 objects of the 3-arm layout at full
   width: fit/ccf.fit (kernel B at one fiber row) -> vel_fit.process
   (scan, float64-bookkept Nelder-Mead, BFGS with the autograd
   gradient, refinement, models, AD Hessian: kernel A in both modes
   and its adjoint), firstguess on both and one process with a
   Gaussian resolution matrix per arm; kernel B checked and timed at
   B = 1 in both modes.  Checks RV recovery, every kernel launched,
   and the card against the CPU float64 run of the same calls but
   firstguess: ccf.fit's template and velocity (within 0.01 km/s,
   ROADMAP C.2), velocities and parameters within sigma/2; prints
   seconds per call and stage, BFGS calls and launches per call; then
   ccf.fit and process in float32 for the time and ccf.fit's float32
   velocities.
7. The WEAVE driver, survey/weave.proc_many, over a 500-fiber red +
   blue pair (two 1024-px arms inside the synthetic grid's range):
   status line, WEAVE_RV columns, RV recovery, fibers/s (and in
   float32 for the time); an 8-fiber pair on the card against the CPU
   (velocities and parameters within sigma/2).
8. The DESI driver with ``--param_init bruteforce`` (ccf_init=False) on
   an 8-fiber coadd: RVTAB schema and RV recovery.
9. The NN trainer (pipeline/train_nn.train_interpolator) on the card
   at the reference CLI's widths (256 wide, 2 hidden layers, npc 64,
   batch 100, lr0 1e-3, patience 20) on 24,960 templates x 4096 px,
   cut to TRAIN_EPOCHS epochs: seconds per epoch, steps/s, first and
   last epoch's loss (the last must be <= 0.3 of the first), peak
   device memory; then 2 epochs on a 2000-template subset on the card
   (profiled: kernels and device time per step) and on the CPU from one
   init_state draw: losses and weights within 1e-9.
10. The NN cell through the trained model (its checkpoint payload
   through pipeline/library), two 500-fiber coadds of spectra drawn
   from that model at known parameters and velocities, through
   survey/desi.proc_many at coalesce 2 with a CCF bank of the model at
   the 6,6,6,4 grid's nodes: RV recovery per file, every kernel
   launched, the BAD_HESSIAN share.
11. The RV pull harness (validation.run_accuracy) at its defaults on
   1000 trials: pull std within [0.9, 1.1]; 8 trials on the card and
   on the CPU: velocities within sigma/2.
12. The offline template pipeline through each stage's core (the
   card's machine has no h5py for the writers): the 6,6,6,4 grid as
   864 FITS templates of 20,000 px with PHOENIX keywords ->
   read_grid.makedb -> mask_grid's PHOENIX rules -> make_interpol with
   DESI's options (R = x/1.55, step 0.4 A, 4600-5400 A, float32) ->
   make_nd's regular grid -> make_ccf's bank (vsinis 0 and 300, every
   8: 216 templates x 1025 frequencies) with its continua fitted on the
   card, held against the same bank built on the CPU (rtol 1e-8);
   kernel B against its plain version at the bank's shapes; 500 fibers
   of 3 arms drawn from the library through survey/desi._run_group_fit
   with the card-built bank: RV recovery, every kernel launched, and 8
   fibers against the CPU float64 run (velocities and parameters
   within sigma/2); each stage's seconds.
13. The fleet: 2 coadds of 500 fibers (seeds 100-101) through
   survey/desi.proc_many at coalesce 1, run 1 in this process over the
   static list, run 2 by two rank processes of this script on the one
   card (``chip_smoke.py --fleet-rank RANK HOST:PORT DIR``), which join
   a world on 127.0.0.1 through the driver's own wiring
   (survey/desi.fleet, parallel/distributed's TCPStore), claim the
   files through --dynamic_queue and write per-rank status and log
   files.  A rank that exits non-zero fails the phase.  Checks every
   file fitted exactly once across the ranks, RV recovery per file, and
   every fiber of run 2 within sigma/100 of run 1; prints the walls,
   files and s/file per rank, the aggregate files/s of 2 ranks against
   1 and each rank's peak device memory.
14. Fiber microbatching: _run_group_fit on 1000 fibers whole and with
   config fit_microbatch=500: wall, phases and peak device memory of
   each (and of the untiled CCF start); every fiber within sigma/100,
   RV recovery.
15. One vel_fit.process with options fast_interp (nearest-pixel
   templates) on the card, its chi-square at the optimum on the card
   against the CPU (rtol 1e-9).
16. pipeline/prewarm's core on a 64-fiber synthetic coadd.
17. The drivers' overlaps: 4 coadds of 500 fibers (seeds 100-103)
   through survey/desi.proc_many at coalesce 2 with the switches
   RVST_PIPELINE_PREP, RVST_DEFER_TAIL and RVST_ASYNC_WRITE at 0, then
   at their defaults, and again in reverse order in phase 21 (every
   earlier driver phase runs at the defaults too).  Checks every file
   written once, the status lines in input order, RV recovery per file
   and every fiber of the overlapped run within sigma/100 of the
   serial run; prints the steady s/file from the status stamps, the
   cold group, the peak device memory and the launches of each run.
   Then survey/weave.proc_many over two 8-fiber pairs without and with
   the next pair's prefetch: tables equal.
18. The mesh: _run_group_fit on the 500-fiber exposure with its fitter
   sharded over ('cuda:0', 'cuda:0') (parallel/mesh, two shards and
   host threads on the one card) against unsharded: every fiber within
   sigma/100, every kernel launched; auto_shard does nothing on one
   card.
19. Nelder-Mead's candidate schemes: _run_group_fit on the 500-fiber
   exposure under RVST_NM_SCHEME scan2, cand4, cand4, scan2 (in
   alternating order).  Checks RV recovery, every kernel launched, NM's
   objective calls per iteration (1 under cand4, 2 under scan2, shrink
   steps apart), obj_evals per fiber and iteration (4 and 2), every
   fiber within sigma/2 of the first scan2 run, and the 8-fiber group
   fit under cand4 on the card against the CPU float64 run
   (velocities within max(1 km/s, sigma/2), parameters sigma/2);
   prints each run's NM wall, phases, kernel A's per-row launches in
   NM, obj_evals and peak memory.
20. The NN trainer on a (2, 2) (data, model) grid of the card named
   four times (parallel/mesh.make_grid, train_interpolator(mesh=)):
   2 epochs on phase 9's 2000-template subset at the CLI's widths,
   unsharded and on the grid from one init_state draw; every epoch's
   loss and every folded weight within 1e-9 of the unsharded run;
   s/epoch of both.  It runs right after phase 9, whose training set it
   shares.
21. Phase 17's runs again in reverse order, overlapped then serial,
   under torch.profiler, last, since a process runs slower after a
   profiler session: the same checks, every fiber within sigma/100 of
   phase 17's serial run, steady s/file and the card's busy share of
   each (the union of its kernel and copy intervals over the wall).

Every path's kernel launches are counted from 0 just before it runs.
Each phase prints its seconds and the script's seconds at its end.
Prints, last, the card, a JSON line of the kernels (each in its
float64 and float32 form) and then the ok line.  Exits non-zero,
printing no result, without a CUDA device or on any failure.
"""
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
# the kernels' forms: the working type first
FORMS = ('float64', 'float32')


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_time(fn, reps, graph=False):
    """Mean ms per call of fn() on the card, after one warm-up call
    (``reps`` with ``graph``: one on each of cold_inputs' copies, so
    that what a wrapper builds once per input is built before capture).

    Eager calls time the host's dispatch too where it is slower than
    the device; ``graph=True`` captures ``reps`` calls in a CUDA graph
    (each output in memory of its own) and replays it 10 times, which
    times the device alone (for launches of a few microseconds).
    """
    import torch
    for _ in range(reps if graph else 1):
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
    """Both kernel libraries through pipeline/prewarm.build_kernels (one
    nvcc per source, started together), and what nvcc reported."""
    from rvspecfit_torch import trace
    from rvspecfit_torch.pipeline import prewarm
    t0 = time.perf_counter()
    prewarm.build_kernels()
    log(f'kernel build: {time.perf_counter() - t0:.2f} s')
    for rec in trace.kept('kernel.build'):
        log(f'  {rec.attrs["kernel"]}: nvcc {rec.seconds:.2f} s; ptxas: '
            + ' | '.join(line.strip() for line in rec.attrs['ptxas']
                         .splitlines()
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
    the device's working dtype (float32 for the float32 runs)."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.pipeline.library import \
        template_model_from_artifacts
    return template_model_from_artifacts(
        *simulation.template_artifacts(6, 6, 6, 4, npix=4096, lam0=4550.0,
                                       lam1=5450.0, wresol=wresol),
        device=device, dtype=dtype)


def make_workload(device, dtype=None):
    t0 = time.perf_counter()
    tm = make_template_model(device, dtype=dtype)
    arms, truth = make_arms()
    bank = make_bank()
    log(f'workload: {NFIBERS} fibers x {len(arms)} arms x {NPIX_ARM} px, '
        f'{tm.state.dats.shape[0]} templates x {tm.geom.n} px '
        f'({tm.state.dats.dtype}), CCF bank {bank[0].shape[0]} x '
        f'{bank[0].shape[1]} frequencies ({time.perf_counter() - t0:.1f} s)')
    return tm, arms, truth, bank


# peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s, TF32
# and FP64 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP64_FLOPS = 67e12


def spline_bound_ms(u, nm1, rpc):
    """Least time of kernel A's work on these inputs from HBM: u read
    and out written once, plus the 4 coefficients (A, B, C, D) of every
    distinct interval each coefficient row's queries touch."""
    import torch
    es = u.element_size()
    idx = torch.clamp(torch.floor(torch.nan_to_num(u)), 0, nm1 - 1)
    idx = idx.reshape(-1, rpc * u.shape[1]).sort(1).values
    knots = float((idx.diff(dim=1) != 0).sum()) + idx.shape[0]
    nbytes = 2 * es * u.numel() + 4 * es * knots
    return 1e3 * nbytes / HBM_BYTES_PER_S


def ccf_bound(nb, nt, nf, nv, naccumulators, form):
    """Least time of kernel B's work and what bounds it: its GEMM (M =
    B T, N = V, K = 2F, one per accumulator), issued three times at the
    TF32 peak in the float32 form (3xTF32) and once at the FP64
    tensor-core peak in the float64 form, against the bytes of its
    inputs and output.  Returns (ms, 'operations' or 'bytes')."""
    es = 8 if form == 'float64' else 4
    passes, peak = (1, FP64_FLOPS) if form == 'float64' else (3, TF32_FLOPS)
    flops = passes * naccumulators * 2.0 * nb * nt * nv * 2 * nf
    nbytes = es * (2 * 2 * (nt + nb) * nf + 2 * nf * nv + nb * nt * nv)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def compare(got, want):
    """(max|got - want|, max|want|) after a synchronize."""
    import torch
    torch.cuda.synchronize()
    return (float((got - want).abs().max()), float(want.abs().max()))


def adjoint_bound_ms(u, nm1):
    """Least time of the adjoint's work from HBM: u and g read once and
    the dense (R, 4, nm1) output written once."""
    es = u.element_size()
    return 1e3 * (2 * es * u.numel() + 4 * es * u.shape[0] * nm1) \
        / HBM_BYTES_PER_S


# each kernel's limit against its plain version, relative to max|out|:
# the float32 forms' (3xTF32 for B), and in float64 the same number of
# rounding errors at float64's unit roundoff (2^-53 against 2^-24)
TOL32 = dict(A=1e-5, B=1e-4, ADJ=1e-5)
TOL = dict(float32=TOL32,
           float64={k: v * 2.0**-29 for k, v in TOL32.items()})


def as_form(tensors, form):
    """The tensors in ``form``'s real or complex dtype."""
    import torch
    from rvspecfit_torch.device import complex_of
    real = getattr(torch, form)
    return [t.to(complex_of(real) if t.is_complex() else real).contiguous()
            for t in tensors]


def make_nocont_bank(device):
    """A bank without continuum normalization from the same grid, on
    ``device``."""
    from rvspecfit_torch import convert
    return convert.ccf_bank(*make_bank(continuum=False), device=device)


def kernel_a_cases(tm, arms, truth, device):
    """Kernel A's inputs at the NM-step shape (one trial per fiber) and
    the refinement's full-pass shape (401 shared rows per fiber), for
    the B fibers of ``arms``, in the template model's dtype: (coeffs,
    [(mode, u, rows_per_coeff), ...])."""
    import torch
    from rvspecfit_torch.fit.likelihood import doppler_u, template_stage
    from rvspecfit_torch.fit.spec_data import ArmState
    dtype = tm.geom.h.dtype
    arm = ArmState.from_host('B', 'B', arms[0].lam, arms[0].flux,
                             1.0 / np.sqrt(arms[0].ivar), tm.geom,
                             device=device, dtype=dtype)
    params = torch.as_tensor(np.stack([truth[k] for k in
                                       ('teff', 'logg', 'feh', 'alpha')], 1),
                             dtype=dtype, device=device)
    coeffs = template_stage(tm, params, None, False, None)[0]
    vels = torch.as_tensor(truth['vel'], dtype=dtype, device=device)
    u_row = doppler_u(arm, tm.geom, vels)                       # (B, 1024)
    grid = torch.linspace(-1000, 1000, 401, dtype=dtype, device=device)
    # (401 B, 1024)
    u_shared = doppler_u(arm, tm.geom, grid.repeat(arm.dvec.shape[0]))
    return coeffs, [('per-row', u_row, 1), ('shared', u_shared, 401)]


# Nelder-Mead's candidates per fiber and call under RVST_NM_SCHEME=cand4
NCAND4 = 4


def kernel_a_cand4_case(tm, arms, truth, device):
    """Kernel A's per-row inputs at the NM call's shape under cand4: four
    trial points per fiber (reflection, expansion and both contractions
    around each fiber's truth; seeded offsets kept inside the truths'
    ranges), each row its own coefficients: (coeffs (4B, 4, n - 1),
    [('per-row cand4', u (4B, 1024), 1)])."""
    import torch
    from rvspecfit_torch.fit.likelihood import doppler_u, template_stage
    from rvspecfit_torch.fit.spec_data import ArmState
    dtype = tm.geom.h.dtype
    arm = ArmState.from_host('B', 'B', arms[0].lam, arms[0].flux,
                             1.0 / np.sqrt(arms[0].ivar), tm.geom,
                             device=device, dtype=dtype)
    names = ('teff', 'logg', 'feh', 'alpha')
    p = np.repeat(np.stack([truth[k] for k in names], 1), NCAND4, axis=0)
    rng = np.random.RandomState(5)
    p = np.clip(p * (1 + 0.02 * rng.normal(size=p.shape)),
                p.min(0), p.max(0))
    params = torch.as_tensor(p, dtype=dtype, device=device)
    coeffs = template_stage(tm, params, None, False, None)[0]
    vels = np.repeat(truth['vel'], NCAND4) + 5.0 * rng.normal(size=len(p))
    u = doppler_u(arm, tm.geom, torch.as_tensor(vels, dtype=dtype,
                                                device=device))
    return coeffs, [('per-row cand4', u, 1)]


def check_kernel_a(tm, arms, truth, device, cases=kernel_a_cases,
                   forms=FORMS):
    """Kernel A vs plain on the card at the path's shapes (``cases``:
    kernel_a_cases, both modes, or kernel_a_cand4_case), in ``forms``:
    {form: {mode: numbers}}.

    Both modes are timed with inputs read from HBM, as the bound
    assumes: the shared mode's u (1.6 GB in float64) exceeds L2; the
    per-row mode (a few us) is timed from CUDA-graph replays over
    L2_COPIES copies of its inputs, and also eagerly, one call at a time
    (the host's dispatch, as the path launches it)."""
    from rvspecfit_torch.ops import spline_eval
    coeffs64, cases = cases(tm, arms, truth, device)
    result = {form: {} for form in forms}
    for mode, u64, rpc in cases:
        for form in forms:
            coeffs, u = as_form((coeffs64, u64), form)

            def call(c, uu):
                return spline_eval.spline_eval_index(tm.geom, c, uu, rpc)
            err, scale = compare(
                call(coeffs, u),
                spline_eval.spline_eval_index_plain(tm.geom, coeffs, u, rpc))
            eager_ms = cuda_time(lambda: call(coeffs, u), 20)
            ms = eager_ms if rpc > 1 else cuda_time(
                cold_inputs(call, coeffs, u), 2 * L2_COPIES, graph=True)
            plain_ms = cuda_time(lambda: spline_eval.spline_eval_index_plain(
                tm.geom, coeffs, u, rpc), 3)
            bound = spline_bound_ms(u, coeffs.shape[-1], rpc)
            lim = TOL[form]['A'] * scale
            log(f'kernel A {mode} {form}: rows {u.shape[0]} x {u.shape[1]} '
                f'px, coeffs {tuple(coeffs.shape)}: max|diff| {err:.3e} '
                f'(limit {lim:.3e}); kernel {ms:.4f} ms (eager '
                f'{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound '
                f'{bound:.4f} ms (HBM bytes) -> {100 * bound / ms:.1f}% of it')
            check(np.isfinite(err) and err <= lim,
                  f'kernel A ({mode}, {form}) disagrees with its plain '
                  'version')
            check(ms >= bound, f'kernel A ({mode}, {form}) ran under its '
                  'bound: the bound or the timing is wrong')
            result[form][mode] = dict(max_abs_err=err, ms=ms,
                                      eager_ms=eager_ms, plain_ms=plain_ms,
                                      bound_ms=bound)
            del coeffs, u
    return result


def kernel_b_args(arms, bank):
    """Kernel B's inputs for the first arm of the exposure against a
    device bank, in the bank's precision: (args, continuum)."""
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
    the no-continuum mode), in both forms (the float32 form on the
    float64 inputs rounded to float32): {form: {mode: numbers}}."""
    result = {form: {} for form in FORMS}
    for mode, bank in banks.items():
        args64, cont = kernel_b_args(arms, bank)
        check(cont == (mode == 'continuum'),
              f'the {mode} bank has continuum={cont}')
        for form in FORMS:
            result[form][mode] = kernel_b_case(as_form(args64, form), cont,
                                               f'kernel B {mode} {form}',
                                               form)
    return result


def kernel_b_case(args, cont, label, form, graph=False):
    """Kernel B's wrapper vs its plain version on ``args``, both timed,
    and the continuum contraction as one torch.matmul in the same
    dtype (library_ms).  The float64 kernel builds its bank operands
    on its first call on a bank, as on the path (on the cold copies in
    cuda_time's warm-up).  ``graph``: time the wrapper and the matmul
    from CUDA-graph replays over L2_COPIES copies of their inputs
    (calls of a few microseconds, inputs from HBM), each beside its
    warm eager time; at many rows the inputs exceed L2 anyway and both
    are timed eagerly."""
    import torch
    from rvspecfit_torch.ops import ccf_chisq

    def call(*a):
        return ccf_chisq.ccf_chisq(*a, continuum=cont)
    err, scale = compare(call(*args),
                         ccf_chisq.ccf_chisq_plain(*args, continuum=cont))
    again = call(*args)
    check(bool(torch.equal(again, call(*args))),
          f'{label}: two launches differ')
    eager_ms = cuda_time(lambda: call(*args), 10)
    ms = cuda_time(cold_inputs(call, *args), 2 * L2_COPIES, graph=True) \
        if graph else eager_ms
    plain_ms = cuda_time(lambda: ccf_chisq.ccf_chisq_plain(
        *args, continuum=cont), 3)
    shape = (args[2].shape[0], args[0].shape[0], args[0].shape[1],
             args[4].shape[1])
    bound, bound_by = ccf_bound(*shape, 1 if cont else 2, form)
    library_ms = library_eager_ms = None
    if cont:
        mat, e = ccf_chisq.contraction_operands(*args, continuum=True)
        mat = mat[0]
        library_eager_ms = cuda_time(lambda: torch.matmul(mat, e), 5)
        library_ms = cuda_time(cold_inputs(torch.matmul, mat, e),
                               2 * L2_COPIES, graph=True) \
            if graph else library_eager_ms
        del mat, e
    lim = TOL[form]['B']
    log(f'{label}: at B,T,F,V = {shape}: max|diff| {err:.3e}, '
        f'{err / scale:.3e} of max|out| (limit {lim:.3e}), relaunch '
        f'bit-equal; kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), plain '
        f'{plain_ms:.3f} ms, library '
        f'{library_ms if library_ms is None else round(library_ms, 4)} ms ('
        + ('graph replays over cold copies like the kernel; warm eager '
           f'{library_eager_ms:.4f} ms' if graph and cont else
           'eager: its (B T, 2F) operand exceeds L2') +
        f'), bound {bound:.4f} ms ({bound_by}) -> '
        f'{100 * bound / ms:.1f}% of it')
    check(np.isfinite(err) and err <= lim * scale,
          f'{label} disagrees with its plain version')
    return dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
                library_eager_ms=library_eager_ms)


def adjoint_inputs(tm, arms, truth, device):
    """The adjoint's inputs at the polish's shape (one row per fiber,
    500 x 1024 queries on 4095 intervals), in the template model's
    dtype: (u, g, nm1), g a seeded upstream gradient."""
    import torch
    coeffs, cases = kernel_a_cases(tm, arms, truth, device)
    u = cases[0][1]
    g = torch.as_tensor(np.random.RandomState(1).normal(size=u.shape),
                        dtype=u.dtype, device=device)
    return u, g, coeffs.shape[-1]


def check_adjoint(tm, arms, truth, device):
    """Kernel A's adjoint vs its plain version at the polish's shape
    with a seeded upstream gradient (adjoint_inputs), in both forms;
    timed from HBM (CUDA-graph replays over L2_COPIES copies of its
    inputs) and eagerly; two launches must give the same bits."""
    import torch
    from rvspecfit_torch.ops import spline_eval
    u64, g64, nm1 = adjoint_inputs(tm, arms, truth, device)
    result = {}
    for form in FORMS:
        u, g = as_form((u64, g64), form)

        def call(uu, gg):
            return spline_eval.spline_eval_index_vjp(tm.geom, uu, gg, nm1)
        got = call(u, g)
        err, scale = compare(got, spline_eval.spline_eval_index_vjp_plain(
            tm.geom, u, g, nm1))
        check(torch.equal(got, call(u, g)),
              f'the {form} adjoint gave other bits on a second launch')
        ms = cuda_time(cold_inputs(call, u, g), 2 * L2_COPIES, graph=True)
        eager_ms = cuda_time(lambda: call(u, g), 20)
        plain_ms = cuda_time(lambda: spline_eval.spline_eval_index_vjp_plain(
            tm.geom, u, g, nm1), 5)
        bound = adjoint_bound_ms(u, nm1)
        lim = TOL[form]['ADJ'] * scale
        log(f'adjoint {form}: rows {u.shape[0]} x {u.shape[1]} px -> (R, 4, '
            f'{nm1}): max|diff| {err:.3e} (limit {lim:.3e}); kernel '
            f'{ms:.4f} ms (eager {eager_ms:.4f} ms), plain {plain_ms:.4f} '
            f'ms, bound {bound:.4f} ms (HBM bytes) -> '
            f'{100 * bound / ms:.1f}% of it; bit-equal on relaunch')
        check(np.isfinite(err) and err <= lim,
              f'the {form} adjoint disagrees with its plain version')
        check(ms >= bound, f'the {form} adjoint ran under its bound: the '
              'bound or the timing is wrong')
        result[form] = dict(max_abs_err=err, ms=ms, eager_ms=eager_ms,
                            plain_ms=plain_ms, bound_ms=bound)
    return result


def run_group_fit(tm, arms, banks):
    """The port's main path: survey/desi._run_group_fit on the exposure
    (all arms share the template model and the bank), its tail on this
    thread (defer=False), so that the call's wall and launches are the
    whole fit's."""
    from rvspecfit_torch.survey import desi
    return desi._run_group_fit(arms, {a.name: tm for a in arms}, CONFIG,
                               OPTIONS, banks=banks, defer=False)


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


# each kernel's launch counter in rvspecfit_torch.trace, by the name
# this script gives it, before the form
KERNELS = dict(spline_eval_per_row='kernel_a.per_row',
               spline_eval_shared='kernel_a.shared', ccf_chisq='kernel_b',
               spline_eval_adjoint='kernel_a_adjoint')


def kernel_counts():
    """Launches since the last reset by form and kernel: {form: {kernel:
    n}} (rvspecfit_torch.trace's counters)."""
    from rvspecfit_torch import trace
    c = trace.counters()
    return {f: {k: c.get(f'{name}.{f}', 0) for k, name in KERNELS.items()}
            for f in FORMS}


def reset_counts():
    from rvspecfit_torch import trace
    for name in KERNELS.values():
        trace.reset_counters(name + '.')


def check_launches(name, counts, form='float64', unused=()):
    """Every kernel of the path but ``unused`` launched in ``form``, and
    none in the other form."""
    other = [f for f in FORMS if f != form][0]
    check(all(v > 0 for k, v in counts[form].items() if k not in unused)
          and not any(v for k, v in counts[form].items() if k in unused),
          f'{name}: a kernel of the path was not launched in {form}: '
          f'{counts}')
    check(not any(counts[other].values()),
          f'{name}: the {form} run launched {other} kernels: {counts}')


def diff_counts(after, before):
    return {f: {k: after[f][k] - before[f][k] for k in KERNELS}
            for f in FORMS}


@contextlib.contextmanager
def ccf_result(record):
    """Record the group fit's CCF results into the list ``record``."""
    from rvspecfit_torch.fit import ccf
    from rvspecfit_torch.survey import desi
    real = ccf.fit_batch

    def fit_batch(*args, **kwargs):
        record.append(real(*args, **kwargs))
        return record[-1]
    with mock.patch.object(desi.ccf_mod, 'fit_batch', fit_batch):
        yield


def float32_models(device, bank, wresol=2.0):
    """The float32 template model and device bank of the float32 runs
    (explicit dtype=float32)."""
    import torch
    from rvspecfit_torch import convert
    return (make_template_model(device, wresol=wresol, dtype=torch.float32),
            convert.ccf_bank(*bank, device=device, dtype=torch.float32))


def check_against_cpu(arms, bank, device, tm, tm32, bank32):
    """The group fit on 8 fibers on the card (float64, kernels) against
    the CPU float64 run: the CCF's templates, the velocities within
    max(1 km/s, sigma/2) and the polished parameters within sigma/2,
    the CPU's sigma, and the Hessian at one point
    (hessians_at_one_point).  The float32 kernels' run of the same 8
    fibers is logged beside it (what float64 bought)."""
    from rvspecfit_torch import convert
    from rvspecfit_torch.fit.batch import BatchArm
    cpu = 'cpu'
    sub = [BatchArm(a.name, a.lam, a.flux[:8], a.ivar[:8]) for a in arms]
    tm_cpu = make_template_model(cpu)
    runs = dict(cuda=(tm, convert.ccf_bank(*bank, device=device)),
                cpu=(tm_cpu, convert.ccf_bank(*bank, device=cpu)),
                cuda32=(tm32, bank32))
    small, cres = {}, {}
    for key, (tm_d, bank_d) in runs.items():
        rec = []
        with ccf_result(rec):
            small[key] = run_group_fit(tm_d, sub, {a.name: bank_d
                                                   for a in sub})
        cres[key] = rec[0]
    gc = small['cpu']
    vc = gc['ref']['best_vel']
    lim = np.maximum(1.0, 0.5 * gc['ref']['vel_err'])
    stats = {}
    for key in ('cuda', 'cuda32'):
        g = small[key]
        dv = np.abs(g['ref']['best_vel'] - vc)
        dp = np.abs(g['params'] - gc['params']) / gc['errs']
        same = int((cres[key]['best_id'] == cres['cpu']['best_id']).sum())
        dccf = float(np.abs(cres[key]['best_vel'] - cres['cpu']['best_vel'])
                     .max())
        stats[key] = dict(max_dv=float(dv.max()), max_dv_lim=float(
            (dv / lim).max()), max_dp=float(np.nanmax(dp)),
            over=int((dp > 0.5).any(1).sum()), same_ccf=same,
            max_dv_ccf=dccf)
        log(f'8-fiber group fit, {"float64" if key == "cuda" else "float32"}'
            f' kernels vs CPU float64: max|dv| {dv.max():.6f} km/s '
            f'({(dv / lim).max():.6f} of max(1, sigma/2)); polished '
            f'parameters max|dp|/sigma {np.nanmax(dp):.6f}, over 0.5 for '
            f'{stats[key]["over"]}; same CCF template {same}/{len(vc)}, CCF '
            f'velocities max|dv| {dccf:.6f} km/s')
    s = stats['cuda']
    check(s['max_dv_lim'] <= 1, 'the card\'s velocities disagree with the '
          'CPU float64 ones')
    check(s['max_dp'] <= 0.5, 'the card\'s polished parameters disagree '
          'with the CPU float64 ones (ROADMAP C.1)')
    check(s['same_ccf'] == len(vc), 'the card\'s CCF picks other templates '
          'than the CPU (ROADMAP C.2)')
    hessians_at_one_point(sub, {'cuda': tm, 'cpu': tm_cpu}, gc)
    return tm_cpu, stats


# the card's Hessian errors against the CPU's at one point
ERR_TOL = 0.02
# the card's chi-square against the CPU's at one point: the change of
# chi-square over half a standard error in one parameter
CHI_TOL = 0.25


def hessians_at_one_point(sub, tms, gc):
    """The chi-square and the Hessian at the CPU run's refined
    velocities and polished parameters, on the card and on the CPU
    (both float64: their difference is the card's summation order).
    The chi-squares may differ by at most CHI_TOL.  In correlation form
    (D H D, D = |diag H_CPU|^-1/2) the Hessians' difference is E; a
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
    log(f'  at one point (the CPU optimum), card vs CPU: |dchi2| '
        f'{show(dchi)} (limit {CHI_TOL}); Hessians max|E| per fiber '
        f'{show(e)}; CPU min|eigenvalue| {show(lam)} (min '
        f'{lam.min():.3g}); errors max |rel diff| (limit {ERR_TOL}, good '
        f'Hessians) {show(rel[good])}; BAD_HESSIAN card '
        f'{int(bad["cuda"].sum())}, CPU {int(bad["cpu"].sum())}, '
        f'differing {int((bad["cuda"] != bad["cpu"]).sum())}')
    check((dchi <= CHI_TOL).all(),
          'the card\'s chi-square at one point disagrees with the CPU')
    check(((bad['cuda'] == bad['cpu']) | may_flip).all(),
          'a BAD_HESSIAN flag differs where rounding cannot flip it')
    check((rel[good] <= ERR_TOL).all(),
          'the card\'s Hessian errors at one point disagree with the CPU')


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
NFIB_RES = 8
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
    fibers, the seconds it held the driver's thread (with the deferred
    tail, up to the tail's dispatch), the kernel launches and the peak
    device memory in that time (other threads' work, the previous
    group's tail and the next group's CCF, blurs both), its arms and its
    result (read only after the driver is done, so that reading it
    does not collect a deferred tail early; its phases are measured on
    the threads that ran them)."""
    from rvspecfit_torch.survey import desi
    real = desi._run_group_fit

    def run(arms, templates, config, options, **kw):
        import torch
        before = kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real(arms, templates, config, options, **kw)
        wall = time.perf_counter() - t0
        after = kernel_counts()
        records.append(dict(
            nfibers=arms[0].nfibers, wall=wall,
            launches=diff_counts(after, before), arms=arms, out=out,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        return out
    with mock.patch.object(desi, '_run_group_fit', run):
        yield


def read_status(path):
    with open(path) as fp:
        return [ln.split() for ln in fp.read().strip().splitlines()]


def driver_inputs(workdir, nfiles=None, nfib=None, seed0=100,
                  make=None):
    """``nfiles`` (default NFILES) coadds of ``nfib`` (NFIBERS) fibers in
    bench.py's format (seeds seed0...), the exposures from ``make(nfib,
    seed)`` (default simulation.make_exposure at S/N 50): (paths,
    truths)."""
    from rvspecfit_torch import simulation
    nfiles, nfib = nfiles or NFILES, nfib or NFIBERS
    make = make or (lambda n, seed: simulation.make_exposure(
        n, npix_arm=NPIX_ARM, snr=50.0, seed=seed))
    t0 = time.perf_counter()
    files, truths = [], []
    for i in range(nfiles):
        arms_data, truth = make(nfib, seed0 + i)
        files.append(write_coadd(
            os.path.join(workdir, f'coadd-s{seed0 + i}.fits'), arms_data))
        truths.append(truth)
    log(f'driver inputs: {nfiles} coadds of {nfib} fibers x 3 arms x '
        f'{NPIX_ARM} px ({time.perf_counter() - t0:.1f} s)')
    return files, truths


def run_driver(workdir, files, truths, tm, bank_d, tag):
    """The slice's main path on the card: the coadds ``files`` through
    the port's proc_many at coalesce 2 (groups of 1000 fibers, the first
    cold), crash isolation off, launches counted from 0.  Checks the
    status lines, the RVTAB schema and rows, RV recovery per file and
    RVMOD; returns the launches, group records, steady and cold times
    and recoveries."""
    from rvspecfit_torch.io import fitsio
    from rvspecfit_torch.survey import desi
    outdir = os.path.join(workdir, f'out-{tag}')
    status = os.path.join(workdir, f'status-{tag}.txt')
    nfib = len(truths[0]['vel'])
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
    log(f'driver {tag}: {len(files)} files at coalesce {COALESCE} in '
        f'{wall:.3f} s; kernel launches {counts}')

    lines = read_status(status)
    check([ln[0] for ln in lines] == files
          and all(ln[1:3] == ['SUCCESS', str(nfib)] and len(ln) == 5
                  for ln in lines),
          f'status lines: {lines}')
    stamps = [float(ln[4]) for ln in lines]
    cold = stamps[COALESCE - 1] - t_start
    steady = (stamps[-1] - stamps[COALESCE - 1]) / (len(files) - COALESCE) \
        if len(files) > COALESCE else None
    log(f'driver {tag} status: per-file seconds '
        f'{[float(ln[3]) for ln in lines]}; cold group {cold:.3f} s '
        f'({COALESCE} files)' + ('' if steady is None else
                                 f'; steady {steady:.3f} s/file from '
                                 'completion times -> '
                                 f'{nfib / steady:.1f} fibers/s'))
    check(len(records) == len(files) // COALESCE
          and all(r['nfibers'] == COALESCE * nfib for r in records),
          f'group fits: {[r["nfibers"] for r in records]}')
    for g, r in enumerate(records):
        log(f'  group {g} ({r["nfibers"]} fibers): ' + ' '.join(
            f'{k}={r["out"]["phases"][k]:.3f}s' for k in PHASES)
            + f' fit={r["wall"]:.3f}s; peak device memory '
            f'{r["peak_gb"]:.2f} GB; launches {r["launches"]}')

    desc = desi.get_column_desc([s.upper() for s in SETUPS])
    recovered = []
    for f, truth in zip(files, truths):
        tab_path, mod_path = desi.output_paths(f, outdir)
        rv = fitsio.read(tab_path)['RVTAB'].data
        check(np.array_equal(rv['TARGETID'], np.arange(nfib) + TID0),
              f'{f}: RVTAB rows are not the {nfib} targets in order')
        for k, (dtype, _, _) in desc.items():
            check(k in OPTIONAL_COLUMNS
                  or (k in rv and rv[k].dtype == np.dtype(dtype)),
                  f'{f}: RVTAB column {k} missing or not {dtype}')
        ok = np.abs(rv['VRAD'] - truth['vel']) < np.maximum(
            10.0, 5 * rv['VRAD_ERR'])
        recovered.append(int(ok.sum()))
        check(ok.sum() >= 0.98 * nfib,
              f'{f} ({tag}): RV recovery {ok.sum()}/{nfib}')
        mod = fitsio.read(mod_path)
        for s in SETUPS:
            m = mod[f'{s.upper()}_MODEL'].data
            check(m.shape == (nfib, NPIX_ARM) and m.dtype == np.float32
                  and np.isfinite(m).all(), f'{f}: {s} RVMOD')
    log(f'driver {tag} RV recovery per file (of {nfib}, within max(10, 5 '
        f'sigma)): {recovered}; RVTAB has every column of get_column_desc '
        f'with its dtype; RVMOD ({nfib}, {NPIX_ARM}) float32 per arm')
    group_truth = {k: np.concatenate([t[k] for t in truths[-COALESCE:]])
                   for k in truths[0]}
    return dict(counts=counts, records=records, steady=steady, cold=cold,
                wall=wall, recovered=recovered, truth=group_truth)


def runs_card_and_cpu(name, run, tms):
    """One driver run on the card ('cuda') and one on the CPU ('cpu'),
    both float64, each through ``run(key, template model, device) ->
    output table``; returns {key: table}."""
    tabs = {}
    for key in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        tabs[key] = run(key, tms[key], key)
        log(f'{name}: driver on {key} {time.perf_counter() - t0:.2f} s')
    return tabs


def spread_against_cpu(name, tabs, vel, pars, err):
    """The card's run against the CPU's: |dv| over max(1 km/s, sigma/2)
    and |dp| / sigma per fiber and parameter, sigma the CPU's errors
    (columns ``vel``, each parameter of ``pars``, and each with the
    suffix ``err``).  Returns (dv, dp, numbers: max |dv| in km/s and
    over the limit, max |dp|/sigma, fibers over 0.5)."""
    c, g = tabs['cpu'], tabs['cuda']
    lim = np.maximum(1.0, 0.5 * c[vel + err])
    dvk = np.abs(g[vel] - c[vel])
    dv = dvk / lim
    dp = np.stack([np.abs(g[p] - c[p]) / c[p + err] for p in pars], 1)
    good = np.isfinite(dp).all(1)
    stats = dict(max_dv_kms=float(dvk.max()), max_dv_lim=float(dv.max()),
                 max_dp=float(np.nanmax(dp)),
                 over=int((dp > 0.5).any(1).sum()))
    log(f'{name}: {len(c[vel])} fibers, card float64 vs CPU float64: max '
        f'|dv| {dvk.max():.6f} km/s, {dv.max():.6f} of max(1 km/s, '
        f'sigma/2); max |dp|/sigma {np.nanmax(dp):.6f}, over 0.5 for '
        f'{stats["over"]} fibers ({int(good.sum())} with finite CPU '
        'errors)')
    return dv, dp, stats


def driver_against_cpu(workdir, name, arms_data, tms, banks, bands=None,
                       config=CONFIG):
    """One coadd through proc_many on the card and on the CPU (both
    float64): same columns, TARGETID and SUCCESS; RVS_WARN equal but
    for BAD_HESSIAN, whose flips are held to the one-point test
    (hessians_at_one_point, which also holds the chi-square at the CPU
    optimum); velocities within max(1 km/s, sigma/2) and parameters
    within sigma/2, sigma the CPU's errors (ROADMAP C.1)."""
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
    tabs = runs_card_and_cpu(name, run, tms)
    g, c = tabs['cuda'], tabs['cpu']
    bh = desi.bitmasks['BAD_HESSIAN']
    check(list(g) == list(c), f'{name}: RVTAB columns differ')
    check(np.array_equal(g['TARGETID'], c['TARGETID']),
          f'{name}: TARGETID differs')
    check(np.array_equal(g['SUCCESS'], c['SUCCESS']),
          f'{name}: SUCCESS differs')
    check(np.array_equal(g['RVS_WARN'] & ~bh, c['RVS_WARN'] & ~bh),
          f'{name}: RVS_WARN differs beyond BAD_HESSIAN')
    dv, dp, stats = spread_against_cpu(
        name, tabs, 'VRAD', ('TEFF', 'LOGG', 'FEH', 'ALPHAFE'), '_ERR')
    flips = int(((g['RVS_WARN'] ^ c['RVS_WARN']) & bh).astype(bool).sum())
    log(f'{name}: BAD_HESSIAN flips at own optima {flips}; SUCCESS '
        f'{int(g["SUCCESS"].sum())}/{len(g["SUCCESS"])} on both')
    check((dv <= 1).all(), f'{name}: card velocities disagree with CPU')
    good = np.isfinite(dp).all(1)
    check((dp[good] <= 0.5).all(),
          f'{name}: card parameters disagree with CPU (ROADMAP C.1)')
    hessians_at_one_point(recs['cpu']['arms'], tms, recs['cpu']['out'])
    return stats


# ------------------------------------------------------------------
# the single-object fit: SpecData -> ccf.fit -> vel_fit.process

NOBJ = 2
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
    run's optimum, on the card and on the CPU (both float64): |dchi2|
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


def fit_objects(objs, templates, banks):
    """ccf.fit -> vel_fit.process on each object: per call the result,
    the CCF result, seconds, stages and launches."""
    from rvspecfit_torch.fit import ccf, vel_fit
    calls = []
    for sds in objs:
        rec = {}
        c0 = kernel_counts()
        t0 = time.perf_counter()
        g = ccf.fit(sds, CONFIG, banks=banks)
        t1 = time.perf_counter()
        c1 = kernel_counts()
        with process_stages(rec):
            r = vel_fit.process(sds, g['best_par'], config=CONFIG,
                                options=OPTIONS, templates=templates)
        t2 = time.perf_counter()
        c2 = kernel_counts()
        calls.append(dict(
            res=r, ccf=g, ccf_s=t1 - t0, process_s=t2 - t1,
            stages={k: float(np.sum(v)) for k, v in rec.items()},
            ccf_launches=diff_counts(c1, c0),
            process_launches=diff_counts(c2, c1)))
    return calls


# ccf.fit's velocity on the card against the CPU float64 run's (km/s,
# ROADMAP C.2)
CCF_VEL_TOL = 0.01


def run_single_object(models, banks):
    """The single-object path on the card: ccf.fit -> vel_fit.process on
    each of NOBJ objects, firstguess on NFIRSTGUESS of them and one
    process with a Gaussian resolution matrix per arm (resolParams); its
    kernel launches counted from 0.  Then the CPU float64 run of the
    same calls but firstguess, and ccf.fit -> process in float32 on the
    card (its time and ccf.fit's velocities, logged).  Checks RV
    recovery, every kernel launched, and the card against the CPU:
    ccf.fit's template and velocity within CCF_VEL_TOL, velocities
    within max(1 km/s, sigma/2), parameters within sigma/2, and the
    chi-square and Hessian errors at the CPU optimum within CHI_TOL and
    ERR_TOL."""
    import torch
    from rvspecfit_torch.fit import vel_fit
    from rvspecfit_torch.fit.spec_data import SpecData
    from rvspecfit_torch.ops.resolution import gaussian_resolution_matrix
    objs, truth = single_objects()
    names = [sd.name for sd in objs[0]]
    keys = ('cuda', 'cpu', 'cuda32')
    tms = {k: {n: models[k] for n in names} for k in keys}
    bks = {k: {n: banks[k] for n in names} for k in keys}
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
        guesses = []
        if key == 'cuda':
            reset_counts()
            torch.cuda.synchronize()
        t_phase = time.perf_counter()
        calls = fit_objects(objs, tms[key], bks[key])
        t_fit = time.perf_counter()
        # firstguess on the card only: the CPU's takes ~15-20 s an
        # object, and its guesses are not checked
        for sds in objs[:NFIRSTGUESS if key == 'cuda' else 0]:
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
    check_launches('single-object path', counts)
    reset_counts()
    t0 = time.perf_counter()
    calls32 = fit_objects(objs, tms['cuda32'], bks['cuda32'])
    out['cuda32'] = dict(calls=calls32, seconds=dict(
        fit=time.perf_counter() - t0))
    out['counts32'] = kernel_counts()
    log(f'single-object ccf.fit -> process in float32: '
        f'{out["cuda32"]["seconds"]["fit"]:.3f} s for {NOBJ} objects; '
        f'launches {out["counts32"]}')
    check_launches('single-object path in float32', out['counts32'],
                   form='float32')
    card, cpu = out['cuda'], out['cpu']
    fits = {k: [c['ccf'] for c in out[k]['calls']]
            for k in ('cuda', 'cpu', 'cuda32')}
    vel = {k: np.array([r['best_vel'] for r in v]) for k, v in fits.items()}
    same = {k: sum(r['best_par'] == q['best_par']
                   for r, q in zip(fits[k], fits['cpu']))
            for k in ('cuda', 'cuda32')}
    dccf = {k: float(np.abs(vel[k] - vel['cpu']).max())
            for k in ('cuda', 'cuda32')}
    dcurve = {k: max(np.abs(x['best_ccf'] - y['best_ccf']).max()
                     for x, y in zip(fits[k], fits['cpu']))
              for k in ('cuda', 'cuda32')}
    log(f'single-object ccf.fit best_vel, max over objects |card - CPU|: '
        f'float64 {dccf["cuda"]:.6f} km/s (limit {CCF_VEL_TOL}), float32 '
        f'{dccf["cuda32"]:.4f} km/s; same template as the CPU: float64 '
        f'{same["cuda"]}/{NOBJ}, float32 {same["cuda32"]}/{NOBJ}; best '
        f'curves max|card - CPU| float64 {dcurve["cuda"]:.4g}, float32 '
        f'{dcurve["cuda32"]:.4g}')
    for i, (c, p, c32) in enumerate(zip(card['calls'], cpu['calls'],
                                        calls32)):
        r = c['res']
        log(f'  object {i}: ccf.fit {c["ccf_s"]:.3f} s, process '
            f'{c["process_s"]:.3f} s (' + ' '.join(
                f'{k}={v:.3f}s' for k, v in c['stages'].items()
                if k != 'bfgs_calls')
            + '; BFGS objective+gradient calls '
            f'{c["stages"].get("bfgs_calls", 0):.0f}); launches ccf.fit '
            f'{c["ccf_launches"]["float64"]}, process '
            f'{c["process_launches"]["float64"]}; vel {r["vel"]:.3f} +- '
            f'{r["vel_err"]:.3f} (truth {truth["vel"][i]:.3f}, CPU '
            f'{p["res"]["vel"]:.3f}); CPU process {p["process_s"]:.3f} s; '
            f'float32 ccf.fit {c32["ccf_s"]:.3f} s, process '
            f'{c32["process_s"]:.3f} s')
    check(same['cuda'] == NOBJ, 'ccf.fit on the card picks other templates '
          'than the CPU (ROADMAP C.2)')
    check(dccf['cuda'] <= CCF_VEL_TOL, 'ccf.fit velocities on the card '
          'disagree with the CPU (ROADMAP C.2)')
    rv = np.array([c['res']['vel'] for c in card['calls']])
    sig = np.array([c['res']['vel_err'] for c in card['calls']])
    ok = np.abs(rv - truth['vel']) < np.maximum(10.0, 5 * sig)
    check(ok.all(), f'single-object RV recovery {int(ok.sum())}/{NOBJ}')
    vc = np.array([p['res']['vel'] for p in cpu['calls']])
    sc = np.array([p['res']['vel_err'] for p in cpu['calls']])
    dv = np.abs(rv - vc) / np.maximum(1.0, 0.5 * sc)
    dchi, rel, flips = [], [], 0
    tms64 = {k: tms[k] for k in ('cuda', 'cpu')}
    for sds, p in zip(objs, cpu['calls']):
        d, e, bc, bp = single_at_one_point(sds, tms64, p['res'])
        dchi.append(d)
        rel.append(e if not (bc or bp) else 0.0)
        flips += int(bc != bp)
    d, e, bc, bp = single_at_one_point(res_sds, narrow, cpu['res'], resol)
    dchi.append(d)
    rel.append(e if not (bc or bp) else 0.0)
    flips += int(bc != bp)
    names4 = list(card['calls'][0]['res']['param'])

    def spread(runs, refs):
        return np.array([[abs(c['res']['param'][k] - p['res']['param'][k])
                          / p['res']['param_err'][k] for k in names4]
                         for c, p in zip(runs, refs)])
    dp = spread(card['calls'] + [dict(res=card['res'])],
                cpu['calls'] + [dict(res=cpu['res'])])
    dp32 = spread(calls32, cpu['calls'])
    vel32 = np.array([c['res']['vel'] for c in calls32])
    r_res = card['res']
    dv_res = abs(r_res['vel'] - cpu['res']['vel']) / max(
        1.0, 0.5 * cpu['res']['vel_err'])
    dvk = max(np.abs(rv - vc).max(), abs(r_res['vel'] - cpu['res']['vel']))
    log(f'single-object: RV recovery {int(ok.sum())}/{NOBJ} within max(10, '
        f'5 sigma); card float64 vs CPU float64: max |dv| {dvk:.6f} km/s, '
        f'{max(dv.max(), dv_res):.6f} of max(1 km/s, sigma/2); parameters '
        f'max |dp|/sigma {np.nanmax(dp):.6f}, over 0.5 for '
        f'{int((dp > 0.5).any(1).sum())} of {len(dp)} (limit 0.5); at the '
        f'CPU optimum |dchi2| max {max(dchi):.4g} (limit {CHI_TOL}), errors '
        f'max |rel diff| {max(rel):.4g} (limit {ERR_TOL}, good Hessians), '
        f'BAD_HESSIAN differing {flips}; float32 (logged): max |dv| '
        f'{np.abs(vel32 - vc).max():.4f} km/s, max |dp|/sigma '
        f'{np.nanmax(dp32):.4f}, over 0.5 for '
        f'{int((dp32 > 0.5).any(1).sum())} of {len(dp32)}')
    log(f'  resolution-matrix object: vel {r_res["vel"]:.3f} +- '
        f'{r_res["vel_err"]:.3f} (truth {res_truth["vel"][0]:.3f}, CPU '
        f'{cpu["res"]["vel"]:.3f}); firstguess on the card '
        f'{card["guesses"]}')
    check((dv <= 1).all() and dv_res <= 1,
          'single-object velocities on the card disagree with the CPU')
    check(np.nanmax(dp) <= 0.5, 'single-object parameters on the card '
          'disagree with the CPU (ROADMAP C.1)')
    check(abs(r_res['vel'] - res_truth['vel'][0]) < max(
        10.0, 5 * r_res['vel_err']), 'resolution-matrix object: RV')
    check(max(dchi) <= CHI_TOL, 'single-object chi-square at the CPU '
          'optimum disagrees with the CPU')
    check(max(rel) <= ERR_TOL, 'single-object Hessian errors at the CPU '
          'optimum disagree with the CPU')
    out['stats'] = dict(max_dp=float(np.nanmax(dp)), max_dv_kms=float(dvk),
                        ccf_max_dv_kms=dccf['cuda'],
                        ccf_same_template=int(same['cuda']),
                        ccf32_max_dv_kms=dccf['cuda32'],
                        ccf32_same_template=int(same['cuda32']),
                        float32_max_dp=float(np.nanmax(dp32)))
    for gs in card['guesses']:
        check(set(gs) >= set(names4), f'firstguess gave {gs}')
    return out


def kernel_b_single(sd, banks):
    """Kernel B at one fiber row, as ccf.fit launches it on the
    SpecData ``sd`` (prepare_arm_batch at B = 1) with each of ``banks``
    ({mode: device bank}), in both forms: {form: {mode: numbers}}."""
    from rvspecfit_torch.fit.batch import BatchArm
    result = {form: {} for form in FORMS}
    for mode, bank in banks.items():
        args, cont = kernel_b_args([BatchArm(sd.name, sd.lam, sd.spec[None],
                                             sd.espec[None]**-2.0)], bank)
        for form in FORMS:
            result[form][mode] = kernel_b_case(
                as_form(args, form), cont,
                f'kernel B {mode} at B = 1 (ccf.fit) {form}', form,
                graph=True)
    return result


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


def run_weave(workdir, models, banks):
    """survey/weave.proc_many over a WEAVE_NFIB-fiber pair on the card,
    launches counted from 0: the status line, the WEAVE_RV columns, RV
    recovery; the same pair in float32 (its time); then an 8-fiber pair
    on the card against the CPU, both float64: velocities within
    max(1 km/s, sigma/2) and parameters within sigma/2 (ROADMAP C.1)."""
    import torch
    from rvspecfit_torch.io import fitsio
    from rvspecfit_torch.survey import weave
    grp, truth = write_weave_pair(workdir, WEAVE_NFIB, seed=40)
    kw = lambda k: dict(options=WEAVE_OPTIONS, throw_exceptions=True,
                        templates={f'weave_{s}': models[k]
                                   for s in WEAVE_LAYOUT},
                        banks={f'weave_{s}': banks[k]
                               for s in WEAVE_LAYOUT})
    parnames = models['cuda'].parnames
    res = {}
    for key, form in (('cuda', 'float64'), ('cuda32', 'float32')):
        outdir = os.path.join(workdir, f'weave-out-{form}')
        status = os.path.join(workdir, f'weave-status-{form}.txt')
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weave.proc_many([grp], outdir, CONFIG, status_fname=status,
                        **kw(key))
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        log(f'WEAVE {form}: {WEAVE_NFIB} fibers x 2 arms x {NPIX_ARM} px in '
            f'{wall:.3f} s -> {WEAVE_NFIB / wall:.1f} fibers/s; kernel '
            f'launches {counts}')
        check_launches(f'WEAVE path ({form})', counts, form=form)
        ofname = weave.output_path(grp, outdir)
        lines = read_status(status)
        check(len(lines) == 1 and lines[0][:3] == [ofname, 'SUCCESS',
                                                  str(WEAVE_NFIB)],
              f'WEAVE status lines: {lines}')
        tab = fitsio.read(ofname)['WEAVE_RV'].data
        check(list(tab) == weave_columns(parnames, sorted(WEAVE_LAYOUT)),
              f'WEAVE_RV columns {list(tab)}')
        ok = np.abs(tab['vrad'] - truth['vel']) < np.maximum(
            10.0, 5 * tab['vrad_err'])
        log(f'WEAVE {form} RV recovery {int(ok.sum())}/{WEAVE_NFIB} within '
            f'max(10, 5 sigma); WEAVE_RV has the reference\'s {len(tab)} '
            f'columns; status {lines[0][:4]}')
        check(ok.sum() >= 0.98 * WEAVE_NFIB,
              f'WEAVE ({form}) RV recovery {ok.sum()}/{WEAVE_NFIB}')
        res[form] = dict(counts=counts, wall=wall, recovered=int(ok.sum()))

    grp8, _ = write_weave_pair(workdir, 8, seed=41)

    def run8(key, tm_k, dev):
        out8 = os.path.join(workdir, f'weave8-{key}')
        kw8 = dict(kw(dev), templates={f'weave_{s}': tm_k
                                       for s in WEAVE_LAYOUT})
        weave.proc_many([grp8], out8, CONFIG, device=dev, **kw8)
        return fitsio.read(weave.output_path(grp8, out8))['WEAVE_RV'].data
    tabs = runs_card_and_cpu('WEAVE 8-fiber pair', run8, models)
    g, c = tabs['cuda'], tabs['cpu']
    check(list(g) == list(c) and np.array_equal(g['target_id'],
                                                c['target_id']),
          'WEAVE 8-fiber pair: columns or targets differ')
    dv, dp, stats = spread_against_cpu('WEAVE 8-fiber pair', tabs, 'vrad',
                                       parnames, '_err')
    log(f'WEAVE 8-fiber pair: per fiber max |dp|/sigma_CPU '
        f'{np.round(np.nanmax(dp, 1), 6).tolist()}, vsini card '
        f'{np.round(g["vsini"], 3).tolist()}, CPU '
        f'{np.round(c["vsini"], 3).tolist()} km/s')
    check((dv <= 1).all(), 'WEAVE velocities on the card disagree with CPU')
    good = np.isfinite(dp).all(1)
    check((dp[good] <= 0.5).all(), 'WEAVE parameters on the card disagree '
          'with CPU (ROADMAP C.1)')
    res['stats'] = stats
    return res


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
    check_launches('bruteforce path', counts, unused=('ccf_chisq',))
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


# ------------------------------------------------------------------
# the NN trainer on the card, and the NN cell through the trained model

# 24,960 templates x 4096 px (0.82 GB in float64): the order of the
# PHOENIX library rvspecfit's trainer is fed (13 log g, 10 [Fe/H], 8
# [alpha/Fe]); Teff cut from PHOENIX's ~73 steps to 24
TRAIN_GRID = (24, 13, 10, 8)
# rvstorch_train_nn_interpolator's defaults (the reference CLI's)
TRAIN = dict(width=256, nlayers=2, npc=64, batch_size=100, lr0=1e-3,
             min_lr=1e-8, plateau_patience=20, pca_init=False, seed=22)
# the cut: a fixed number of epochs (the CLI trains up to 600), so that
# the whole script stays near half its time limit (the loss falls
# below 0.3 of the first epoch's by epoch 10: 0.244 at epoch 11 on the
# H100)
TRAIN_EPOCHS = 15
# the loss criterion of tests/test_train_nn.py
TRAIN_DROP = 0.3
# card vs CPU: 2 epochs on a 2000-template subset from one init_state
# draw.  Both run the same float64 arithmetic (cuBLAS's and the CPU
# BLAS's summation orders differ by ~1e-16 a product); over 40 Adam
# steps that stays ~1e-15 (the port against the reference on the CPU,
# tests/test_torch_train_nn.py: 5.6e-16 after 16 steps).  1e-9 leaves
# room for Adam's division by sqrt(v) + 1e-8 (a rounding difference of
# a gradient near 1e-8 is amplified) and for an L1 residual that
# changes sign (one gradient entry moves by 2/N).
TRAIN_CMP = dict(ntemplates=2000, epochs=2, rtol=1e-9)
NN_NFILES = 2


def training_set():
    """The training grid at 4096 px on 4550-5450 A: (lam, (nspec, 4)
    mapped parameters, (nspec, npix) log-spectra, parnames)."""
    from rvspecfit_torch import simulation
    t0 = time.perf_counter()
    lam, _, _, vecs, specs, parnames = simulation.make_template_grid(
        *TRAIN_GRID, npix=4096, lam0=4550.0, lam1=5450.0)
    log(f'training set: {specs.shape[0]} templates x {specs.shape[1]} px '
        f'({specs.nbytes / 1e9:.2f} GB in float64, '
        f'{time.perf_counter() - t0:.1f} s)')
    return lam, vecs.T, specs, parnames


def run_training(device, data):
    """pipeline/train_nn.train_interpolator at full width on the card
    for TRAIN_EPOCHS epochs: seconds per epoch, steps/s, the loss at the
    first and last epoch, the peak device memory; the loss must fall to
    TRAIN_DROP of its first epoch's.  Returns (model, numbers)."""
    import torch
    from rvspecfit_torch.pipeline import train_nn
    _, x, specs, _ = data
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, hist = train_nn.train_interpolator(
        x, specs, num_epochs=TRAIN_EPOCHS, device=device, **TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = hist['loss']
    steps = len(loss) * (len(x) // TRAIN['batch_size'])
    res = dict(seconds=wall, epochs=len(loss), steps=steps,
               s_per_epoch=wall / len(loss), steps_per_s=steps / wall,
               loss_first=loss[0], loss_last=loss[-1], lr_last=hist['lr'][-1],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               counts=kernel_counts())
    log(f'NN training on the card: {len(x)} templates, width '
        f'{TRAIN["width"]}, {TRAIN["nlayers"]} layers, npc {TRAIN["npc"]}, '
        f'batch {TRAIN["batch_size"]}, lr0 {TRAIN["lr0"]}, patience '
        f'{TRAIN["plateau_patience"]}; cut: {len(loss)} epochs of the CLI\'s '
        f'600; {wall:.3f} s -> {res["s_per_epoch"]:.4f} s/epoch, '
        f'{res["steps_per_s"]:.1f} steps/s; loss {loss[0]:.6f} (epoch 1) -> '
        f'{loss[-1]:.6f} (epoch {len(loss)}) = '
        f'{loss[-1] / loss[0]:.4f} of the first, lr {hist["lr"][-1]:.3g}; '
        f'peak device memory {res["peak_gb"]:.2f} GB; loss every 10 epochs '
        f'{[round(v, 6) for v in loss[::10]]}')
    check(len(loss) == TRAIN_EPOCHS, f'training stopped after {len(loss)} '
          'epochs')
    check(loss[-1] <= TRAIN_DROP * loss[0],
          f'the training loss fell only to {loss[-1] / loss[0]:.3f} of its '
          'first epoch\'s')
    return model, res


def device_activity(fn):
    """{name: (device ms, calls)} of the work on the card (kernels and
    memory copies, not the profiler's annotations) in one call of fn()
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, 'is_user_annotation', False):
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + 1e-3 * e.time_range.elapsed_us(), n + 1)
    return by_name


def top_activity(by_name, n=5):
    """The ``n`` names of device_activity's result with the most device
    time: [(name, ms, calls)]."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [(k[:80], round(t, 3), c) for k, (t, c) in top]


def training_against_cpu(device, data, train):
    """TRAIN_CMP['epochs'] epochs on a TRAIN_CMP['ntemplates'] subset at
    full width on the card and on the CPU, from one init_state draw (the
    trainer's seeded torch.Generator): every epoch's loss and every
    final weight array within TRAIN_CMP['rtol'] (relative to the
    array's largest entry).  The card's run is profiled: its kernels
    and kernel time per step, whose share of the timed run's time per
    step is the device's busy share in training (its memory copies are
    reported apart: most is the set-up's upload)."""
    from rvspecfit_torch.interp import nn
    from rvspecfit_torch.pipeline import train_nn
    _, x, specs, _ = data
    sub = np.random.RandomState(3).permutation(len(x))[
        :TRAIN_CMP['ntemplates']]
    kw = dict(TRAIN, num_epochs=TRAIN_CMP['epochs'])
    runs = {}

    def card():
        runs['cuda'] = train_nn.train_interpolator(x[sub], specs[sub],
                                                   device=device, **kw)
    activity = device_activity(card)
    copies = {k: v for k, v in activity.items()
              if k.startswith(('Memcpy', 'Memset'))}
    kernels = {k: v for k, v in activity.items() if k not in copies}
    t0 = time.perf_counter()
    runs['cpu'] = train_nn.train_interpolator(x[sub], specs[sub],
                                              device='cpu', **kw)
    t_cpu = time.perf_counter() - t0
    steps = TRAIN_CMP['epochs'] * (len(sub) // TRAIN['batch_size'])
    (mc, hc), (mp, hp) = runs['cuda'], runs['cpu']
    dloss = float(np.max(np.abs(np.subtract(hc['loss'], hp['loss']))
                         / np.abs(hp['loss'])))
    got, want = nn.state_to_dict(mc), nn.state_to_dict(mp)
    dw = {k: float(np.abs(got[k] - w).max() / np.abs(w).max())
          for k, w in want.items()
          if isinstance(w, np.ndarray) and np.abs(w).max() > 0}
    kernel_ms = sum(t for t, _ in kernels.values())
    res = dict(max_rel_dloss=dloss, max_rel_dweight=max(dw.values()),
               kernels_per_step=sum(n for _, n in kernels.values()) / steps,
               kernel_ms_per_step=kernel_ms / steps,
               busy_share=(kernel_ms / steps) * 1e-3 * train['steps_per_s'],
               copies_ms=sum(t for t, _ in copies.values()),
               copies=sum(n for _, n in copies.values()),
               cpu_s_per_epoch=t_cpu / TRAIN_CMP['epochs'])
    log(f'NN training card vs CPU float64 ({len(sub)} templates, '
        f'{TRAIN_CMP["epochs"]} epochs, {steps} steps): losses card '
        f'{hc["loss"]} CPU {hp["loss"]}, max rel diff {dloss:.3e}; final '
        f'weights max |diff| / max |w| {res["max_rel_dweight"]:.3e} (worst '
        f'{max(dw, key=dw.get)}; limit {TRAIN_CMP["rtol"]}); CPU '
        f'{res["cpu_s_per_epoch"]:.3f} s/epoch; the card\'s run profiled: '
        f'{res["kernels_per_step"]:.2f} kernels and '
        f'{res["kernel_ms_per_step"]:.4f} ms of kernel time per step -> '
        f'busy {100 * res["busy_share"]:.1f}% of the timed run\'s '
        f'{1e3 / train["steps_per_s"]:.4f} ms per step; besides, '
        f'{res["copies"]} memory copies ({res["copies_ms"]:.3f} ms: the '
        f'training set\'s upload, the epochs\' orders, the epochs\' loss '
        f'reads); kernels with the most device time (name, ms, calls): '
        f'{top_activity(kernels)}')
    check(dloss <= TRAIN_CMP['rtol'] and res['max_rel_dweight']
          <= TRAIN_CMP['rtol'], 'the card\'s training disagrees with the '
          'CPU\'s')
    return res


# phase 20: the trainer on a (data, model) grid of the one card
TRAIN_GRID_SHAPE = (2, 2)


def run_train_mesh(device, data):
    """Phase 20: TRAIN_CMP['epochs'] epochs on training_against_cpu's
    TRAIN_CMP['ntemplates'] subset at full width, unsharded and on a
    TRAIN_GRID_SHAPE (data, model) grid of the card named four times
    (parallel/mesh.make_grid, pipeline/train_nn ``mesh=``), from one
    init_state draw: every epoch's loss and every folded weight array
    within TRAIN_CMP['rtol'] of the unsharded run; prints the s/epoch
    and the peak device memory of both."""
    import torch
    from rvspecfit_torch.interp import nn
    from rvspecfit_torch.parallel import mesh as pmesh
    from rvspecfit_torch.pipeline import train_nn
    _, x, specs, _ = data
    sub = np.random.RandomState(3).permutation(len(x))[
        :TRAIN_CMP['ntemplates']]
    kw = dict(TRAIN, num_epochs=TRAIN_CMP['epochs'])
    grid = pmesh.make_grid([device] * int(np.prod(TRAIN_GRID_SHAPE)),
                           TRAIN_GRID_SHAPE)
    runs = {}
    for key, mesh in (('unsharded', None), ('grid', grid)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, hist = train_nn.train_interpolator(
            x[sub], specs[sub], device=device, mesh=mesh, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[key] = dict(model=model, loss=hist['loss'],
                         s_per_epoch=wall / len(hist['loss']),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    u, g = runs['unsharded'], runs['grid']
    dloss = float(np.max(np.abs(np.subtract(g['loss'], u['loss']))
                         / np.abs(u['loss'])))
    got, want = nn.state_to_dict(g['model']), nn.state_to_dict(u['model'])
    dw = {k: float(np.abs(got[k] - w).max() / np.abs(w).max())
          for k, w in want.items()
          if isinstance(w, np.ndarray) and np.abs(w).max() > 0}
    log(f'NN training on a {TRAIN_GRID_SHAPE} (data, model) grid of '
        f'{device} against unsharded ({len(sub)} templates, '
        f'{TRAIN_CMP["epochs"]} epochs, width {TRAIN["width"]}, batch '
        f'{TRAIN["batch_size"]}): losses grid {g["loss"]} unsharded '
        f'{u["loss"]}, max rel diff {dloss:.3e}; folded weights max |diff| '
        f'/ max |w| {max(dw.values()):.3e} (worst {max(dw, key=dw.get)}; '
        f'limit {TRAIN_CMP["rtol"]}); s/epoch grid {g["s_per_epoch"]:.4f}, '
        f'unsharded {u["s_per_epoch"]:.4f} '
        f'({g["s_per_epoch"] / u["s_per_epoch"]:.2f}x); peak device memory '
        f'{g["peak_gb"]:.2f} / {u["peak_gb"]:.2f} GB')
    check(dloss <= TRAIN_CMP['rtol'] and max(dw.values()) <= TRAIN_CMP['rtol'],
          'the grid\'s training disagrees with the unsharded run')
    return dict(shape=list(TRAIN_GRID_SHAPE), max_rel_dloss=dloss,
                max_rel_dweight=max(dw.values()),
                **{f'{k}_{q}': v[q] for k, v in runs.items()
                   for q in ('s_per_epoch', 'peak_gb')})


def run_nn(workdir, device, model, data):
    """The NN cell on the card through the trained model: its
    checkpoint payload (interp/nn.state_to_dict) and the trainer's
    library descriptor through pipeline/library.
    template_model_from_artifacts (on the card and on the CPU),
    NN_NFILES coadds of NFIBERS spectra drawn from the model itself at
    known parameters and velocities (simulation.model_exposure, on the
    CPU), and a CCF bank of the model at the 6,6,6,4 grid's nodes
    (simulation.model_ccf_bank), through proc_many at coalesce 2 (one
    group of 1000 fibers), launches counted from 0 (run_driver: status
    lines, schema, RV recovery >= 98% per file, RVMOD).  Logs the
    BAD_HESSIAN share."""
    from rvspecfit_torch import convert, simulation
    from rvspecfit_torch.interp import nn
    from rvspecfit_torch.pipeline import train_nn
    from rvspecfit_torch.pipeline.library import \
        template_model_from_artifacts
    t0 = time.perf_counter()
    lam, _, specs, parnames = data
    payload = nn.state_to_dict(model)
    fd = train_nn.library_descriptor(
        lam, parnames, True, True, [0], np.zeros(len(specs)),
        TRAIN['width'], TRAIN['nlayers'], TRAIN['npc'])
    tm_cpu = template_model_from_artifacts(fd, payload, device='cpu')
    tm = template_model_from_artifacts(fd, payload, device=device)
    bank = simulation.model_ccf_bank(tm_cpu, every=8, device='cpu')
    log(f'NN library (trained): {tm.state.ndim} -> '
        f'{[lin.out_features for lin in tm.state.layers]} -> '
        f'{tm.state.npix} px, {tm.state.nonlinearity}, '
        f'{tm.state.mean.dtype} on {tm.state.mean.device}; CCF bank '
        f'{bank[0].shape[0]} x {bank[0].shape[1]} '
        f'({time.perf_counter() - t0:.1f} s)')
    check(tm.kind == 'nn', f'the NN library gave a {tm.kind} model')
    files, truths = driver_inputs(
        workdir, nfiles=NN_NFILES, seed0=200,
        make=lambda n, seed: simulation.model_exposure(
            tm_cpu, n, npix_arm=NPIX_ARM, snr=50.0, seed=seed))
    nn_run = run_driver(workdir, files, truths, tm,
                        convert.ccf_bank(*bank, device=device), 'nn')
    check_launches('NN path', nn_run['counts'])
    bad = sum(int(r['out']['bad_hess'].sum()) for r in nn_run['records'])
    nfib = sum(r['nfibers'] for r in nn_run['records'])
    nn_run['bad_hessian_share'] = bad / nfib
    log(f'NN cell through the trained model: BAD_HESSIAN {bad}/{nfib} = '
        f'{100 * bad / nfib:.1f}%; '
        f'driver wall {nn_run["wall"]:.3f} s')
    nn_run['records'] = None
    return nn_run


# the reference's calibration gate on the pull standard deviation
PULL_STD = (0.9, 1.1)
PULL_TRIALS = 1000
PULL_CMP_TRIALS = 8


def run_pull(device, tm, tm_cpu):
    """validation.run_accuracy at its defaults on the card
    (PULL_TRIALS trials: scan -> Nelder-Mead -> polish -> refinement,
    float64), launches counted from 0: its statistics and the gate
    PULL_STD on the pull std; then PULL_CMP_TRIALS trials on the card
    and on the CPU through the same 6,6,6,4 grid at 4096 px (the
    default's, built here once a device): every trial's velocity within
    sigma/2."""
    import torch
    from rvspecfit_torch import validation
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, _ = validation.run_accuracy(ntrials=PULL_TRIALS, device=device)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    log(f'pull harness, {PULL_TRIALS} trials on the card: {wall:.3f} s; '
        f'{json.dumps(stats)}; kernel launches {counts}')
    check_launches('pull harness', counts, unused=('ccf_chisq',))
    check(PULL_STD[0] <= stats['pull_std'] <= PULL_STD[1],
          f'pull std {stats["pull_std"]:.4f} outside {PULL_STD}')
    raw = {}
    for key, tm_d in (('cuda', tm), ('cpu', tm_cpu)):
        t0 = time.perf_counter()
        raw[key] = validation.run_accuracy(ntrials=PULL_CMP_TRIALS,
                                           templates={'acc': tm_d})[1]
        raw[key]['seconds'] = time.perf_counter() - t0
    dv = np.abs(raw['cuda']['vfit'] - raw['cpu']['vfit']) \
        / raw['cpu']['verr']
    log(f'pull harness, {PULL_CMP_TRIALS} trials card vs CPU float64: '
        f'max |dv|/sigma {dv.max():.3e} (limit 0.5); card '
        f'{raw["cuda"]["seconds"]:.3f} s, CPU {raw["cpu"]["seconds"]:.3f} s')
    check((dv < 0.5).all(), 'the pull harness\'s velocities on the card '
          'disagree with the CPU\'s')
    return dict(stats=stats, wall=wall, counts=counts,
                max_dv_sigma_cmp=float(dv.max()))


# ------------------------------------------------------------------
# the offline template pipeline on the card's machine: FITS grid ->
# read_grid -> mask_grid -> make_interpol -> make_nd -> make_ccf, through
# each stage's core (the writers need h5py, which that machine lacks),
# then a group fit through the library and bank it built

# bench.py's 6,6,6,4 grid as FITS templates at LIB_NPIX px over LIB_LAM
# (a PHOENIX build's ~25,000 templates at R ~ 500,000 are not here)
LIB_GRID = (6, 6, 6, 4)
LIB_NPIX = 20000
LIB_LAM = (4500.0, 5500.0)
PHOENIX_KEYWORDS = dict(teff='PHXTEFF', logg='PHXLOGG', feh='PHXM_H',
                        alpha='PHXALPHA')
# DESI's build options (surveys/desi/make_desi.sh): the specs (float32,
# log grid, linear-continuum normalization) and the CCF bank
LIB_SETUP = 'desi_like'
LIB_RANGE = (4600.0, 5400.0)
LIB_STEP = 0.4
LIB_RESOL = 'x/1.55'
# the FITS grid's own resolution (make_interpol's --resolution0 default)
LIB_RESOLUTION0 = 100000.0
LIB_VSINIS = [0.0, 300.0]
LIB_EVERY = 8
# three arms inside the library's range at +-1000 km/s
LIB_LAYOUT = {'B': (4620.0, 4880.0), 'R': (4880.0, 5140.0),
              'Z': (5140.0, 5390.0)}
# the card's bank against the CPU's (tests/test_torch_ccf.py:153)
BANK_RTOL = 1e-8


@contextlib.contextmanager
def timed(module, name, seconds, key):
    """Add the seconds spent in ``module.name`` to ``seconds[key]``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
    with mock.patch.object(module, name, wrapper):
        yield


def write_fits_grid(root):
    """LIB_GRID's templates (simulation.fake_spectrum, no instrumental
    broadening) as FITS files under ``root/specs`` with PHOENIX
    keywords, and ``root/wave.fits``, through the port's FITS module."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.io import fitsio
    os.makedirs(os.path.join(root, 'specs'))
    lam = np.linspace(*LIB_LAM, LIB_NPIX)
    values = dict(teff=np.linspace(4000.0, 10000.0, LIB_GRID[0]),
                  logg=np.linspace(0.5, 5.0, LIB_GRID[1]),
                  feh=np.linspace(-2.0, 0.0, LIB_GRID[2]),
                  alpha=np.linspace(0.0, 1.0, LIB_GRID[3]))
    for i, combo in enumerate(itertools.product(*values.values())):
        par = dict(zip(values, combo))
        fitsio.write(os.path.join(root, 'specs', f'lte{i:05d}.fits'),
                     [dict(kind='image',
                           data=simulation.fake_spectrum(lam, **par),
                           header=[(PHOENIX_KEYWORDS[k], float(v), '')
                                   for k, v in par.items()])])
    fitsio.write(os.path.join(root, 'wave.fits'),
                 [dict(kind='image', data=lam)])
    return i + 1


def build_library(workdir, device):
    """The library and its CCF bank from a FITS grid, each stage
    through its core: (specs dict, interp dict, stored spectra, bank
    (models, ffts, fft2s, info) with the continua fitted on ``device``,
    the CCF configuration, seconds per stage)."""
    from rvspecfit_torch.pipeline import (make_ccf, make_interpol, make_nd,
                                          mask_grid, read_grid)
    root = os.path.join(workdir, 'fits_grid')
    sec = {}
    t0 = time.perf_counter()
    ntempl = write_fits_grid(root)
    sec['fits_write'] = time.perf_counter() - t0
    db = os.path.join(root, 'files.db')
    t0 = time.perf_counter()
    read_grid.makedb(root, dbfile=db, mask='specs/*fits')
    sec['makedb'] = time.perf_counter() - t0
    nbad = mask_grid.mask_templates(db, mask_grid.PHOENIX_RULES)
    check(nbad == 0, f'the PHOENIX rules masked {nbad} of the synthetic '
          'grid\'s templates, none of which they name')
    t0 = time.perf_counter()
    with timed(read_grid, 'make_rebinner', sec, 'rebinner'):
        d = make_interpol.build_specs(
            (LIB_SETUP, *LIB_RANGE,
             make_interpol.Resolution(resol_func=LIB_RESOL), LIB_STEP,
             True), dbfile=db, prefix=root,
            wavefile=os.path.join(root, 'wave.fits'),
            resolution0=LIB_RESOLUTION0)
    sec['specs'] = time.perf_counter() - t0 - sec['rebinner']
    check(d['specs'].shape[0] == ntempl and d['specs'].dtype == np.float32
          and np.isfinite(d['specs']).all(),
          f'make_interpol gave specs {d["specs"].shape} '
          f'{d["specs"].dtype}')
    t0 = time.perf_counter()
    fd, dats = make_nd.build_interpolator(d, regular=True)
    sec['make_nd'] = time.perf_counter() - t0
    check(fd['idgrid'].shape == LIB_GRID and (fd['idgrid'] >= 0).all(),
          f'make_nd gave the id grid {fd["idgrid"].shape} with holes')
    ccfconf = make_ccf.get_ccf_config(
        logl0=np.log(LIB_RANGE[0]), logl1=np.log(LIB_RANGE[1]),
        npoints=make_ccf.to_power_two(
            int((LIB_RANGE[1] - LIB_RANGE[0]) / LIB_STEP)))
    t0 = time.perf_counter()
    with timed(make_ccf, 'preprocess_model_list', sec, 'bank_continua'):
        bank = make_ccf.build_bank(d, ccfconf, every=LIB_EVERY,
                                   vsinis=LIB_VSINIS, device=device)
    sec['bank_ffts'] = time.perf_counter() - t0 - sec['bank_continua']
    return d, fd, dats, bank, ccfconf, sec


def bank_against_cpu(d, ccfconf, bank):
    """The same bank built on the CPU: models and rFFTs within
    BANK_RTOL of the CPU's (relative to each array's largest entry),
    the same templates; returns (the largest difference relative to
    its array's largest entry, seconds, the CPU's bank)."""
    from rvspecfit_torch.pipeline import make_ccf
    t0 = time.perf_counter()
    cpu = make_ccf.build_bank(d, ccfconf, every=LIB_EVERY,
                              vsinis=LIB_VSINIS, device='cpu')
    seconds = time.perf_counter() - t0
    worst = 0.0
    for name, got, want in zip(('models', 'fft', 'fft2'), bank[:3],
                               cpu[:3]):
        scale = float(np.abs(want).max())
        worst = max(worst, float(np.abs(got - want).max()) / scale)
        check(np.allclose(got, want, rtol=BANK_RTOL,
                          atol=BANK_RTOL * scale),
              f'the card\'s bank {name} disagrees with the CPU\'s')
    for key in ('params', 'vsinis', 'vsini_is_none', 'parnames'):
        check(np.array_equal(bank[3][key], cpu[3][key]),
              f'the card\'s bank {key} differ from the CPU\'s')
    return worst, seconds, cpu


def run_library_builder(workdir, device):
    """Phase 12: the offline pipeline on the card's machine (build_library,
    the bank's continua on the card), the bank against the CPU's,
    kernel B against its plain version at the bank's shapes, then
    NFIBERS fibers of 3 arms drawn from the library through
    survey/desi._run_group_fit with the card-built bank, launches
    counted from 0: RV recovery, every kernel launched, and 8 fibers
    against the CPU float64 run (CPU model, CPU-built bank)."""
    import torch
    from rvspecfit_torch import convert, simulation
    from rvspecfit_torch.fit.batch import BatchArm
    from rvspecfit_torch.pipeline.library import \
        template_model_from_artifacts
    d, fd, dats, bank, ccfconf, sec = build_library(workdir, device)
    models, ffts, fft2s, info = bank
    log(f'library builder: {d["specs"].shape[0]} FITS templates x '
        f'{LIB_NPIX} px -> specs {d["specs"].shape} {d["specs"].dtype} '
        f'(R = {LIB_RESOL}, step {LIB_STEP} A) -> regular grid '
        f'{fd["idgrid"].shape} -> CCF bank {ffts.shape[0]} templates x '
        f'{ffts.shape[1]} frequencies (npoints {ccfconf["npoints"]}, '
        f'vsinis {LIB_VSINIS}, every {LIB_EVERY})')
    log('library builder seconds: ' + ', '.join(
        f'{k} {v:.3f}' for k, v in sec.items()))
    check(ffts.shape == (len(LIB_VSINIS) * int(np.ceil(
        np.prod(LIB_GRID) / LIB_EVERY)), ccfconf['npoints'] // 2 + 1),
        f'the bank has shape {ffts.shape}')
    worst, cpu_s, cpu_bank = bank_against_cpu(d, ccfconf, bank)
    log(f'bank built on the card vs on the CPU: max|diff| / max|cpu| '
        f'{worst:.3e} (limit rtol {BANK_RTOL:.0e}); CPU build '
        f'{cpu_s:.3f} s')

    tm = template_model_from_artifacts(fd, dats, device=device)
    tm_cpu = template_model_from_artifacts(fd, dats, device='cpu')
    bank_d = convert.ccf_bank(ffts, fft2s, info, device=device)
    arms_data, truth = simulation.model_exposure(
        tm_cpu, NFIBERS, npix_arm=NPIX_ARM, snr=50.0, seed=12,
        layout=LIB_LAYOUT)
    arms = [BatchArm(n, lam, fl, iv) for n, (lam, fl, iv)
            in arms_data.items()]
    args, cont = kernel_b_args(arms, bank_d)
    res_b = kernel_b_case(args, cont, 'kernel B on the built bank float64',
                          'float64')
    del args
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_group_fit(tm, arms, {a.name: bank_d for a in arms})
    torch.cuda.synchronize()
    sec['fit'] = time.perf_counter() - t0
    counts = kernel_counts()
    log(f'group fit through the built library: {sec["fit"]:.3f} s ('
        + ' '.join(f'{k}={out["phases"][k]:.3f}s' for k in PHASES)
        + f'); kernel launches {counts}')
    check_launches('library builder path', counts)
    check_outputs(out, NFIBERS, NPIX_ARM)
    dv = out['ref']['best_vel'] - truth['vel']
    ok = np.abs(dv) < np.maximum(10.0, 5 * out['ref']['vel_err'])
    log(f'RV recovery through the built library: {int(ok.sum())}/'
        f'{NFIBERS} within max(10, 5 sigma); median |dv| '
        f'{np.median(np.abs(dv)):.3f} km/s; BAD_HESSIAN '
        f'{int(out["bad_hess"].sum())}/{NFIBERS}')
    check(ok.sum() >= 0.98 * NFIBERS,
          f'RV recovery through the built library {ok.sum()}/{NFIBERS}')

    sub = [BatchArm(a.name, a.lam, a.flux[:8], a.ivar[:8]) for a in arms]
    cpu_bank_d = convert.ccf_bank(*cpu_bank[1:], device='cpu')
    small = {key: run_group_fit(tm_d, sub, {a.name: b for a in sub})
             for key, tm_d, b in (('cuda', tm, bank_d),
                                  ('cpu', tm_cpu, cpu_bank_d))}
    gc = small['cpu']
    dv8 = np.abs(small['cuda']['ref']['best_vel'] - gc['ref']['best_vel']) \
        / gc['ref']['vel_err']
    dp8 = np.abs(small['cuda']['params'] - gc['params']) / gc['errs']
    log(f'8 fibers through the built library, card vs CPU float64: max '
        f'|dv|/sigma {dv8.max():.3e}, max |dp|/sigma {np.nanmax(dp8):.3e} '
        '(limit 0.5)')
    check(dv8.max() <= 0.5 and np.nanmax(dp8) <= 0.5,
          'the card\'s fit through the built library disagrees with the '
          'CPU\'s')
    return dict(seconds=sec, counts=counts, kernel_b=res_b,
                recovered=int(ok.sum()), bank_max_rel=worst,
                max_dv_sigma_8=float(dv8.max()),
                max_dp_sigma_8=float(np.nanmax(dp8)),
                bank_shape=list(ffts.shape))


# ------------------------------------------------------------------
# the fleet: the DESI driver as processes claiming files from one queue

# 2 files, 1 a rank (8 until the overlap phase came, 6 until the NM
# scheme and trainer grid phases came)
FLEET_FILES = 2
FLEET_RANKS = 2
FLEET_SEED0 = 100
# a rank's run, its model build included, and the barrier's timeout (s)
FLEET_TIMEOUT = 600
# the fleet's run 2 against its run 1, and tiles against a whole group:
# every fiber's velocity and parameters within this share of the errors
SAME_SIGMA = 0.01
PARAM_COLUMNS = ('TEFF', 'LOGG', 'FEH', 'ALPHAFE')


def fleet_rank(argv):
    """One rank of the fleet phase (``chip_smoke.py --fleet-rank RANK
    HOST:PORT DIR``): builds the template model and the bank on its
    card (LOCAL_RANK picks it), joins the world through the driver's
    own wiring (survey/desi.fleet, as ``rvstorch_desi_fit
    --dynamic_queue --coordinator`` joins it), fits the files it claims
    at coalesce 1 with per-rank status and log files, and writes its
    wall times, launches and peak device memory to DIR/rank<RANK>.json."""
    import logging
    import torch
    from rvspecfit_torch import convert
    from rvspecfit_torch.device import resolve_device
    from rvspecfit_torch.pipeline import prewarm
    from rvspecfit_torch.survey import desi
    rank, addr, fdir = int(argv[0]), argv[1], argv[2]
    device = resolve_device(None)
    prewarm.build_kernels()
    tm = make_template_model(device)
    bank_d = convert.ccf_bank(*make_bank(), device=device)
    logging.basicConfig(filename=desi.per_rank(
        os.path.join(fdir, 'log_%d.txt'), rank), level=logging.INFO)
    with desi.fleet(input_file_from=os.path.join(fdir, 'files.txt'),
                    dynamic_queue=True, rank=rank, world=FLEET_RANKS,
                    coordinator=addr) as fl:
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        desi.proc_many(fl.files, os.path.join(fdir, 'out2'), config=CONFIG,
                       options=OPTIONS, coalesce=1,
                       status_fname=desi.per_rank(
                           os.path.join(fdir, 'status2_%d.txt'), fl.rank),
                       templates=per_setup(tm), banks=per_setup(bank_d),
                       throw_exceptions=True)
        torch.cuda.synchronize()
        rec = dict(rank=fl.rank, world=fl.world, t0=t0, t1=time.time(),
                   counts=kernel_counts(), device=str(device),
                   peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    with open(os.path.join(fdir, f'rank{rank}.json'), 'w') as fp:
        json.dump(rec, fp)
    return 0


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def start_ranks(fdir):
    """FLEET_RANKS rank processes of this script on the card: their
    exit codes (each rank's output in DIR/rank<r>.out) and the wall from
    their start to the last one's exit.  A rank still running at
    FLEET_TIMEOUT is killed."""
    addr = f'127.0.0.1:{free_port()}'
    env = dict(os.environ, RVST_BARRIER_TIMEOUT_MS=str(FLEET_TIMEOUT * 1000))
    procs, outs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(FLEET_RANKS):
            outs.append(open(os.path.join(fdir, f'rank{r}.out'), 'w'))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--fleet-rank',
                 str(r), addr, fdir], stdout=outs[-1],
                stderr=subprocess.STDOUT, env=dict(env, LOCAL_RANK=str(r))))
        deadline = time.monotonic() + FLEET_TIMEOUT
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fp in outs:
            fp.close()
    return rcs, time.perf_counter() - t0


def fleet_tables(files, outdir):
    from rvspecfit_torch.io import fitsio
    from rvspecfit_torch.survey import desi
    return [fitsio.read(desi.output_paths(f, outdir)[0])['RVTAB'].data
            for f in files]


def sigma_spread(got, want, err):
    """|got - want| / err elementwise, 0 where got equals want (so an
    equal value with a non-finite error passes)."""
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(got == want, 0.0, np.abs(got - want) / err)


def table_values(tab):
    """(values, errors) of VRAD and the parameters of an RVTAB: two
    (nfib, 5) arrays."""
    cols = ('VRAD',) + PARAM_COLUMNS
    return (np.stack([tab[c] for c in cols], 1),
            np.stack([tab[c + '_ERR'] for c in cols], 1))


def run_fleet(workdir, tm, bank_d):
    """The slice's path at full width: FLEET_FILES coadds of NFIBERS
    fibers (seeds 100-101), run 1 in this process over the static list
    at coalesce 1, run 2 by FLEET_RANKS rank processes on the one card
    claiming the same files through --dynamic_queue (fleet_rank).
    Checks that each rank exited 0, that every file was fitted exactly
    once across the ranks, RV recovery per file, and every fiber of run
    2 within SAME_SIGMA of run 1's errors; prints the walls, files and
    s/file per rank, the aggregate files/s of 2 ranks against 1 and the
    peak device memory of each."""
    import torch
    from rvspecfit_torch.survey import desi
    fdir = os.path.join(workdir, 'fleet')
    os.makedirs(fdir)
    files, truths = driver_inputs(fdir, nfiles=FLEET_FILES, seed0=FLEET_SEED0)
    with open(os.path.join(fdir, 'files.txt'), 'w') as fp:
        fp.write(''.join(f + '\n' for f in files))

    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    desi.proc_many(files, os.path.join(fdir, 'out1'), config=CONFIG,
                   options=OPTIONS, coalesce=1, templates=per_setup(tm),
                   banks=per_setup(bank_d), throw_exceptions=True,
                   status_fname=os.path.join(fdir, 'status1.txt'))
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    counts1 = kernel_counts()
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    check_launches('fleet run 1', counts1)
    log(f'fleet run 1 (one process, coalesce 1): {FLEET_FILES} files in '
        f'{wall1:.3f} s = {wall1 / FLEET_FILES:.3f} s/file, '
        f'{FLEET_FILES / wall1:.4f} files/s; peak device memory '
        f'{peak1:.2f} GB; launches {counts1}')

    torch.cuda.empty_cache()
    rcs, wall2 = start_ranks(fdir)
    for r, rc in enumerate(rcs):
        if rc:
            with open(os.path.join(fdir, f'rank{r}.out')) as fp:
                log(f'fleet rank {r} exited {rc}; its output ends:\n'
                    + fp.read()[-3000:])
    check(rcs == [0] * FLEET_RANKS, f'fleet ranks exited {rcs}')
    recs = []
    for r in range(FLEET_RANKS):
        with open(os.path.join(fdir, f'rank{r}.json')) as fp:
            recs.append(json.load(fp))
    fitted = {r: read_status(os.path.join(fdir, f'status2_{r}.txt'))
              for r in range(FLEET_RANKS)}
    claimed = [ln[0] for lines in fitted.values() for ln in lines]
    check(sorted(claimed) == sorted(files), 'fleet: the files fitted across '
          f'the ranks are not each file once: {fitted}')
    check(all(ln[1:3] == ['SUCCESS', str(NFIBERS)]
              for lines in fitted.values() for ln in lines),
          f'fleet status lines: {fitted}')
    span = max(r['t1'] for r in recs) - min(r['t0'] for r in recs)
    counts2 = {f: {k: sum(r['counts'][f][k] for r in recs) for k in KERNELS}
               for f in FORMS}
    check_launches('fleet run 2 (both ranks)', counts2)
    for r, rec in enumerate(recs):
        n = len(fitted[r])
        fit_s = rec['t1'] - rec['t0']
        log(f'fleet rank {r} ({rec["device"]}): {n} files in {fit_s:.3f} s'
            + (f' = {fit_s / n:.3f} s/file' if n else '')
            + f'; peak device memory {rec["peak_gb"]:.2f} GB; launches '
            f'{rec["counts"]["float64"]}')
    log(f'fleet run 2 ({FLEET_RANKS} ranks on one card, --dynamic_queue): '
        f'wall {wall2:.3f} s from the ranks\' start to their exit (start-up '
        f'and model build included); fitting span {span:.3f} s -> '
        f'{FLEET_FILES / span:.4f} files/s against run 1\'s '
        f'{FLEET_FILES / wall1:.4f} ({wall1 / span:.3f}x); files per rank '
        f'{[len(fitted[r]) for r in range(FLEET_RANKS)]}')

    tabs1 = fleet_tables(files, os.path.join(fdir, 'out1'))
    tabs2 = fleet_tables(files, os.path.join(fdir, 'out2'))
    recovered, worst = [], 0.0
    for f, t1, t2, truth in zip(files, tabs1, tabs2, truths):
        check(np.array_equal(t1['TARGETID'], t2['TARGETID']),
              f'{f}: fleet runs fitted other targets')
        for tag, t in (('run 1', t1), ('run 2', t2)):
            ok = np.abs(t['VRAD'] - truth['vel']) < np.maximum(
                10.0, 5 * t['VRAD_ERR'])
            check(ok.sum() >= 0.98 * NFIBERS,
                  f'{f} (fleet {tag}): RV recovery {ok.sum()}/{NFIBERS}')
            if tag == 'run 2':
                recovered.append(int(ok.sum()))
        d = sigma_spread(table_values(t2)[0], *table_values(t1))
        check((d <= SAME_SIGMA).all(), f'{f}: fleet run 2 differs from run '
              f'1 by up to {np.nanmax(d):.3g} sigma (limit {SAME_SIGMA})')
        worst = max(worst, float(d.max()))
    log(f'fleet: every file fitted once across the ranks; RV recovery per '
        f'file (run 2, of {NFIBERS}) {recovered}; run 2 against run 1, '
        f'largest difference over all fibers {worst:.3g} sigma (limit '
        f'{SAME_SIGMA})')
    return dict(wall1=wall1, wall2=wall2, span=span, counts=counts1,
                counts_ranks=[r['counts'] for r in recs], peak1=peak1,
                peak_ranks=[r['peak_gb'] for r in recs], max_sigma=worst,
                files_per_rank=[len(fitted[r]) for r in range(FLEET_RANKS)])


# ------------------------------------------------------------------
# fiber microbatching: a large group whole and in tiles

MB_NFIBERS = 1000
MB_TILE = NFIBERS


def run_microbatch(tm, bank_d):
    """_run_group_fit on MB_NFIBERS fibers (make_exposure seed 7) whole
    and with config fit_microbatch=MB_TILE: wall, phases and peak
    device memory of each (and of the CCF start alone, which is not
    tiled); every fiber equal within SAME_SIGMA of the whole fit's
    errors, and RV recovery."""
    import torch
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit.batch import BatchArm
    from rvspecfit_torch.survey import desi
    arms_data, truth = simulation.make_exposure(
        MB_NFIBERS, npix_arm=NPIX_ARM, snr=50.0, seed=7)
    arms = [BatchArm(n, lam, fl, iv) for n, (lam, fl, iv)
            in arms_data.items()]
    banks = {a.name: bank_d for a in arms}
    templates = {a.name: tm for a in arms}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    desi.ccf_starts(arms, tm.parnames, CONFIG, banks, tm.geom.h.device)
    torch.cuda.synchronize()
    ccf_peak = torch.cuda.max_memory_allocated() / 1e9
    runs = {}
    for tile in (None, MB_TILE):
        cfg = dict(CONFIG) if tile is None else dict(CONFIG,
                                                     fit_microbatch=tile)
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = desi._run_group_fit(arms, templates, cfg, OPTIONS, banks=banks,
                                  defer=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = kernel_counts()
        check_launches(f'microbatch {tile}', counts)
        check_outputs(out, MB_NFIBERS, NPIX_ARM)
        dv = out['ref']['best_vel'] - truth['vel']
        ok = np.abs(dv) < np.maximum(10.0, 5 * out['ref']['vel_err'])
        check(ok.sum() >= 0.98 * MB_NFIBERS,
              f'microbatch {tile}: RV recovery {ok.sum()}/{MB_NFIBERS}')
        runs[tile] = dict(out=out, wall=wall, peak=peak, counts=counts,
                          recovered=int(ok.sum()))
        log(f'group fit of {MB_NFIBERS} fibers, '
            + ('whole' if tile is None else f'fit_microbatch={tile}')
            + f': {wall:.3f} s (' + ' '.join(
                f'{k}={out["phases"][k]:.3f}s' for k in PHASES)
            + f'); peak device memory {peak:.2f} GB; RV recovery '
            f'{int(ok.sum())}/{MB_NFIBERS}; launches {counts["float64"]}')
    def values(out):
        return np.column_stack([out['ref']['best_vel'], out['params']])
    w = runs[None]['out']
    d = sigma_spread(values(runs[MB_TILE]['out']), values(w),
                     np.column_stack([w['ref']['vel_err'], w['errs']]))
    check((d <= SAME_SIGMA).all(), f'microbatch: tiles differ from the '
          f'whole fit by up to {np.nanmax(d):.3g} sigma')
    log(f'microbatch: the CCF start alone peaks at {ccf_peak:.2f} GB; tiles '
        f'of {MB_TILE} against the whole group, largest difference '
        f'{float(d.max()):.3g} sigma (limit {SAME_SIGMA})')
    return dict(ccf_peak=ccf_peak, max_sigma=float(d.max()),
                **{('whole' if k is None else f'tile{k}'): dict(
                    wall=v['wall'], peak_gb=v['peak'], phases=v['out'][
                        'phases'], recovered=v['recovered'])
                   for k, v in runs.items()})


# ------------------------------------------------------------------
# fast_interp and prewarm, small

FAST_RTOL = 1e-9
PREWARM_NFIBERS = 64


def run_fast_interp(tm, tm_cpu):
    """One vel_fit.process with options fast_interp (the nearest-pixel
    gather: no kernel A) on the card, and its chi-square at the card's
    optimum on the card and on the CPU, both float64 (rtol FAST_RTOL)."""
    from rvspecfit_torch.fit import vel_fit
    from rvspecfit_torch.fit.likelihood import FusedChisq
    objs, truth = single_objects()
    sds = objs[0]
    options = dict(OPTIONS, fast_interp=True)
    t0 = time.perf_counter()
    res = vel_fit.process(sds, START, config=CONFIG, options=options,
                          templates={sd.name: tm for sd in sds})
    wall = time.perf_counter() - t0
    params = [res['param'][p] for p in tm.parnames]
    chi = {key: FusedChisq(sds, {sd.name: m for sd in sds}, CONFIG,
                           options=options).chisq_one(res['vel'], params)
           for key, m in (('cuda', tm), ('cpu', tm_cpu))}
    rel = abs(chi['cuda'] / chi['cpu'] - 1)
    log(f'fast_interp process on the card: {wall:.3f} s, vel '
        f'{res["vel"]:.3f} +- {res["vel_err"]:.3f} (truth '
        f'{truth["vel"][0]:.3f}); chi-square there card {chi["cuda"]:.10g}, '
        f'CPU {chi["cpu"]:.10g}, rel diff {rel:.3g} (limit {FAST_RTOL})')
    check(rel <= FAST_RTOL, 'fast_interp chi-square: card against CPU')
    check(abs(res['vel'] - truth['vel'][0]) < max(10.0, 5 * res['vel_err']),
          'fast_interp process: RV')
    return dict(seconds=wall, rel=rel)


def run_prewarm(tm, bank_d):
    """pipeline/prewarm's core: a PREWARM_NFIBERS-fiber synthetic coadd
    of the 3-arm layout through the driver with in-memory models."""
    from rvspecfit_torch import simulation
    from rvspecfit_torch.pipeline import prewarm
    waves = {n.lower(): np.linspace(l0, l1, NPIX_ARM)
             for n, (l0, l1) in simulation.THREE_ARM_LAYOUT.items()}
    reset_counts()
    seconds = prewarm.prewarm(waves, PREWARM_NFIBERS, CONFIG, options=OPTIONS,
                              templates=per_setup(tm),
                              banks=per_setup(bank_d))
    counts = kernel_counts()
    check_launches('prewarm', counts)
    log(f'prewarm core: one {PREWARM_NFIBERS}-fiber synthetic coadd through '
        f'the driver in {seconds:.3f} s; launches {counts["float64"]}')
    return dict(seconds=seconds, counts=counts)


# ------------------------------------------------------------------
# phase 17: the drivers' overlaps; phase 18: the fitter on a mesh

OVERLAP_FILES = 4
OVERLAP_SEED0 = 100
OVERLAP_SWITCHES = ('RVST_PIPELINE_PREP', 'RVST_DEFER_TAIL',
                    'RVST_ASYNC_WRITE')
# (run, overlaps on): serial and overlapped (phase 17), then again in
# reverse order under the profiler (phase 21)
OVERLAP_ORDER = (('serial', False), ('overlap', True), ('overlap2', True),
                 ('serial2', False))
OVERLAP_WEAVE_SEEDS = (42, 43)
# phase 7's 8-fiber pair: a shape the card has run by then
OVERLAP_WEAVE_NFIB = 8
MESH = ('cuda:0', 'cuda:0')


@contextlib.contextmanager
def overlap_switches(on):
    """The three overlap switches at their defaults (``on``) or at 0."""
    saved = {k: os.environ.get(k) for k in OVERLAP_SWITCHES}
    for k in OVERLAP_SWITCHES:
        if on:
            os.environ.pop(k, None)
        else:
            os.environ[k] = '0'
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def union_ms(spans):
    """Milliseconds covered by the union of (start_ns, end_ns) spans."""
    total, cur_lo, cur_hi = 0, None, None
    for lo, hi in sorted(spans):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total / 1e6


def device_busy(fn):
    """fn() under torch.profiler's CUDA activity: fn's value and the
    card's busy time as the union of the intervals of its kernels,
    copies and sets over every stream (work of two streams at once
    counts once, so the share cannot pass 100%), beside their sum, the
    wall and the number of intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda and not e.is_user_annotation()]
    busy = union_ms(spans)
    return value, dict(busy_ms=busy, sum_ms=sum(hi - lo for lo, hi in spans)
                       / 1e6, wall_ms=wall_ms, busy_share=busy / wall_ms,
                       intervals=len(spans))


@contextlib.contextmanager
def gc_time(into):
    """Add to ``into['gc_s']`` the seconds the interpreter spends in
    garbage collections inside the block and to ``into['gc_full']``
    the number of its full (generation 2) collections."""
    import gc
    into.update(gc_s=0.0, gc_full=0)
    started = []

    def callback(phase, info):
        if phase == 'start':
            started.append(time.perf_counter())
        elif started:
            into['gc_s'] += time.perf_counter() - started.pop()
            into['gc_full'] += info['generation'] == 2
    gc.callbacks.append(callback)
    try:
        yield into
    finally:
        gc.callbacks.remove(callback)


def overlap_run(files, outdir, status, tm, bank_d, records=None):
    """survey/desi.proc_many over ``files`` at COALESCE, crash isolation
    off, launches counted from 0: its wall, launches, peak device
    memory, status lines and stamps, the seconds spent in garbage
    collections and the threads alive at its start.  ``records``: a
    list to which group_fits appends each group fit's record."""
    import threading
    import torch
    from rvspecfit_torch.survey import desi
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gcs = dict(threads=threading.active_count())
    t_start = time.time()
    t0 = time.perf_counter()
    with gc_time(gcs), (contextlib.nullcontext() if records is None
                        else group_fits(records)):
        desi.proc_many(files, outdir, config=CONFIG, options=OPTIONS,
                       status_fname=status, coalesce=COALESCE,
                       templates=per_setup(tm), banks=per_setup(bank_d),
                       throw_exceptions=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = read_status(status)
    check([ln[0] for ln in lines] == files
          and all(ln[1:3] == ['SUCCESS', str(NFIBERS)] and len(ln) == 5
                  for ln in lines), f'overlap status lines: {lines}')
    stamps = [float(ln[4]) for ln in lines]
    check(stamps == sorted(stamps), f'status stamps go back: {stamps}')
    written = sorted(os.listdir(outdir))
    check(written == sorted(os.path.basename(p) for f in files
                            for p in desi.output_paths(f, outdir)),
          f'outputs written: {written}')
    cold = stamps[COALESCE - 1] - t_start
    steady = (stamps[-1] - stamps[COALESCE - 1]) / (len(files) - COALESCE)
    return dict(wall=wall, counts=kernel_counts(), cold=cold, steady=steady,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                per_file=[float(ln[3]) for ln in lines], **gcs)


def run_overlaps(workdir, tm, bank_d, models, bks):
    """Phase 17: OVERLAP_FILES coadds of NFIBERS fibers (seeds 100-103)
    through survey/desi.proc_many at COALESCE, serial, then overlapped
    (serial: the three overlap switches at 0; overlapped: at their
    defaults; the lookahead reader is on in both); phase 21 runs them
    again in reverse order, so that a drift of the host shows apart from
    the switches.  Checks every file written once, the status lines in
    input order with stamps that do not go back, RV recovery per file
    and every fiber of the overlapped run within SAME_SIGMA of the
    serial run; prints per run the steady s/file from the
    status stamps, the cold group, the peak device memory, the launches,
    the seconds spent in garbage collections and the threads alive at
    its start; the launches of each group fit of the first serial run
    (no tail or CCF of another group overlaps it there).  Then
    survey/weave.proc_many over two OVERLAP_WEAVE_NFIB-fiber pairs without
    and with the prefetch: equal tables.  Also returns the serial run's
    tables as ``serial_tables`` for phase 21."""
    from rvspecfit_torch.io import fitsio
    from rvspecfit_torch.survey import weave
    odir = os.path.join(workdir, 'overlap')
    os.makedirs(odir)
    files, truths = driver_inputs(odir, nfiles=OVERLAP_FILES,
                                  seed0=OVERLAP_SEED0)
    runs, groups = {}, []
    for key, on in OVERLAP_ORDER[:2]:
        with overlap_switches(on):
            r = overlap_run(files, os.path.join(odir, f'out-{key}'),
                            os.path.join(odir, f'status-{key}.txt'), tm,
                            bank_d, records=groups if key == 'serial'
                            else None)
            check_launches(f'overlap phase ({key})', r['counts'])
        runs[key] = r
        log(f'overlap phase, {key} (switches '
            f'{"at their defaults" if on else "at 0"}): {len(files)} files '
            f'in {r["wall"]:.3f} s; steady {r["steady"]:.3f} s/file from the '
            f'status stamps, cold group {r["cold"]:.3f} s; per-file seconds '
            f'{r["per_file"]}; peak device memory {r["peak_gb"]:.2f} GB; '
            f'launches {r["counts"]["float64"]}; garbage collection '
            f'{r["gc_s"]:.3f} s ({r["gc_full"]} full); {r["threads"]} '
            f'threads alive at the start')
    per_group = [g['launches'] for g in groups]
    for g in groups:
        g['arms'] = g['out'] = None
    log(f'overlap phase, serial: launches per group fit {per_group}')
    worst, recovered = 0.0, []
    tabs = {k: fleet_tables(files, os.path.join(odir, f'out-{k}'))
            for k in runs}
    for i, (f, truth) in enumerate(zip(files, truths)):
        ts = tabs['serial'][i]
        for k in runs:
            to = tabs[k][i]
            check(np.array_equal(ts['TARGETID'], to['TARGETID']),
                  f'{f}: run {k} fitted other targets')
            d = sigma_spread(table_values(to)[0], *table_values(ts))
            check((d <= SAME_SIGMA).all(), f'{f}: run {k} differs from the '
                  f'first serial one by up to {np.nanmax(d):.3g} sigma')
            worst = max(worst, float(d.max()))
        to = tabs['overlap'][i]
        ok = np.abs(to['VRAD'] - truth['vel']) < np.maximum(
            10.0, 5 * to['VRAD_ERR'])
        recovered.append(int(ok.sum()))
        check(ok.sum() >= 0.98 * NFIBERS,
              f'{f} (overlapped): RV recovery {ok.sum()}/{NFIBERS}')
    s, o = runs['serial'], runs['overlap']
    log(f'overlap phase: every file written once, status lines in input '
        f'order; RV recovery per file (overlapped, of {NFIBERS}) '
        f'{recovered}; the overlapped run against the serial one, largest '
        f'difference over all fibers {worst:.3g} sigma (limit '
        f'{SAME_SIGMA}); steady s/file {s["steady"]:.3f} -> '
        f'{o["steady"]:.3f}; peak {s["peak_gb"]:.2f} -> {o["peak_gb"]:.2f} '
        'GB')

    groups = [write_weave_pair(odir, OVERLAP_WEAVE_NFIB, seed)[0]
              for seed in OVERLAP_WEAVE_SEEDS]
    wv = {}
    for prefetch in (False, True):
        outdir = os.path.join(odir, f'weave-{prefetch}')
        reset_counts()
        t0 = time.perf_counter()
        weave.proc_many(groups, outdir, CONFIG, options=WEAVE_OPTIONS,
                        throw_exceptions=True, prefetch=prefetch,
                        templates={f'weave_{s}': models['cuda']
                                   for s in WEAVE_LAYOUT},
                        banks={f'weave_{s}': bks['cuda']
                               for s in WEAVE_LAYOUT})
        wv[prefetch] = dict(wall=time.perf_counter() - t0,
                            counts=kernel_counts(), tabs=[
                                fitsio.read(weave.output_path(g, outdir))[
                                    'WEAVE_RV'].data for g in groups])
        check_launches(f'WEAVE prefetch={prefetch}', wv[prefetch]['counts'])
    for got, want in zip(wv[True]['tabs'], wv[False]['tabs']):
        check(list(got) == list(want) and all(
            np.array_equal(got[k], want[k]) for k in want),
            'WEAVE with the prefetch differs from WEAVE without it')
    log(f'overlap phase, WEAVE: {len(groups)} pairs of {OVERLAP_WEAVE_NFIB} '
        f'fibers without / with the prefetch {wv[False]["wall"]:.3f} / '
        f'{wv[True]["wall"]:.3f} s, tables equal')
    return dict(max_sigma=worst, recovered=recovered,
                weave_s={str(k): v['wall'] for k, v in wv.items()},
                counts=o['counts'], counts_serial=s['counts'],
                per_group=per_group, serial_tables=tabs['serial'],
                **{k: {key: v[key] for key in (
                    'wall', 'steady', 'cold', 'peak_gb', 'gc_s', 'gc_full',
                    'threads')}
                   for k, v in runs.items()})


def run_overlap_busy(workdir, tm, bank_d, serial_tables):
    """Phase 21, the script's last (a process runs slower after a
    profiler session): phase 17's runs again in reverse order,
    overlapped then serial, each under the profiler over the same
    OVERLAP_FILES coadds.  Checks each as phase 17 does, every fiber
    within SAME_SIGMA of phase 17's serial run (``serial_tables``);
    prints per run the steady s/file, the cold group, the peak and the
    card's busy share (the union of its intervals over the wall).
    {run: {wall, steady, cold, peak_gb, gc_s, gc_full, threads,
    busy}}."""
    files, _ = driver_inputs(workdir, nfiles=OVERLAP_FILES,
                             seed0=OVERLAP_SEED0)
    out, worst = {}, 0.0
    for key, on in OVERLAP_ORDER[2:]:
        t0 = time.perf_counter()
        outdir = os.path.join(workdir, f'out-{key}')
        with overlap_switches(on):
            r, busy = device_busy(lambda: overlap_run(
                files, outdir, os.path.join(workdir, f'status-{key}.txt'),
                tm, bank_d))
        check_launches(f'overlap phase ({key})', r['counts'])
        for f, to, ts in zip(files, fleet_tables(files, outdir),
                             serial_tables):
            check(np.array_equal(ts['TARGETID'], to['TARGETID']),
                  f'{f}: run {key} fitted other targets')
            d = sigma_spread(table_values(to)[0], *table_values(ts))
            check((d <= SAME_SIGMA).all(), f'{f}: run {key} differs from '
                  f'the serial one by up to {np.nanmax(d):.3g} sigma')
            worst = max(worst, float(d.max()))
        out[key] = dict({k: r[k] for k in (
            'wall', 'steady', 'cold', 'peak_gb', 'gc_s', 'gc_full',
            'threads')}, busy=busy)
        log(f'overlap phase, {key} (switches '
            f'{"at their defaults" if on else "at 0"}), under the profiler: '
            f'{len(files)} files in {r["wall"]:.3f} s; steady '
            f'{r["steady"]:.3f} s/file, cold group {r["cold"]:.3f} s; peak '
            f'device memory {r["peak_gb"]:.2f} GB; card busy '
            f'{busy["busy_ms"]:.1f} ms (union) of {busy["wall_ms"]:.1f} ms '
            f'= {busy["busy_share"]:.4f}, intervals summed '
            f'{busy["sum_ms"]:.1f} ms, {busy["intervals"]} intervals; '
            f'{time.perf_counter() - t0:.1f} s with the profiler\'s start, '
            'stop and the intervals\' union')
    share = {k: v['busy']['busy_share'] for k, v in out.items()}
    log(f'overlap phase under the profiler: every fiber against the '
        f'serial run, largest difference {worst:.3g} sigma (limit '
        f'{SAME_SIGMA}); busy share {share["serial2"]:.4f} serial -> '
        f'{share["overlap2"]:.4f} overlapped')
    return out


def run_mesh(tm, arms, truth, banks):
    """Phase 18: survey/desi._run_group_fit on the NFIBERS-fiber
    exposure unsharded, then with its fitter sharded over MESH (the one
    card named twice: two shards, two host threads) through
    parallel/mesh.auto_shard, each with the tail deferred as the
    drivers defer it by default (the tail runs on a worker thread over
    a snapshot of the fitter, after _run_group_fit has dropped the
    fitter) and collected at once.
    Checks that auto_shard does nothing on the one card, every kernel
    launched in the sharded run, and every fiber within SAME_SIGMA of
    the unsharded fit; prints both walls and phases."""
    import torch
    from rvspecfit_torch.fit.batch import BatchedFitter
    from rvspecfit_torch.parallel import mesh as pmesh
    from rvspecfit_torch.survey import desi
    one = BatchedFitter(arms, {a.name: tm for a in arms}, CONFIG, OPTIONS)
    check(torch.cuda.device_count() > 1 or pmesh.auto_shard(one) is None,
          'auto_shard sharded the fitter on a one-card host')
    del one
    real = pmesh.auto_shard
    sharded = lambda bf: real(bf, devices=list(MESH))  # noqa: E731
    runs = {}
    for key in ('unsharded', 'sharded'):
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (mock.patch.object(desi.pmesh, 'auto_shard', sharded)
              if key == 'sharded' else contextlib.nullcontext()):
            out = desi._run_group_fit(arms, {a.name: tm for a in arms},
                                      CONFIG, OPTIONS, banks=banks,
                                      defer=True).materialize()
        torch.cuda.synchronize()
        runs[key] = dict(out=out, wall=time.perf_counter() - t0,
                         counts=kernel_counts())
        check_launches(f'mesh phase ({key})', runs[key]['counts'])
        check_outputs(out, NFIBERS, NPIX_ARM)
        log(f'mesh phase, {key}: {runs[key]["wall"]:.3f} s (' + ' '.join(
            f'{k}={out["phases"][k]:.3f}s' for k in PHASES)
            + f'); launches {runs[key]["counts"]["float64"]}')

    def values(out):
        return np.column_stack([out['ref']['best_vel'], out['params']])
    w, g = runs['unsharded']['out'], runs['sharded']['out']
    d = sigma_spread(values(g), values(w),
                     np.column_stack([w['ref']['vel_err'], w['errs']]))
    check((d <= SAME_SIGMA).all(), f'mesh: the sharded fit differs from the '
          f'unsharded one by up to {np.nanmax(d):.3g} sigma')
    ok = np.abs(g['ref']['best_vel'] - truth['vel']) < np.maximum(
        10.0, 5 * g['ref']['vel_err'])
    check(ok.sum() >= 0.98 * NFIBERS, f'mesh: RV recovery {ok.sum()}')
    log(f'mesh phase: sharded over {MESH} against unsharded, largest '
        f'difference {float(d.max()):.3g} sigma (limit {SAME_SIGMA}); RV '
        f'recovery {int(ok.sum())}/{NFIBERS}')
    return dict(max_sigma=float(d.max()), counts=runs['sharded']['counts'],
                **{k: dict(wall=v['wall'], phases=v['out']['phases'])
                   for k, v in runs.items()})


# phase 19: the NM schemes in alternating order (one configuration
# drifts within a process, PERF.md section 7)
NM_SCHEME_ORDER = ('scan2', 'cand4', 'cand4', 'scan2')
# a scheme's fibers against the first scan2 run's, and the card's 8
# fibers under cand4 against the CPU's: the card-vs-CPU limit
SCHEME_SIGMA = 0.5


@contextlib.contextmanager
def nm_scheme(scheme):
    """RVST_NM_SCHEME set to ``scheme`` inside the block."""
    with mock.patch.dict(os.environ, RVST_NM_SCHEME=scheme):
        yield


@contextlib.contextmanager
def nm_accounting(record):
    """Count, into ``record``, NM's iterations (steps), the fibers they
    advance (fiber_iters), its objective calls by points per fiber (K:
    calls and rows), its simplex set-ups (init_calls) and their rows
    (init_rows), and kernel A's per-row launches inside run_neldermead
    (nm_row_launches)."""
    from rvspecfit_torch import trace
    from rvspecfit_torch.fit import batch, neldermead as nm
    real_obj, real_step, real_init = (batch.BatchedFitter._objective,
                                      nm._step, nm.nm_init)
    real_nm = batch.BatchedFitter.run_neldermead
    record.update(steps=0, fiber_iters=0, calls={}, init_rows=0,
                  init_calls=0, nm_row_launches=0)

    def objective(self, *args):
        fun = real_obj(self, *args)

        def counted(x):
            c = record['calls'].setdefault(int(x.shape[1]), [0, 0])
            c[0] += 1
            c[1] += int(x.shape[0] * x.shape[1])
            return fun(x)
        return counted

    def step(fun, simplex, *args):
        record['steps'] += 1
        record['fiber_iters'] += int(simplex.shape[0])
        return real_step(fun, simplex, *args)

    def init(fun, simplex, *args):
        record['init_rows'] += int(simplex.shape[0] * simplex.shape[1])
        record['init_calls'] += 1
        return real_init(fun, simplex, *args)

    def row_launches():
        return sum(trace.counters('kernel_a.per_row.').values())

    def run_nm(self, *args, **kwargs):
        before = row_launches()
        out = real_nm(self, *args, **kwargs)
        record['nm_row_launches'] += row_launches() - before
        return out
    with mock.patch.object(batch.BatchedFitter, '_objective', objective), \
            mock.patch.object(nm, '_step', step), \
            mock.patch.object(nm, 'nm_init', init), \
            mock.patch.object(batch.BatchedFitter, 'run_neldermead', run_nm):
        yield


def run_nm_schemes(tm, arms, truth, banks, tm_cpu, bank_cpu):
    """Phase 19: survey/desi._run_group_fit on the NFIBERS-fiber exposure
    under RVST_NM_SCHEME in NM_SCHEME_ORDER.  Checks for each run RV
    recovery, every kernel launched, NM's objective calls per iteration
    (one (B, 4) call under cand4, two (B, 1) calls under scan2, shrink
    steps apart), obj_evals per fiber and iteration (4 and 2), and
    every fiber's velocity and parameters within SCHEME_SIGMA of the
    first scan2 run; then the 8-fiber group fit under cand4 on the card
    against the CPU float64 run (velocities within max(1 km/s, sigma/2),
    parameters within sigma/2).  Prints each run's NM wall, phases,
    kernel A's per-row launches in NM, obj_evals and peak memory."""
    import torch
    from rvspecfit_torch.fit import neldermead as nm
    from rvspecfit_torch.fit.batch import BatchArm
    runs = []
    for scheme in NM_SCHEME_ORDER:
        acc = {}
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with nm_scheme(scheme), nm_accounting(acc):
            out = run_group_fit(tm, arms, banks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_launches(f'NM scheme {scheme}', counts)
        check_outputs(out, NFIBERS, NPIX_ARM)
        ok = np.abs(out['ref']['best_vel'] - truth['vel']) < np.maximum(
            10.0, 5 * out['ref']['vel_err'])
        check(ok.sum() >= 0.98 * NFIBERS,
              f'NM scheme {scheme}: RV recovery {ok.sum()}/{NFIBERS}')
        k = NCAND4 if scheme == 'cand4' else 1
        calls = acc['calls'].get(k, [0, 0])[0] / acc['steps']
        trials = (out['nm']['obj_evals'] - acc['init_rows']) \
            / acc['fiber_iters']
        check(calls == (1 if scheme == 'cand4' else 2),
              f'NM scheme {scheme}: {calls} objective calls per iteration')
        check(trials == nm.nm_ncand(scheme),
              f'NM scheme {scheme}: {trials} trials per fiber-iteration')
        run = dict(scheme=scheme, wall=wall, nm_s=out['phases']['nm'],
                   phases=out['phases'], peak_gb=peak,
                   obj_evals=int(out['nm']['obj_evals']),
                   nm_iterations=acc['steps'],
                   fiber_iterations=acc['fiber_iters'],
                   calls_per_iteration=calls,
                   trials_per_fiber_iteration=trials,
                   nm_per_row_launches=acc['nm_row_launches'],
                   shrink_calls=acc['calls'].get(
                       out['nm']['x'].shape[1] + 1, [0])[0]
                   - acc['init_calls'],
                   recovered=int(ok.sum()), counts=counts, out=out)
        runs.append(run)
        log(f'NM scheme {scheme}: group fit {wall:.3f} s (' + ' '.join(
            f'{p}={out["phases"][p]:.3f}s' for p in PHASES) + f'); NM '
            f'{acc["steps"]} iterations over {acc["fiber_iters"]} '
            f'fiber-iterations, {calls:g} objective call(s) per iteration, '
            f'{trials:g} trials per fiber-iteration, obj_evals '
            f'{run["obj_evals"]}, kernel A per-row launches in NM '
            f'{acc["nm_row_launches"]}; peak device memory {peak:.2f} GB; '
            f'RV recovery {int(ok.sum())}/{NFIBERS}; launches '
            f'{counts["float64"]}')

    def values(out):
        return np.column_stack([out['ref']['best_vel'], out['params']])
    w = runs[0]['out']
    err = np.column_stack([w['ref']['vel_err'], w['errs']])
    for run in runs[1:]:
        d = sigma_spread(values(run['out']), values(w), err)
        run['max_sigma_vs_scan2'] = float(np.nanmax(d))
        check((d <= SCHEME_SIGMA).all(), f'NM scheme {run["scheme"]}: '
              f'fibers differ from the first scan2 run by up to '
              f'{np.nanmax(d):.3g} sigma')
    log('NM schemes against the first scan2 run, largest difference '
        '(sigma): ' + ', '.join(f'{r["scheme"]} {r["max_sigma_vs_scan2"]:.3g}'
                                for r in runs[1:])
        + f' (limit {SCHEME_SIGMA})')

    sub = [BatchArm(a.name, a.lam, a.flux[:8], a.ivar[:8]) for a in arms]
    small = {}
    with nm_scheme('cand4'):
        for key, tm_d, bank_d in (('cuda', tm, banks[arms[0].name]),
                                  ('cpu', tm_cpu, bank_cpu)):
            small[key] = run_group_fit(tm_d, sub, {a.name: bank_d
                                                   for a in sub})
    g, gc = small['cuda'], small['cpu']
    dv = np.abs(g['ref']['best_vel'] - gc['ref']['best_vel'])
    dv_lim = float((dv / np.maximum(1.0, 0.5 * gc['ref']['vel_err'])).max())
    dp = float(np.nanmax(np.abs(g['params'] - gc['params']) / gc['errs']))
    log(f'8-fiber group fit under cand4, card vs CPU float64: max|dv| '
        f'{dv.max():.6f} km/s ({dv_lim:.6f} of max(1, sigma/2)); parameters '
        f'max|dp|/sigma {dp:.6f} (limit {SCHEME_SIGMA})')
    check(dv_lim <= 1 and dp <= SCHEME_SIGMA, 'the card\'s cand4 fit '
          'disagrees with the CPU float64 one')
    for run in runs:
        del run['out']
    return dict(runs=runs, cand4_vs_cpu=dict(max_dv=float(dv.max()),
                                             max_dv_lim=dv_lim, max_dp=dp))


def launches_of(counts, name):
    """A kernels-line entry's launches in one form's counts (kernel A's:
    both modes)."""
    if name == 'spline_eval':
        return counts['spline_eval_per_row'] + counts['spline_eval_shared']
    return counts[name]


def kernel_entries(form, a, a_grp, b, b_grp, b1, adj, adj_grp, counts,
                   per_group, single, weave_counts):
    """The kernels line's entries of one form: kernel A (shared mode's
    numbers as its main ones, the per-row mode's beside them), kernel B
    (continuum) and the adjoint, each with its launches in the driver's
    run of that form (overlaps on: totals per run only) and per path;
    ``per_group``: the launches of each group fit of phase 17's serial
    run (None: none in this form)."""
    group_n = COALESCE * NFIBERS
    suffix = '' if form == 'float64' else '_f32'
    calls = single.get('calls', [])

    def per_call(name, key='process_launches'):
        return [c[key][form][name] for c in calls]

    def launches(name):
        return dict(launches_single_object_phase=single['counts'][form][
                        name],
                    launches_weave_file=weave_counts[form][name],
                    **({} if per_group is None else dict(
                        launches_per_serial_driver_group=[
                            g[form][name] for g in per_group])))
    shared, row = a['shared'], a['per-row']
    g_shared, g_row = a_grp['shared'], a_grp['per-row']
    cont = b['continuum']
    b_grp, b_grp_nc = b_grp['continuum'], b_grp['no-continuum']
    b1, b1_nc = b1['continuum'], b1['no-continuum']
    return [
        dict(name='spline_eval' + suffix, route='cuda', form=form,
             source='rvspecfit_torch/csrc/spline_eval.cu',
             replaces='rvspecfit_tpu/ops/pallas_spline.py:200',
             launches=launches_of(counts, 'spline_eval'),
             launches_per_row_mode=counts['spline_eval_per_row'],
             launches_shared_mode=counts['spline_eval_shared'],
             **{f'{k}_per_row_mode': v for k, v in
                launches('spline_eval_per_row').items()},
             **{f'{k}_shared_mode': v for k, v in
                launches('spline_eval_shared').items()},
             launches_per_process_call_per_row_mode=per_call(
                 'spline_eval_per_row'),
             launches_per_process_call_shared_mode=per_call(
                 'spline_eval_shared'),
             max_abs_err=max(r['max_abs_err'] for r in
                             (*a.values(), *a_grp.values())),
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
        dict(name='ccf_chisq' + suffix, route='cuda', form=form,
             source='rvspecfit_torch/csrc/ccf_chisq.cu',
             replaces='rvspecfit_tpu/ops/pallas_ccf.py:159',
             launches=counts['ccf_chisq'], **launches('ccf_chisq'),
             launches_per_ccf_fit=per_call('ccf_chisq', 'ccf_launches'),
             max_abs_err=max(r['max_abs_err'] for r in (
                 *b.values(), b_grp, b_grp_nc, b1, b1_nc)),
             ms=cont['ms'], plain_ms=cont['plain_ms'],
             bound_ms=cont['bound_ms'], bound_by=cont['bound_by'],
             library_ms=cont['library_ms'],
             **{f'{k}_no_continuum': b['no-continuum'][k] for k in (
                 'max_abs_err', 'ms', 'plain_ms', 'bound_ms')},
             **{f'{k}_B{group_n}': b_grp[k] for k in (
                 'ms', 'plain_ms', 'bound_ms', 'library_ms')},
             **{f'{k}_no_continuum_B{group_n}': b_grp_nc[k] for k in (
                 'max_abs_err', 'ms', 'plain_ms', 'bound_ms')},
             **{f'{k}_B1': b1[k] for k in (
                 'max_abs_err', 'ms', 'eager_ms', 'plain_ms', 'bound_ms',
                 'bound_by', 'library_ms', 'library_eager_ms')},
             **{f'{k}_no_continuum_B1': b1_nc[k] for k in (
                 'max_abs_err', 'ms', 'plain_ms', 'bound_ms')}),
        dict(name='spline_eval_adjoint' + suffix, route='cuda', form=form,
             source='rvspecfit_torch/csrc/spline_eval.cu',
             replaces='rvspecfit_tpu/fit/batch.py:396',
             launches=counts['spline_eval_adjoint'],
             **launches('spline_eval_adjoint'),
             launches_per_process_call=per_call('spline_eval_adjoint'),
             max_abs_err=max(adj['max_abs_err'], adj_grp['max_abs_err']),
             ms=adj['ms'], plain_ms=adj['plain_ms'],
             bound_ms=adj['bound_ms'], bound_by='bytes', library_ms=None,
             ms_eager=adj['eager_ms'],
             **{f'{k}_B{group_n}': adj_grp[k] for k in (
                 'ms', 'plain_ms', 'bound_ms')}),
    ]


def group_fit_pass(tm, arms, truth, banks, form):
    """A cold and a timed warm pass of the group fit in ``form``, the
    warm pass's launches counted from 0: its output, wall, launches and
    peak device memory."""
    import torch
    t0 = time.perf_counter()
    run_group_fit(tm, arms, banks)
    log(f'group fit {form} cold pass: {time.perf_counter() - t0:.2f} s')
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_group_fit(tm, arms, banks)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f'group fit {form} warm pass: ' + ' '.join(
        f'{k}={out["phases"][k]:.3f}s' for k in PHASES)
        + f' total={wall:.3f}s -> {NFIBERS / wall:.1f} fibers/s; peak device '
        f'memory {peak:.2f} GB')
    log(f'NM ({form}): {int(out["nm"]["converged"].sum())}/{NFIBERS} '
        f'converged, {out["nm"]["obj_evals"]} objective trials; polish moved '
        f'{int((out["fun"] < out["nm"]["fun"]).sum())}/{NFIBERS}; '
        f'refinement passes {int(out["ref"]["iterations"][0])}; '
        f'BAD_HESSIAN {int(out["bad_hess"].sum())}/{NFIBERS}')
    log(f'kernel launches in the {form} warm pass: {counts}')
    check_launches(f'group fit ({form})', counts, form=form)
    check_outputs(out, NFIBERS, NPIX_ARM)
    dv = out['ref']['best_vel'] - truth['vel']
    ok = np.abs(dv) < np.maximum(10.0, 5 * out['ref']['vel_err'])
    log(f'RV recovery ({form}): {int(ok.sum())}/{NFIBERS} within max(10, 5 '
        f'sigma); median |dv| {np.median(np.abs(dv)):.3f} km/s, median '
        f'sigma_v {np.median(out["ref"]["vel_err"]):.3f} km/s')
    check(ok.sum() >= 0.98 * NFIBERS,
          f'RV recovery ({form}) {ok.sum()}/{NFIBERS}')
    return dict(wall=wall, phases=out['phases'], counts=counts,
                peak_gb=peak, recovered=int(ok.sum()))


T_START = time.perf_counter()


@contextlib.contextmanager
def phase(name):
    """Log the seconds a phase of main took, and the script's seconds at
    its end."""
    t0 = time.perf_counter()
    yield
    t1 = time.perf_counter()
    log(f'phase {name}: {t1 - t0:.1f} s (at {t1 - T_START:.1f} s)')


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
    with phase('kernels'):
        build_kernels()
        tm, arms, truth, bank = make_workload(device)
        check(tm.state.dats.dtype == torch.float64,
              'the card\'s working dtype is not float64')
        bank_d = convert.ccf_bank(*bank, device=device)
        banks = {a.name: bank_d for a in arms}
        both_b = {'continuum': bank_d,
                  'no-continuum': make_nocont_bank(device)}
        res_a = check_kernel_a(tm, arms, truth, device)
        res_a4 = check_kernel_a(tm, arms, truth, device,
                                cases=kernel_a_cand4_case,
                                forms=('float64',))['float64']
        res_adj = check_adjoint(tm, arms, truth, device)
        res_b = check_kernel_b(arms, both_b, device)

    with phase('group fit'):
        group = group_fit_pass(tm, arms, truth, banks, 'float64')
        tm32, bank32 = float32_models(device, bank)
        group32 = group_fit_pass(tm32, arms, truth,
                                 {a.name: bank32 for a in arms}, 'float32')
        log(f'group fit float64 / float32 warm pass: {group["wall"]:.3f} / '
            f'{group32["wall"]:.3f} s = '
            f'{group["wall"] / group32["wall"]:.3f}; by phase ' + ' '.join(
                f'{k}={group["phases"][k] / group32["phases"][k]:.3f}'
                for k in PHASES))
        tm_cpu, stats8 = check_against_cpu(arms, bank, device, tm, tm32,
                                           bank32)

    from rvspecfit_torch import simulation
    cpu = torch.device('cpu')
    bank_cpu = convert.ccf_bank(*bank, device=cpu)
    with tempfile.TemporaryDirectory() as workdir:
        with phase('DESI driver'):
            files, truths = driver_inputs(workdir)
            drv = run_driver(workdir, files, truths, tm, bank_d, 'float64')
            check_launches('driver path', drv['counts'])
            drv32 = run_driver(workdir, files, truths, tm32, bank32,
                               'float32')
            check_launches('driver path in float32', drv32['counts'],
                           form='float32')
            grp = drv['records'][-1]
            log(f'kernels at the shapes of a {grp["nfibers"]}-fiber driver '
                'group:')
            res_a_grp = check_kernel_a(tm, grp['arms'], drv['truth'], device)
            res_a4_grp = check_kernel_a(tm, grp['arms'], drv['truth'],
                                        device, cases=kernel_a_cand4_case,
                                        forms=('float64',))['float64']
            res_adj_grp = check_adjoint(tm, grp['arms'], drv['truth'],
                                        device)
            res_b_grp = check_kernel_b(grp['arms'], both_b, device)
            drv['records'] = drv32['records'] = grp = None
        with phase('DESI driver card vs CPU'):
            cmp_arms, _ = simulation.make_exposure(8, npix_arm=NPIX_ARM,
                                                   snr=50.0, seed=7)
            c8 = driver_against_cpu(workdir, 'coadd8', cmp_arms,
                                    {'cuda': tm, 'cpu': tm_cpu},
                                    {'cuda': bank_d, 'cpu': bank_cpu})
            res_data, bands, _ = resolution_exposure(NFIB_RES, seed=8)
            narrow = {key: make_template_model(d, wresol=RES_SIGMA0)
                      for key, d in (('cuda', device), ('cpu', cpu))}
            c64 = driver_against_cpu(
                workdir, f'coadd{NFIB_RES}res', res_data, narrow,
                {'cuda': bank_d, 'cpu': bank_cpu}, bands=bands,
                config=dict(CONFIG, lsf_sigma0_angstrom={
                    s: RES_SIGMA0 for s in SETUPS}))

        models = {'cuda': tm, 'cpu': tm_cpu, 'cuda32': tm32,
                  'narrow_cuda': narrow['cuda'], 'narrow_cpu': narrow['cpu']}
        bks = {'cuda': bank_d, 'cpu': bank_cpu, 'cuda32': bank32}
        with phase('single object'):
            single = run_single_object(models, bks)
            objs, _ = single_objects()
            res_b1 = kernel_b_single(objs[0][0], both_b)
        with phase('WEAVE'):
            wv = run_weave(workdir, models, bks)
        with phase('bruteforce'):
            bf = run_bruteforce(workdir, tm, bank_d)
        with phase('NN training'):
            data = training_set()
            train_model, train = run_training(device, data)
            train_cmp = training_against_cpu(device, data, train)
        # phase 20 here: it trains on phase 9's training set
        with phase('trainer grid'):
            train_mesh = run_train_mesh(device, data)
        with phase('NN cell'):
            nn_run = run_nn(workdir, device, train_model, data)
            del data, train_model
    with phase('pull harness'):
        pull = run_pull(device, tm, tm_cpu)
    with phase('library builder'), tempfile.TemporaryDirectory() as workdir:
        libb = run_library_builder(workdir, device)
    with phase('fleet'), tempfile.TemporaryDirectory() as workdir:
        fleet = run_fleet(workdir, tm, bank_d)
    with phase('microbatch'):
        mbatch = run_microbatch(tm, bank_d)
    with phase('fast_interp and prewarm'):
        fast = run_fast_interp(tm, tm_cpu)
        warm = run_prewarm(tm, bank_d)
    with phase('overlaps'), tempfile.TemporaryDirectory() as workdir:
        overlap = run_overlaps(workdir, tm, bank_d, models, bks)
    with phase('mesh'):
        mesh = run_mesh(tm, arms, truth, banks)
    with phase('NM schemes'):
        schemes = run_nm_schemes(tm, arms, truth, banks, tm_cpu, bank_cpu)
    with phase('overlap busy share'), \
            tempfile.TemporaryDirectory() as workdir:
        overlap.update(run_overlap_busy(workdir, tm, bank_d,
                                        overlap.pop('serial_tables')))
    log('card float64 vs CPU float64 (ROADMAP C.1, C.2): ' + json.dumps(dict(
        group_fit_8=stats8, coadd8=c8, coadd64res=c64,
        single_object=single['stats'], weave8=wv['stats'])))
    log(f'float64 / float32 seconds: group fit warm pass {group["wall"]:.3f} '
        f'/ {group32["wall"]:.3f}; driver steady s/file {drv["steady"]:.3f} '
        f'/ {drv32["steady"]:.3f}, cold group {drv["cold"]:.3f} / '
        f'{drv32["cold"]:.3f}; WEAVE file {wv["float64"]["wall"]:.3f} / '
        f'{wv["float32"]["wall"]:.3f}; single object ccf.fit -> process '
        f'(8) {single["cuda"]["seconds"]["fit"]:.3f} / '
        f'{single["cuda32"]["seconds"]["fit"]:.3f}; NN driver group '
        f'{nn_run["cold"]:.3f} s')
    log('NN training and pull harness: ' + json.dumps(dict(
        training={k: v for k, v in train.items() if k != 'counts'},
        training_vs_cpu=train_cmp,
        nn_cell=dict(cold_group_s=nn_run['cold'], wall_s=nn_run['wall'],
                     recovered=nn_run['recovered'],
                     bad_hessian_share=nn_run['bad_hessian_share']),
        pull=dict(pull['stats'], seconds=pull['wall'],
                  max_dv_sigma_cmp=pull['max_dv_sigma_cmp'],
                  cmp_trials=PULL_CMP_TRIALS),
        library_builder={k: v for k, v in libb.items()
                         if k not in ('counts', 'kernel_b')})))
    log('fleet, microbatch, fast_interp and prewarm: ' + json.dumps(dict(
        fleet={k: v for k, v in fleet.items()
               if k not in ('counts', 'counts_ranks')},
        microbatch=mbatch, fast_interp=fast,
        prewarm_seconds=warm['seconds'])))
    log('overlaps and mesh: ' + json.dumps(dict(
        overlaps={k: v for k, v in overlap.items()
                  if k not in ('counts', 'counts_serial', 'per_group')},
        mesh={k: v for k, v in mesh.items() if k != 'counts'})))
    log('NM schemes and the trainer\'s grid: ' + json.dumps(dict(
        nm_schemes=dict(schemes, runs=[
            {k: v for k, v in r.items() if k != 'counts'}
            for r in schemes['runs']]),
        trainer_grid=train_mesh)))

    check('jax' not in sys.modules and 'rvspecfit_tpu' not in sys.modules,
          'the run imported jax or the JAX package')
    kernels = []
    for form, drv_form in (('float64', drv), ('float32', drv32)):
        single_form = dict(single['cuda'], counts=single['counts']) \
            if form == 'float64' else dict(single['cuda32'],
                                           counts=single['counts32'])
        kernels += kernel_entries(
            form, res_a[form], res_a_grp[form], res_b[form],
            res_b_grp[form], res_b1[form], res_adj[form],
            res_adj_grp[form], drv_form['counts'][form],
            overlap['per_group'] if form == 'float64' else None,
            single_form, {f: wv[f]['counts'][f] for f in FORMS})
    for k in kernels:
        base, form = k['name'].removesuffix('_f32'), k['form']
        k['launches_group_fit_warm_pass'] = launches_of(
            (group if form == 'float64' else group32)['counts'][form], base)
        if form == 'float64':
            k['launches_desi_bruteforce'] = launches_of(
                bf['counts'][form], base)
            k['launches_nn_driver'] = launches_of(nn_run['counts'][form],
                                                  base)
            k['launches_nn_training'] = launches_of(
                train['counts'][form], base)
            k['launches_pull_harness'] = launches_of(pull['counts'][form],
                                                     base)
            k['launches_library_builder'] = launches_of(
                libb['counts'][form], base)
            k['launches_fleet_run1'] = launches_of(fleet['counts'][form],
                                                   base)
            k['launches_fleet_per_file'] = k['launches_fleet_run1'] \
                / FLEET_FILES
            k['launches_fleet_ranks'] = [launches_of(c[form], base)
                                         for c in fleet['counts_ranks']]
            k['launches_prewarm'] = launches_of(warm['counts'][form], base)
            k['launches_overlap_serial'] = launches_of(
                overlap['counts_serial'][form], base)
            k['launches_overlap'] = launches_of(overlap['counts'][form],
                                                base)
            k['launches_mesh'] = launches_of(mesh['counts'][form], base)
            k['launches_nm_schemes'] = [
                dict(scheme=r['scheme'],
                     launches=launches_of(r['counts'][form], base))
                for r in schemes['runs']]
            if base == 'spline_eval':
                k['launches_per_row_mode_in_nm'] = [
                    dict(scheme=r['scheme'],
                         launches=r['nm_per_row_launches'])
                    for r in schemes['runs']]
                for rows, res in ((4 * NFIBERS, res_a4),
                                  (4 * COALESCE * NFIBERS, res_a4_grp)):
                    r4 = res['per-row cand4']
                    k.update({f'{key}_per_row_mode_cand4_R{rows}': r4[key]
                              for key in ('max_abs_err', 'ms', 'eager_ms',
                                          'plain_ms', 'bound_ms')})
                    k['max_abs_err'] = max(k['max_abs_err'],
                                           r4['max_abs_err'])
            if base == 'ccf_chisq':
                shape = 'T{}_F{}'.format(*libb['bank_shape'])
                k.update({f'{key}_{shape}': libb['kernel_b'][key] for key in (
                    'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                    'library_ms')})
                k['max_abs_err'] = max(k['max_abs_err'],
                                       libb['kernel_b']['max_abs_err'])
    log(f'chip_smoke: {time.perf_counter() - T_START:.1f} s')
    print(smi)
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps(dict(ok=True, device=dict(
        platform='gpu', kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == '__main__':
    try:
        if sys.argv[1:2] == ['--fleet-rank']:
            sys.exit(fleet_rank(sys.argv[2:]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f'chip_smoke: FAILED: {exc}', file=sys.stderr)
        sys.exit(1)
