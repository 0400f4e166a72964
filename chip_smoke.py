#!/usr/bin/env python3
"""Drive the rvspecfit_torch fit slice on one CUDA card and check it.

Usage (from the root of a checkout, on a machine with one NVIDIA card
and the CUDA toolkit):

    python3 chip_smoke.py

1. Builds both CUDA kernels from rvspecfit_torch/csrc with nvcc
   (sm_90a) into rvspecfit_torch/_build/.
2. Compares each kernel with its plain PyTorch version on the card at
   the main path's shapes, and times both with CUDA events.
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
import json
import subprocess
import sys
import time

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


def cuda_time(fn, reps):
    """Mean ms per call of fn() on the card (after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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


def make_workload(device):
    from rvspecfit_torch import simulation
    from rvspecfit_torch.fit.batch import BatchArm
    t0 = time.perf_counter()
    tm = simulation.build_template_model(6, 6, 6, 4, npix=4096, lam0=4550.0,
                                         lam1=5450.0, device=device)
    arms_data, truth = simulation.make_exposure(NFIBERS, npix_arm=NPIX_ARM,
                                                snr=50.0, seed=7)
    bank = simulation.build_ccf_bank(6, 6, 6, 4, npix=4096, lam0=4550.0,
                                     lam1=5450.0, every=8)
    arms = [BatchArm(n, lam, fl, iv) for n, (lam, fl, iv) in arms_data.items()]
    log(f'workload: {NFIBERS} fibers x {len(arms)} arms x {NPIX_ARM} px, '
        f'{tm.state.dats.shape[0]} templates x {tm.geom.n} px, CCF bank '
        f'{bank[0].shape[0]} x {bank[0].shape[1]} frequencies '
        f'({time.perf_counter() - t0:.1f} s)')
    return tm, arms, truth, bank


def check_kernel_a(tm, arms, truth, device):
    """Kernel A vs plain on the card at the NM-step shape (one trial per
    fiber) and the refinement's full-pass shape (401 shared rows per
    fiber)."""
    import torch
    from rvspecfit_torch.fit.likelihood import doppler_u, template_stage
    from rvspecfit_torch.fit.spec_data import ArmState
    from rvspecfit_torch.ops import spline_eval
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
    result = {}
    for mode, u, rpc in (('per-row', u_row, 1), ('shared', u_shared, 401)):
        got = spline_eval.spline_eval_index(tm.geom, coeffs, u, rpc)
        want = spline_eval.spline_eval_index_plain(tm.geom, coeffs, u, rpc)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ms = cuda_time(lambda: spline_eval.spline_eval_index(
            tm.geom, coeffs, u, rpc), 20)
        plain_ms = cuda_time(lambda: spline_eval.spline_eval_index_plain(
            tm.geom, coeffs, u, rpc), 5)
        log(f'kernel A {mode}: rows {u.shape[0]} x {u.shape[1]} px, '
            f'coeffs {tuple(coeffs.shape)}: max|diff| {err:.3e} '
            f'(limit 1e-5 x max|out| = {1e-5 * scale:.3e}); '
            f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
        check(np.isfinite(err) and err <= 1e-5 * scale,
              f'kernel A ({mode}) disagrees with its plain version')
        result[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return result


def check_kernel_b(arms, bank_d, device):
    """Kernel B vs plain on a 64-fiber tile; times at the full exposure
    (500 fibers, one arm)."""
    import torch
    from rvspecfit_torch.fit import ccf
    from rvspecfit_torch.ops import ccf_chisq
    a = arms[0]
    p = ccf.prepare_arm_batch(a.name, a.lam, a.flux,
                              1.0 / np.sqrt(a.ivar), None, CONFIG, bank_d)
    args = [p['tfft'], p['t2fft'], p['sfft_conj'], p['ivfft_conj'],
            p['ecos'], p['esin']]
    tile = args[:2] + [x[:64] for x in args[2:4]] + args[4:]
    got = ccf_chisq.ccf_chisq(*tile, continuum=p['continuum'])
    want = ccf_chisq.ccf_chisq_plain(*tile, continuum=p['continuum'])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    ms = cuda_time(lambda: ccf_chisq.ccf_chisq(
        *args, continuum=p['continuum']), 10)
    plain_ms = cuda_time(lambda: ccf_chisq.ccf_chisq_plain(
        *args, continuum=p['continuum']), 3)
    shape = (args[2].shape[0], args[0].shape[0], args[0].shape[1],
             args[4].shape[1])
    log(f'kernel B: 64-fiber tile max|diff| {err:.3e}, relative to '
        f'max|out| {rel:.3e} (limit 1e-4); at B,T,F,V = {shape}: kernel '
        f'{ms:.3f} ms, plain {plain_ms:.3f} ms per arm')
    check(np.isfinite(rel) and rel <= 1e-4,
          'kernel B disagrees with its plain version')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def run_slice(bf, mapper, arms, banks, sync):
    """CCF -> Nelder-Mead -> refinement -> models; per-phase seconds."""
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
    x0 = np.concatenate([cres['best_vel'][:, None], cres['best_params']],
                        axis=1)
    nmres = bf.run_neldermead(mapper, x0=x0)
    mark()
    vel_b, params_b, _ = mapper.unpack_host(nmres['x'])
    ref = bf.refine_velocities(vel_b, params_b)
    mark()
    mods = bf.best_models(ref['best_vel'], params_b)
    mark()
    phases = dict(zip(('ccf', 'nm', 'refine', 'models'), np.diff(t)))
    return dict(ccf=cres, nm=nmres, ref=ref, models=mods, phases=phases)


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


def check_against_cpu(tm, arms, bank, device):
    """The slice on 8 fibers: CUDA float32 (kernels) against the CPU
    float64 run of the plain versions."""
    import torch
    from rvspecfit_torch import convert, simulation
    from rvspecfit_torch.fit.batch import BatchArm
    cpu = torch.device('cpu')
    sub = [BatchArm(a.name, a.lam, a.flux[:8], a.ivar[:8]) for a in arms]
    tm_cpu = simulation.build_template_model(6, 6, 6, 4, npix=4096,
                                             lam0=4550.0, lam1=5450.0)
    small = {}
    for dev, tm_d in ((device, tm), (cpu, tm_cpu)):
        banks_d = {a.name: convert.ccf_bank(*bank, device=dev) for a in sub}
        bf_d, mapper_d = make_fitter(tm_d, sub)
        small[dev.type] = run_slice(bf_d, mapper_d, sub, banks_d,
                                    torch.cuda.synchronize)
    vg, vc = small['cuda']['ref']['best_vel'], small['cpu']['ref']['best_vel']
    lim = np.maximum(1.0, 0.5 * small['cpu']['ref']['vel_err'])
    same_id = (small['cuda']['ccf']['best_id']
               == small['cpu']['ccf']['best_id']).sum()
    log(f'8-fiber slice, CUDA float32 vs CPU float64: max|dv| '
        f'{np.abs(vg - vc).max():.4f} km/s (limit max(1, 0.5 sigma)); '
        f'same CCF template {int(same_id)}/8')
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
    res_b = check_kernel_b(arms, banks[arms[0].name], device)

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
    kernels = [
        dict(name='spline_eval', route='cuda',
             source='rvspecfit_torch/csrc/spline_eval.cu',
             replaces='rvspecfit_tpu/ops/pallas_spline.py:200',
             launches=counts['spline_eval'],
             max_abs_err=max(r['max_abs_err'] for r in res_a.values()),
             ms=res_a['shared']['ms'], plain_ms=res_a['shared']['plain_ms'],
             ms_per_row_mode=res_a['per-row']['ms'],
             plain_ms_per_row_mode=res_a['per-row']['plain_ms']),
        dict(name='ccf_chisq', route='cuda',
             source='rvspecfit_torch/csrc/ccf_chisq.cu',
             replaces='rvspecfit_tpu/ops/pallas_ccf.py:159',
             launches=counts['ccf_chisq'], **res_b),
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
