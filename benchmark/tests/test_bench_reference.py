"""The plain reference against the program at a toy size on the CPU:
-2 log L, the true chi-square and the best-fit models at random points,
with and without rotation, in float64."""
import numpy as np
import torch

from benchlib import generator, program, reference
from conftest import TOY_NODES


class _Ctx:
    device = torch.device('cpu')


def _config():
    return dict(
        templates=dict(setups={'s': dict(lam0=5000.0, lam1=5300.0,
                                         fwhm=1.55)},
                       step=0.4, nodes=TOY_NODES),
        generator=dict(seed=3, lines_per_100A=30, strong_lines=[]))


def test_reference_matches_the_program_likelihood_and_models():
    from rvspecfit_torch.fit.likelihood import FusedChisq
    from rvspecfit_torch.fit.spec_data import SpecData
    cfg = _config()
    models, grids, _ = program.template_models(_Ctx, cfg)
    arm = dict(setup='s', lam0=5050.0, lam1=5250.0, step=0.8)
    rng = np.random.default_rng(5)
    truth = generator.draw_truths(dict(
        params=dict(teff=[4000, 8000], logg=[1, 4.5], feh=[-2, 0],
                    alpha=[0, 0.8]), vel=[-300, 300], snr=[20, 80],
        rotating_share=0.5, vsini=[20, 150]), 4, rng)
    flux, ivar = generator.observe(cfg, 's', arm, truth,
                                   generator.device_generator(1, 'cpu'),
                                   'cpu')
    lam = generator.arm_lam(arm)
    sig = 1 / np.sqrt(ivar.astype(np.float64))
    fit_cfg = dict(min_vel=-1000, max_vel=1000, max_vsini=500)
    ref_arm = reference.Arm(lam, flux, sig, np.ones(flux.shape, bool),
                            grids['s'], 7, 'cpu')
    params = np.stack([truth[p] for p in generator.PARNAMES], 1) * [
        1.01, 1, 1, 1] + [0, 0.1, 0.05, -0.05]
    for use_vsini in (False, True):
        vs = truth['vsini'] + 1.0 if use_vsini else np.zeros(4)
        m2ll, chi2, mods = reference.evaluate(
            [ref_arm], np.arange(4), truth['vel'] + 2.0, params, vs,
            use_vsini)
        for i in range(4):
            fused = FusedChisq([SpecData('s', lam, flux[i].astype(float),
                                         sig[i])], models, fit_cfg,
                               options={'npoly': 7}, use_vsini=use_vsini)
            out = fused.full_output(truth['vel'][i] + 2.0, params[i],
                                    vs[i] if use_vsini else None)
            assert abs(out['chisq'] - float(m2ll[i])) < 1e-9 * abs(
                out['chisq'])
            assert abs(out['chisq_array'][0] - float(chi2[i])) < 1e-9 * \
                float(chi2[i])
            want = mods[0][i].numpy()
            assert np.abs(out['models'][0] - want).max() < 1e-9 * np.abs(
                want).max()


def test_rotation_kernel_is_normalized_and_symmetric():
    for vs in (0.05, 3.0, 150.0):
        k = reference.rotation_kernel(vs, 8.5e-5)
        assert abs(k.sum() - 1) < 1e-14
        assert np.allclose(k, k[::-1], rtol=0, atol=1e-15)


def test_reference_ccf_matches_the_program_ccf():
    """The program's batched CCF (kernel B's plain form on the CPU)
    against the reference CCF at the template it chose: the same
    velocity and chi-square to round-off."""
    from benchlib import reference_ccf
    from rvspecfit_torch.fit import ccf
    cfg = _config()
    cfg['ccf'] = dict(every=4, vsinis=[0.0, 300.0])
    models, grids, raw = program.template_models(_Ctx, cfg)
    banks = program.ccf_banks(_Ctx, cfg, raw)
    arm = dict(setup='s', lam0=5050.0, lam1=5250.0, step=0.8)
    truth = generator.draw_truths(dict(
        params=dict(teff=[4000, 8000], logg=[1, 4.5], feh=[-2, 0],
                    alpha=[0, 0.8]), vel=[-300, 300], snr=[10, 80],
        rotating_share=0.5, vsini=[20, 150]), 6, np.random.default_rng(7))
    flux, ivar = generator.observe(cfg, 's', arm, truth,
                                   generator.device_generator(2, 'cpu'),
                                   'cpu')
    lam = generator.arm_lam(arm)
    err = 1 / np.sqrt(ivar.astype(np.float64))
    flux = flux.astype(np.float64)
    fit = dict(max_vel=1000.0, vel_step0=5.0)
    got = ccf.fit_batch([('s', lam, flux, err, np.zeros(flux.shape, bool))],
                        fit, banks={'s': banks['s']}, device='cpu')
    carm = reference_ccf.CcfArm(lam, flux, err, np.zeros(flux.shape, bool),
                                grids['s'], cfg['templates']['setups']['s'],
                                cfg['templates']['step'], 'cpu')
    vel, chi, sse = reference_ccf.ccf_answer(
        [carm], got['best_params'], np.nan_to_num(got['best_vsini']),
        fit['max_vel'], fit['vel_step0'])
    gap = np.abs(vel - got['best_vel'])
    assert gap.max() < 1e-6, gap
    assert np.all(np.abs(chi - got['best_chi']) / sse < 1e-9)


def test_reference_errors_match_the_program_hessian():
    """The reference's central-difference Hessian errors against the
    program's exact (AD) ones, at points inside a grid cell."""
    from rvspecfit_torch.fit.batch import BatchArm, BatchedFitter
    cfg = _config()
    models, grids, _ = program.template_models(_Ctx, cfg)
    arm = dict(setup='s', lam0=5050.0, lam1=5250.0, step=0.8)
    truth = generator.draw_truths(dict(
        params=dict(teff=[4200, 6800], logg=[2.2, 3.8], feh=[-1.8, -0.7],
                    alpha=[0.1, 0.4]), vel=[-300, 300], snr=[20, 80],
        rotating_share=0.0, vsini=[0, 0]), 4, np.random.default_rng(9))
    flux, ivar = generator.observe(cfg, 's', arm, truth,
                                   generator.device_generator(3, 'cpu'),
                                   'cpu')
    lam = generator.arm_lam(arm)
    params = np.stack([truth[p] for p in generator.PARNAMES], 1)
    fitter = BatchedFitter([BatchArm('s', lam, flux, ivar)], models,
                           dict(min_vel=-1000, max_vel=1000, max_vsini=500,
                                min_vel_step=0.2, vel_step0=5),
                           options={'npoly': 7}, use_vsini=False)
    errs = fitter.hessian_errors(truth['vel'], params,
                                 parnames=list(generator.PARNAMES))[0]
    ref_arm = reference.Arm(lam, flux, 1 / np.sqrt(ivar.astype(float)),
                            np.ones(flux.shape, bool), grids['s'], 7, 'cpu')
    steps = np.abs(params) * 1e-4
    hes = reference.param_hessian([ref_arm], np.arange(4), truth['vel'],
                                  params, np.zeros(4), False, steps)
    with np.errstate(invalid='ignore'):
        ref = np.sqrt(np.array([np.diag(np.linalg.inv(h)) for h in hes]))
    # at the truths (not an optimum) a Hessian may not be positive
    # definite: the program flags those, and they are not compared
    ok = np.all(np.isfinite(ref), 1)
    assert ok.sum() >= 3
    assert np.all(np.abs(errs - ref)[ok] / ref[ok] < 1e-4), (errs, ref)
