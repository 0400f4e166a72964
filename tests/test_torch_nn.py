"""Parity of the port's NN template interpolator (interp/nn.py,
interp/mapper.py, the NN branch of pipeline/library.py, convert.nn_state)
with the JAX reference (float64, CPU), through a library the port's
trainer made."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.interpolate
import torch

from rvspecfit_tpu import serializer as rserializer
from rvspecfit_tpu.fit import batch as rbatch
from rvspecfit_tpu.fit import ccf as rccf
from rvspecfit_tpu.fit import likelihood as rlik
from rvspecfit_tpu.fit import vel_fit as rvf
from rvspecfit_tpu.interp import mapper as rmapper
from rvspecfit_tpu.interp import nn as rnn
from rvspecfit_tpu.interp.api import TemplateModel as RTemplateModel
from rvspecfit_tpu.ops.spline import SplineGeometry as RSplineGeometry
from rvspecfit_tpu.pipeline import library as rlib
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert, simulation
from rvspecfit_torch.fit import batch, ccf, likelihood, vel_fit
from rvspecfit_torch.interp import mapper, nn
from rvspecfit_torch.pipeline import library, train_nn

# float64 on both sides: the same formulas in another library's
# operation order
RTOL = 1e-12
ACTIVATIONS = ('SiLU', 'GELU', 'Tanh', 'ReLU')
CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2)
START = dict(teff=6000.0, logg=3.0, feh=-1.0, alpha=0.5)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _ref_state(nonlinearity='SiLU', withbn=False, seed=0, npix=30):
    """A reference NNState with random (non-zero) biases and batch-norm
    affines, standardization and hull equations of random training
    points: (state, training points)."""
    rng = np.random.RandomState(seed + 1)
    vecs = rng.uniform(-1, 1, size=(50, 4))
    st = rnn.init_state(jax.random.PRNGKey(seed), ndim=4, width=16,
                        nlayers=2, npc=5, npix=npix,
                        mean=vecs.mean(0), std=vecs.std(0),
                        hull_eqs=rnn.hull_equations(vecs), withbn=withbn,
                        nonlinearity=nonlinearity)
    weights = tuple((w, jnp.asarray(rng.normal(size=b.shape) * 0.3))
                    for w, b in st.weights)
    bn = tuple(None if x is None else
               (jnp.asarray(1.0 + 0.2 * rng.normal(size=x[0].shape)),
                jnp.asarray(0.1 * rng.normal(size=x[1].shape)))
               for x in st.bn)
    return dataclasses.replace(
        st, weights=weights, bn=bn,
        pc_b=jnp.asarray(rng.normal(size=st.pc_b.shape))), vecs


def _inputs(vecs, seed=2):
    """Points inside the training hull (convex combinations) and far
    outside it."""
    rng = np.random.RandomState(seed)
    w = rng.dirichlet(np.ones(len(vecs)), size=6)
    far = rng.normal(size=(4, 4)) * 5.0
    return np.concatenate([w @ vecs, far])


@pytest.mark.parametrize('withbn', [False, True])
@pytest.mark.parametrize('nonlinearity', ACTIVATIONS)
def test_forward_and_interp_batch_match_reference(nonlinearity, withbn):
    ref, vecs = _ref_state(nonlinearity, withbn)
    model = convert.nn_state(ref, device='cpu')
    assert model.bn_layers == ((1, 2) if withbn else ())
    x = _inputs(vecs)
    np.testing.assert_allclose(model(_t(x)).numpy(),
                               np.asarray(rnn.forward(ref, jnp.asarray(x))),
                               rtol=RTOL, atol=RTOL)
    spec, out = model.interp_batch(_t(x))
    rspec, rout = rnn.interp_batch(ref, jnp.asarray(x))
    np.testing.assert_allclose(spec.numpy(), np.asarray(rspec), rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=RTOL,
                               atol=1e-20)


def test_hull_outside_inside_and_outside():
    ref, vecs = _ref_state()
    model = convert.nn_state(ref, device='cpu')
    for a, b in zip(nn.hull_equations(vecs), rnn.hull_equations(vecs)):
        np.testing.assert_array_equal(a, b)
    x = _inputs(vecs)
    got = model.hull_outside(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(rnn.hull_outside(
        ref, jnp.asarray(x))), rtol=RTOL, atol=1e-20)
    # hull vertices and convex combinations lie on or inside the facets
    assert (got[:6] < 1e-20).all() and (got[6:] > 0).all()
    assert (model.hull_outside(_t(vecs)).numpy() < 1e-20).all()


def test_gradients_match_reference():
    """d spectrum / d params and d outside / d params through the clamps
    and the GELU (tanh form), against jax's."""
    ref, vecs = _ref_state('GELU', withbn=True)
    model = convert.nn_state(ref, device='cpu')
    x = _inputs(vecs)
    g = np.random.RandomState(3).normal(size=(len(x), model.npix))

    def rfun(p):
        spec, out = rnn.interp_batch(ref, p)
        return (spec * g).sum() + out.sum()
    want = np.asarray(jax.grad(rfun)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    spec, out = model.interp_batch(xt)
    got, = torch.autograd.grad((spec * _t(g)).sum() + out.sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize('log_ids', [(0,), (0, 2), ()])
def test_log_mapper_both_ways(log_ids):
    rng = np.random.RandomState(4)
    x = np.column_stack([rng.uniform(4000, 9000, 5), rng.uniform(1, 5, 5),
                         rng.uniform(0.1, 2.0, 5), rng.uniform(0, 1, 5)])
    m, rm = mapper.LogMapper(log_ids), rmapper.LogMapper(log_ids)
    fwd = rm.forward(x)
    np.testing.assert_allclose(m.forward(x), fwd, rtol=RTOL)
    np.testing.assert_allclose(m.forward(_t(x)).numpy(), fwd, rtol=RTOL)
    np.testing.assert_allclose(m.inverse(fwd), rm.inverse(fwd), rtol=RTOL)
    np.testing.assert_allclose(m.inverse(_t(fwd)).numpy(), x, rtol=RTOL)
    assert m.spec() == rm.spec()
    assert mapper.mapper_from_spec(rm.spec()).log_ids == m.log_ids
    assert mapper.mapper_from_spec(None).log_ids == ()
    with pytest.raises(ValueError):
        mapper.mapper_from_spec(dict(mapper_class='Other'))


def test_checkpoint_round_trip_in_the_reference_format():
    ref, vecs = _ref_state('Tanh', withbn=True)
    model = convert.nn_state(ref, device='cpu')
    d, rd = nn.state_to_dict(model), rnn.state_to_dict(ref)
    assert set(d) == set(rd)
    for k, v in rd.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(d[k], v)
        else:
            assert d[k] == v, k
    back = nn.state_from_dict(d, device='cpu')
    x = _t(_inputs(vecs))
    torch.testing.assert_close(back(x), model(x), rtol=0, atol=0)
    for key, bad in (('checkpoint_magic', 'nope'), ('checkpoint_version', 9),
                     ('nn_arch_version', 9)):
        with pytest.raises(RuntimeError):
            nn.state_from_dict(dict(d, **{key: bad}), device='cpu')


def test_init_state_is_seeded():
    make = lambda seed: nn.init_state(torch.Generator().manual_seed(seed),
                                      4, 16, 2, 5, 30, withbn=True,
                                      device='cpu')
    a, b, c = make(1), make(1), make(2)
    x = _t(np.random.RandomState(5).normal(size=(3, 4)))
    torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    assert not torch.equal(a(x), c(x))
    assert [lin.weight.shape for lin in a.layers] == [(16, 4), (16, 16),
                                                     (16, 16), (5, 16)]
    assert a.output.weight.shape == (30, 5) and a.bn_layers == (1, 2)
    # no hull: everything inside
    assert (a.hull_outside(x * 100) == 0).all()


def _write_nn_library(path, setup, fd, payload):
    """An NN library as the reference's trainer writes it: the
    checkpoint under ``state`` and the descriptor with its nn_file."""
    nn_file = f'nnstate_{setup}.h5'
    rserializer.save_dict_to_hdf5(os.path.join(path, nn_file),
                                  dict(state=payload, revision='r1'))
    rserializer.save_dict_to_hdf5(
        os.path.join(path, f'interp_{setup}.h5'),
        dict(fd, nn_file=nn_file, mapper_class='LogMapper', revision='r1'))


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    """A library written through the reference's state_to_dict and
    serializer loads through the port's library branch, and the model
    evaluates as the reference's own loader's does."""
    ref, vecs = _ref_state('SiLU', withbn=True, npix=64)
    lam = np.exp(np.linspace(np.log(4600.0), np.log(5400.0), 64))
    fd = dict(interpolation_type='nn', lam=lam, log_step=True,
              log_spec=True, log_ids=[0], parnames=['teff', 'logg', 'feh',
                                                    'alpha'])
    _write_nn_library(str(tmp_path), 'nnb', fd, rnn.state_to_dict(ref))
    cfg = dict(template_lib=str(tmp_path))
    got = library.load_template_model('nnb', cfg, device='cpu')
    want = rlib.load_template_model('nnb', cfg, cache=False)
    assert got.kind == want.kind == 'nn'
    assert got.parnames == want.parnames and got.log_ids == (0,)
    assert got.extra['revision'] == 'r1'
    p = vecs[:8].copy()
    p[:, 0] = 10**p[:, 0]             # mapped log10(teff) -> teff
    spec, out = got.eval_batch(_t(p))
    rspec, rout = want.eval_batch(jnp.asarray(p))
    np.testing.assert_allclose(spec.numpy(), np.asarray(rspec), rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=RTOL,
                               atol=1e-20)
    # 'generic' is the NN branch too
    fd2, data = library.read_template_artifacts('nnb', cfg)
    assert library.template_model_from_artifacts(
        dict(fd2, interpolation_type='generic'), data,
        device='cpu').kind == 'nn'


@pytest.fixture(scope='module')
def nn_library():
    """An NN library of a small synthetic grid trained by the port's
    trainer on the CPU: (fd, payload, the port's model, the reference's
    model from the same payload)."""
    lam, _, _, vecs, specs, parnames = simulation.make_template_grid(
        3, 3, 3, 2, npix=512)
    model, hist = train_nn.train_interpolator(
        vecs.T, specs, width=32, nlayers=2, npc=8, lr0=3e-3, num_epochs=150,
        batch_size=64, seed=3, device='cpu')
    assert hist['loss'][-1] < 0.3 * hist['loss'][0]
    payload = nn.state_to_dict(model)
    fd = train_nn.library_descriptor(lam, parnames, True, True, [0],
                                     np.zeros(len(specs)), 32, 2, 8)
    tm = library.template_model_from_artifacts(fd, payload, device='cpu')
    rtm = RTemplateModel(kind='nn', state=rnn.state_from_dict(payload),
                         geom=RSplineGeometry.from_knots(fd['lam'], True),
                         parnames=tuple(fd['parnames']), log_ids=(0,))
    return fd, payload, tm, rtm


def test_model_exposure_and_bank(nn_library):
    """Spectra drawn from the model itself: at zero noise the rest-frame
    spectrum's spline shifted by the velocity; the bank is make_ccf's of
    the model at the grid's nodes."""
    _, _, tm, _ = nn_library
    arms, truth = simulation.model_exposure(tm, 3, npix_arm=100, snr=1e12,
                                            seed=4)
    assert set(arms) == set(simulation.THREE_ARM_LAYOUT)
    lam, flux, ivar = arms['B']
    assert flux.shape == ivar.shape == (3, 100) and np.isfinite(flux).all()
    params = np.column_stack([truth[k] for k in ('teff', 'logg', 'feh',
                                                 'alpha')])
    rest = tm.eval_batch(_t(params))[0].numpy()
    i = 1
    want = scipy.interpolate.CubicSpline(tm.geom.xs.numpy(), rest[i],
                                         bc_type='natural')(
        lam / (1 + truth['vel'][i] / 299792.458))
    np.testing.assert_allclose(flux[i], want, rtol=1e-9)
    tfft, t2fft, info = simulation.model_ccf_bank(tm, 3, 3, 3, 2, every=2,
                                                  step=1.0, device='cpu')
    assert tfft.shape == t2fft.shape and tfft.shape[0] == len(
        info['params']) == 27
    assert np.isfinite(tfft).all()


def test_trial_chisq_through_nn_matches_reference(nn_library):
    """chisq_trials_core through an NN TemplateModel against the
    reference's likelihood, with trials outside the hull (penalty) and
    with rotation."""
    _, _, tm, rtm = nn_library
    arms_data, truth = simulation.model_exposure(tm, 2, npix_arm=120,
                                                 seed=5)
    from rvspecfit_tpu.fit.spec_data import ArmState as RArmState
    from rvspecfit_tpu.fit.spec_data import SpecData as RSpecData
    rarms = [RArmState.build(RSpecData(n, lam, fl[0], 1 / np.sqrt(iv[0])),
                             npoly=6, geom=rtm.geom)
             for n, (lam, fl, iv) in arms_data.items()]
    rng = np.random.RandomState(6)
    n = 10
    params = np.column_stack([rng.uniform(4500, 9500, n),
                              rng.uniform(0.8, 4.8, n),
                              rng.uniform(-1.9, -0.1, n),
                              rng.uniform(0.05, 0.95, n)])
    params[2, 0] = 15000.0            # outside the hull: penalty
    params[3, 1] = -3.0
    vels = rng.uniform(-400, 400, n)
    vsinis = rng.uniform(0.0, 80.0, n)
    badchi = float(10 * sum(a.npix for a in rarms))
    for use_vsini in (False, True):
        hw = {a.name: _half_width(rtm) if use_vsini else None
              for a in rarms}
        ref = np.asarray(rlik.chisq_trials_core(
            rarms, {a.name: rtm for a in rarms}, jnp.asarray(vels),
            jnp.asarray(params), jnp.asarray(vsinis), badchi=badchi,
            use_vsini=use_vsini, half_widths=hw, outside_penalty=True,
            solve_dtype=None))
        got = likelihood.chisq_trials_core(
            [convert.arm_state(a, device='cpu') for a in rarms],
            {a.name: tm for a in rarms}, _t(vels)[None], _t(params)[None],
            _t(vsinis)[None], badchi=badchi, use_vsini=use_vsini,
            half_widths=hw)
        np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-9)


def _half_width(rtm):
    from rvspecfit_tpu.ops import vsini as rvsini
    return rvsini.kernel_half_width(300.0, rtm.log_step)


def _nn_slice(side, tm, rtm, arms_data, bank):
    """CCF -> NM -> refinement -> models through the NN model on one
    side ('ref' or 'port')."""
    cfg = dict(CONFIG, second_minimizer=False, template_lib='')
    batches = [(n, lam, fl, 1.0 / np.sqrt(iv), None)
               for n, (lam, fl, iv) in arms_data.items()]
    if side == 'ref':
        c = rccf.fit_batch(batches, freeze(cfg),
                           banks={n: bank for n in arms_data})
        bf = rbatch.BatchedFitter(
            [rbatch.BatchArm(n, *a) for n, a in arms_data.items()],
            {n: rtm for n in arms_data}, freeze(cfg), options={'npoly': 6})
        mapper_ = rvf.ParamMapper(rtm.parnames, START, [], None, False)
    else:
        c = ccf.fit_batch(batches, cfg,
                          {n: convert.ccf_bank(*bank, device='cpu')
                           for n in arms_data})
        bf = batch.BatchedFitter(
            [batch.BatchArm(n, *a) for n, a in arms_data.items()],
            {n: tm for n in arms_data}, cfg, options={'npoly': 6})
        mapper_ = vel_fit.ParamMapper(tm.parnames, START, [], None, False)
    x0 = np.concatenate([c['best_vel'][:, None], c['best_params']], 1)
    nmres = bf.run_neldermead(mapper_, c['best_vel'], x0=x0)
    vel, params, _ = mapper_.unpack_host(nmres['x'])
    ref = bf.refine_velocities(vel, params)
    mods = bf.best_models(ref['best_vel'], params)
    return dict(ccf=c, nm=nmres, ref=ref, models=mods)


def test_group_fit_through_nn_matches_reference(nn_library, monkeypatch):
    """The batched fit (CCF -> Nelder-Mead -> refinement -> models)
    through the NN model against the reference's BatchedFitter on 4
    fibers drawn from the model: same CCF picks, NM values within rtol
    1e-6, velocities within 1e-3 km/s, models within rtol 1e-8 (as
    test_torch_fit's grid slice)."""
    _, _, tm, rtm = nn_library
    arms_data, truth = simulation.model_exposure(tm, 4, npix_arm=160,
                                                 seed=6)
    bank = simulation.model_ccf_bank(tm, 3, 3, 3, 2, every=2, step=2.0,
                                     device='cpu')
    for var in ('RVST_PALLAS_SPLINE', 'RVST_PALLAS_CCF'):
        monkeypatch.delenv(var, raising=False)
    r = _nn_slice('ref', tm, rtm, arms_data, bank)
    p = _nn_slice('port', tm, rtm, arms_data, bank)
    np.testing.assert_array_equal(p['ccf']['best_id'], r['ccf']['best_id'])
    np.testing.assert_allclose(p['ccf']['best_vel'], r['ccf']['best_vel'],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(p['nm']['fun'], r['nm']['fun'], rtol=1e-6)
    np.testing.assert_allclose(p['ref']['best_vel'], r['ref']['best_vel'],
                               rtol=0, atol=1e-3)
    for arm, want in r['models']['models'].items():
        np.testing.assert_allclose(p['models']['models'][arm], want,
                                   rtol=1e-8)
    dv = p['ref']['best_vel'] - truth['vel']
    assert (np.abs(dv) < np.maximum(10.0, 5 * p['ref']['vel_err'])).all()


def test_group_fit_through_nn_recovers_velocities(nn_library):
    """The port's whole group fit (desi._run_group_fit: CCF, NM, polish,
    refinement, Hessian errors, models) through the NN model on fibers
    drawn from it: velocities recovered, errors finite on good
    Hessians, the polish never raises the objective."""
    from rvspecfit_torch.survey import desi
    _, _, tm, _ = nn_library
    arms_data, truth = simulation.model_exposure(tm, 3, npix_arm=160,
                                                 seed=7)
    bank = convert.ccf_bank(*simulation.model_ccf_bank(
        tm, 3, 3, 3, 2, every=2, step=2.0, device='cpu'), device='cpu')
    arms = [batch.BatchArm(n, *a) for n, a in arms_data.items()]
    out = desi._run_group_fit(arms, {a.name: tm for a in arms},
                              dict(CONFIG, second_minimizer=True),
                              {'npoly': 6}, banks={a.name: bank
                                                   for a in arms})
    dv = out['ref']['best_vel'] - truth['vel']
    assert (np.abs(dv) < np.maximum(10.0, 5 * out['ref']['vel_err'])).all()
    assert (out['fun'] <= out['nm']['fun']).all()
    assert np.isfinite(out['errs'][~out['bad_hess']]).all()
