"""Parity of the port's CCF first guess — kernel B's plain version,
preprocessing, bank building and fit_batch — with the JAX reference
(float64, CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.fit import ccf as rccf
from rvspecfit_tpu.ops import continuum as rcont
from rvspecfit_tpu.ops import pallas_ccf
from rvspecfit_tpu.pipeline import make_ccf as rmake_ccf
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert, simulation, trace
from rvspecfit_torch.fit import ccf
from rvspecfit_torch.ops import ccf_chisq, continuum
from rvspecfit_torch.pipeline import make_ccf

CONFIG = dict(min_vel=-600, max_vel=600, vel_step0=40)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _bank_arm(rng, t=11, b=5, npoints=256, nvel=37):
    """Complex bank/exposure rFFTs of real series + DFT matrices."""
    tm = rng.normal(size=(t, npoints))
    tfft = np.fft.rfft(tm, axis=1)
    t2fft = np.fft.rfft(tm**2, axis=1)
    sfft = np.conj(np.fft.rfft(rng.normal(size=(b, npoints)), axis=1))
    ivfft = np.conj(np.fft.rfft(rng.uniform(0.5, 2.0, (b, npoints)),
                                axis=1))
    ecos, esin = rccf._dft_mats_cached(
        npoints, 0.0, npoints * 1e-4, tuple(np.linspace(-400, 400, nvel)),
        'float64')
    return tfft, t2fft, sfft, ivfft, np.asarray(ecos), np.asarray(esin)


@pytest.mark.parametrize('continuum_mode', [True, False])
def test_plain_kernel_b_matches_pallas(continuum_mode):
    rng = np.random.RandomState(7)
    tfft, t2fft, sfft, ivfft, ecos, esin = _bank_arm(rng)
    pack = lambda c: jnp.asarray(np.stack([c.real, c.imag]))
    want = np.asarray(pallas_ccf.ccf_chisq_pallas(
        pack(tfft), pack(t2fft), pack(sfft), pack(ivfft),
        jnp.asarray(ecos), jnp.asarray(esin), continuum=continuum_mode,
        interpret=True))
    c = lambda a: _t(a, torch.complex128)
    got = ccf_chisq.ccf_chisq_plain(c(tfft), c(t2fft), c(sfft), c(ivfft),
                                    _t(ecos), _t(esin),
                                    continuum=continuum_mode)
    assert got.shape == want.shape == (5, 11, 37)
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


def test_plain_kernel_b_fiber_tiles(monkeypatch):
    """The plain version's fiber tiling does not change the result."""
    rng = np.random.RandomState(8)
    args = _bank_arm(rng, b=7)
    c = lambda a: _t(a, torch.complex128)
    ins = [c(x) for x in args[:4]] + [_t(x) for x in args[4:]]
    whole = ccf_chisq.ccf_chisq(*ins)
    monkeypatch.setattr(ccf_chisq, '_PLAIN_TILE_ELEMS', 2 * 11 * 129)
    np.testing.assert_allclose(ccf_chisq.ccf_chisq(*ins), whole,
                               rtol=1e-14)
    assert not trace.counters('kernel_b.')


def test_dft_mats_vel_axis_and_reduce():
    conf = dict(npoints=512, logl0=np.log(4600.0), logl1=np.log(5400.0))
    vel_grid = np.linspace(-500, 500, 41)
    ref = rccf._dft_mats_cached(512, conf['logl0'], conf['logl1'],
                                tuple(vel_grid), 'float64')
    got = ccf.dft_mats(conf, vel_grid, 'cpu', torch.float64)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    for a, b in zip(ccf.vel_axis(conf, 512, 600.0),
                    rccf._vel_axis(conf, 512, 600.0)):
        np.testing.assert_array_equal(a, b)
    chis = np.random.RandomState(9).randn(6, 5, 41).cumsum(-1)
    chis[0, 2, 0] = -100.0           # minimum on the grid edge
    ref = rccf._ccf_reduce(jnp.asarray(chis), jnp.asarray(vel_grid))
    got = ccf.ccf_reduce(_t(chis), _t(vel_grid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12)


def test_masked_median_drops_infinities():
    """±inf are dropped like masked pixels (the reference's rule)."""
    x = np.array([[1.0, np.inf, 3.0, -np.inf, 2.0, 7.0],
                  [np.nan, 4.0, 1.0, 2.0, 9.0, 5.0],
                  [np.inf, -np.inf, np.nan, 1.0, 1.0, 1.0],
                  [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]])
    good = np.ones(x.shape, bool)
    good[1, 4] = False
    good[2, 3:] = False
    got = continuum.masked_median(_t(x), torch.as_tensor(good))
    want = rcont.masked_median(x, good)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:2], [2.5, 3.0])
    assert torch.isnan(got[2])


@pytest.mark.parametrize('with_continuum', [True, False])
def test_preprocess_fft_batch_matches_reference(with_continuum):
    arms, _ = rsim.make_exposure(4, npix_arm=200, seed=2)
    lam, flux, ivar = arms['R']
    flux = flux.copy()
    badmask = np.zeros(flux.shape, bool)
    badmask[1, 20:30] = True
    badmask[2, :8] = True
    flux[3, 50] = -5.0
    conf = make_ccf.get_ccf_config(np.log(4900.0), np.log(5150.0), 256)
    # the reference reads splinestep even without continuum fitting
    conf['continuum'] = with_continuum
    especs = 1.0 / np.sqrt(ivar)
    ref = rcont.preprocess_fft_batch(lam, flux, especs, badmask=badmask,
                                     ccfconf=conf)
    got = continuum.preprocess_fft_batch(lam, flux, especs,
                                         badmask=badmask, ccfconf=conf,
                                         device='cpu')
    # 40 IRLS steps amplify last-bit differences of the two linear
    # solvers to ~1e-10 of the largest FFT coefficient
    for g, r in zip(got[:2], ref[:2]):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r[0] + 1j * r[1], rtol=1e-8,
                                   atol=1e-9 * np.abs(r).max())
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-8)


def test_generators_and_bank_match_reference():
    """The port's copies of the synthetic generators give identical
    arrays, and its bank construction matches the reference's."""
    for g, r in zip(simulation.make_template_grid(3, 3, 3, 2, npix=256),
                    rsim.make_template_grid(3, 3, 3, 2, npix=256)):
        for a, b in zip(g if isinstance(g, list) else [g],
                        r if isinstance(r, list) else [r]):
            np.testing.assert_array_equal(a, b)
    ga, gt = simulation.make_exposure(3, npix_arm=100, seed=4)
    ra, rt = rsim.make_exposure(3, npix_arm=100, seed=4)
    for k in rt:
        np.testing.assert_array_equal(gt[k], rt[k])
    for k in ra:
        for a, b in zip(ga[k], ra[k]):
            np.testing.assert_array_equal(a, b)
    kw = dict(nt=3, nl=3, nf=3, na=2, npix=512, every=2, step=2.0)
    got = simulation.build_ccf_bank(**kw, device='cpu')
    ref = rsim.build_ccf_bank(**kw)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g, r, rtol=1e-8,
                                   atol=1e-10 * np.abs(r).max())
    for key in ('params', 'vsinis', 'vsini_is_none', 'parnames'):
        np.testing.assert_array_equal(got[2][key], ref[2][key])
    assert got[2]['ccfconf'] == ref[2]['ccfconf']


def test_preprocess_model_list_with_vsini_matches_reference():
    lam, _, _, vecs, log_specs, _ = rsim.make_template_grid(
        2, 2, 2, 2, npix=400)
    conf = make_ccf.get_ccf_config(np.log(4600.0), np.log(5400.0), 256)
    assert conf == rmake_ccf.get_ccf_config(np.log(4600.0), np.log(5400.0),
                                            256)
    np.testing.assert_array_equal(make_ccf.get_mortoncurve_id(vecs.T),
                                  rmake_ccf.get_mortoncurve_id(vecs.T))
    got = make_ccf.preprocess_model_list(lam, np.exp(log_specs), vecs.T,
                                         conf, vsinis=[None, 30.0],
                                         device='cpu')
    ref = rmake_ccf.preprocess_model_list(lam, np.exp(log_specs), vecs.T,
                                          conf, vsinis=[None, 30.0])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-8)
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]


def test_fit_batch_matches_reference():
    """Same best template for every fiber, velocity within 1e-6 km/s,
    on the reference's bank carried over by convert.ccf_bank."""
    arms, truth = rsim.make_exposure(6, npix_arm=160, seed=3)
    bank = rsim.build_ccf_bank(3, 3, 3, 2, npix=512, every=2, step=2.0)
    batches = [(n, lam, fl, 1.0 / np.sqrt(iv), None)
               for n, (lam, fl, iv) in arms.items()]
    ref = rccf.fit_batch(batches, freeze(CONFIG),
                         banks={n: bank for n in arms})
    got = ccf.fit_batch(batches, CONFIG,
                        {n: convert.ccf_bank(*bank, device='cpu')
                         for n in arms})
    np.testing.assert_array_equal(got['best_id'], ref['best_id'])
    np.testing.assert_allclose(got['best_vel'], ref['best_vel'], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got['best_chi'], ref['best_chi'], rtol=1e-9)
    np.testing.assert_array_equal(got['best_params'], ref['best_params'])
    np.testing.assert_array_equal(got['vel_grid'], ref['vel_grid'])
    assert np.abs(got['best_vel'] - truth['vel']).max() < 100.0


def _small_bank(seed=11):
    """Kernel B's inputs at a small bank: T=7, F=65, V=21, B=5."""
    tfft, t2fft, sfft, ivfft, ecos, esin = _bank_arm(
        np.random.RandomState(seed), t=7, b=5, npoints=128, nvel=21)
    c = lambda a: _t(a, torch.complex128)
    return [c(tfft), c(t2fft), c(sfft), c(ivfft), _t(ecos), _t(esin)]


def _jax_plain(args, continuum_mode):
    """fit/ccf._ccf_batch_cont / _nocont of the reference."""
    pack = lambda c: jnp.asarray(np.stack([c.real, c.imag]))
    fn = rccf._ccf_batch_cont if continuum_mode else rccf._ccf_batch_nocont
    return np.asarray(fn(*[pack(a.numpy()) for a in args[:4]],
                         *[jnp.asarray(a.numpy()) for a in args[4:]]))


def _from_operands(ops, e, shape, continuum_mode, matmul=torch.matmul):
    cs = [matmul(a, e).reshape(shape) for a in ops]
    return cs[0] if continuum_mode else -(cs[0] * cs[0]) / cs[1]


@pytest.mark.parametrize('continuum_mode', [True, False])
def test_kernel_b_gemm_form_matches_plain(continuum_mode):
    """[Re X | -Im X] @ [Ecos; Esin] over flattened (fiber, template)
    rows is the kernel's contraction; in float64 it equals the plain
    version and the reference's to 1e-12 of max|out|."""
    args = _small_bank()
    ops, e = ccf_chisq.contraction_operands(*args, continuum=continuum_mode)
    assert [a.shape for a in ops] == [(35, 130)] * (1 if continuum_mode
                                                    else 2)
    got = _from_operands(ops, e, (5, 7, 21), continuum_mode)
    for want in (ccf_chisq.ccf_chisq_plain(*args, continuum=continuum_mode),
                 _jax_plain(args, continuum_mode)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def _tf32_product(passes):
    """Matmul with the kernel's arithmetic: float32 operands split by
    tf32_split, products of TF32 values (exact in float32) summed in
    float32; 3 passes lo*hi + hi*lo + hi*hi, or hi*hi alone."""
    def matmul(a, e):
        (ah, al), (eh, el) = ccf_chisq.tf32_split(a), ccf_chisq.tf32_split(e)
        out = ah @ eh
        return al @ eh + ah @ el + out if passes == 3 else out
    return matmul


def _tf32_error(continuum_mode, passes):
    args = _small_bank()
    want = _jax_plain(args, continuum_mode)
    ops, e = ccf_chisq.contraction_operands(
        *[a.to(torch.complex64 if a.is_complex() else torch.float32)
          for a in args], continuum=continuum_mode)
    got = _from_operands(ops, e, (5, 7, 21), continuum_mode,
                         _tf32_product(passes))
    assert got.dtype == torch.float32
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize('continuum_mode', [True, False])
def test_kernel_b_3xtf32_arithmetic_within_tolerance(continuum_mode):
    """The kernel's 3xTF32 arithmetic stays within its stated tolerance
    (1e-4 of max|out|) of the float64 reference."""
    assert _tf32_error(continuum_mode, passes=3) <= 1e-4


@pytest.mark.parametrize('continuum_mode', [True, False])
def test_kernel_b_single_tf32_pass_misses_tolerance(continuum_mode):
    """One TF32 pass (hi*hi) misses that tolerance: why the kernel
    takes three."""
    assert _tf32_error(continuum_mode, passes=1) > 1e-4


def test_kernel_b_operand_layouts():
    """The interleaved operands hold what the kernel reads at each
    (row, frequency) and (frequency, velocity): (T, T2), (S, IV) and
    TF32 hi/lo parts of Ecos and Esin whose sums are within float32
    rounding of them."""
    args = [a.to(torch.complex64 if a.is_complex() else torch.float32)
            for a in _small_bank()]
    tt2, siv, quads = ccf_chisq.kernel_operands(*args)
    assert tt2.shape == (7, 65, 2) and siv.shape == (5, 65, 2)
    assert quads.shape == (65, 21, 4) and quads.dtype == torch.float32
    floats = torch.view_as_real(tt2).reshape(7, 65, 4)
    assert torch.equal(floats[..., 0], args[0].real)
    assert torch.equal(floats[..., 3], args[1].imag)
    assert torch.equal(siv[..., 0], args[2]) and torch.equal(siv[..., 1],
                                                              args[3])
    for part, e in ((quads[..., :2], args[4]), (quads[..., 2:], args[5])):
        # the low 13 mantissa bits of every part are zero (TF32)
        assert not (part.contiguous().view(torch.int32) & 0x1FFF).any()
        np.testing.assert_allclose(part.sum(-1), e, rtol=2**-21,
                                   atol=2**-21 * float(e.abs().max()))
