"""The port's library loaders against the reference's on the
desi_library fixture (a regular-grid library built by the reference's
offline pipeline), in float64 on the CPU."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu import serializer as rserializer
from rvspecfit_tpu import simulation as rsim
from rvspecfit_tpu.fit import ccf as rccf
from rvspecfit_tpu.pipeline import library as rlib
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import convert, serializer, simulation
from rvspecfit_torch.fit import ccf
from rvspecfit_torch.pipeline import library, make_ccf

SETUPS = ('desi_b', 'desi_r', 'desi_z')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(lib):
    return dict(template_lib=lib, min_vel=-1000, max_vel=1000, vel_step0=5,
                max_vsini=500, min_vsini=1e-2, min_vel_step=0.2)


def _assert_same(got, want):
    """Nested equality of loaded artifacts (arrays exactly)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize('name', ['interp_desi_b.h5', 'ccf_desi_r.h5',
                                  'specs_desi_z.h5'])
def test_serializer_reads_what_the_reference_reads(desi_library, name):
    path = os.path.join(desi_library, name)
    _assert_same(serializer.load_dict_from_hdf5(path),
                 rserializer.load_dict_from_hdf5(path))


def test_serializer_refuses_pickle_nodes(tmp_path):
    path = str(tmp_path / 'p.h5')
    rserializer.save_dict_to_hdf5(path, dict(a=np.arange(3), b={1, 2}),
                                  allow_pickle=True)
    with pytest.raises(ValueError, match='pickled'):
        serializer.load_dict_from_hdf5(path)
    with pytest.raises(RuntimeError, match='does not exist'):
        serializer.load_dict_from_hdf5(str(tmp_path / 'missing.h5'))


def _tensor_fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize('setup', SETUPS)
def test_template_model_matches_reference(desi_library, setup):
    """Every tensor of the loaded model equals the reference model's
    (carried over by convert), and eval_batch agrees at random
    parameters inside and outside the grid."""
    cfg = _config(desi_library)
    ref = rlib.load_template_model(setup, freeze(cfg))
    got = library.load_template_model(setup, cfg, device='cpu')
    want = convert.template_model(ref, device='cpu')
    assert got.parnames == want.parnames and got.log_ids == want.log_ids
    for part in ('state', 'geom'):
        g, w = _tensor_fields(getattr(got, part)), \
            _tensor_fields(getattr(want, part))
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(g[k], v), (part, k)
            elif isinstance(v, tuple) and v and torch.is_tensor(v[0]):
                assert all(torch.equal(a, b) for a, b in zip(g[k], v))
            else:
                assert g[k] == v, (part, k)
    rng = np.random.RandomState(0)
    params = np.column_stack([rng.uniform(3500, 10500, 12),
                              rng.uniform(0.0, 5.5, 12),
                              rng.uniform(-2.5, 0.5, 12),
                              rng.uniform(-0.2, 1.2, 12)])
    spec_r, out_r = ref.eval_batch(jnp.asarray(params))
    spec_p, out_p = got.eval_batch(torch.as_tensor(params))
    np.testing.assert_allclose(spec_p, spec_r, rtol=1e-12)
    np.testing.assert_allclose(out_p, out_r, rtol=1e-12, atol=1e-15)
    assert (out_p > 0).any() and (out_p == 0).any()


def test_other_interpolation_types_raise(desi_library):
    """A missing or unknown interpolation type raises, as the
    reference's loader does (a triangulation library loads since the
    triangulation branch was ported: tests/test_torch_triangulation.py)."""
    fd, dats = library.read_template_artifacts('desi_b',
                                               _config(desi_library))
    for itype in (None, 'spline'):
        with pytest.raises(RuntimeError, match='Unknown interpolation type'):
            library.template_model_from_artifacts(
                dict(fd, interpolation_type=itype), dats, device='cpu')


def test_synthetic_artifacts_give_the_reference_model():
    """simulation.template_artifacts -> template_model_from_artifacts
    (the path chip_smoke.py builds its model through) equals the
    reference's synthetic model."""
    got = simulation.build_template_model(3, 3, 3, 2, npix=256,
                                          device='cpu')
    want = convert.template_model(rsim.build_template_model(3, 3, 3, 2,
                                                            npix=256),
                                  device='cpu')
    for part in ('state', 'geom'):
        for k, v in _tensor_fields(getattr(want, part)).items():
            if isinstance(v, torch.Tensor):
                torch.testing.assert_close(getattr(getattr(got, part), k), v,
                                           rtol=1e-15, atol=0)


@pytest.mark.parametrize('setup', SETUPS)
def test_ccf_bank_matches_reference(desi_library, setup):
    """The bank's rFFTs as complex tensors equal the reference's
    stacked (real, imag) arrays; models and info equal."""
    cfg = _config(desi_library)
    r_fft, r_fft2, r_mods, r_info = rccf.get_ccf_info(setup, freeze(cfg))
    tfft, t2fft, mods, info = ccf.get_ccf_info(setup, cfg, device='cpu')
    assert tfft.dtype == torch.complex128
    for got, want in ((tfft, r_fft), (t2fft, r_fft2)):
        want = np.asarray(want)
        np.testing.assert_array_equal(got.real.numpy(), want[0])
        np.testing.assert_array_equal(got.imag.numpy(), want[1])
    np.testing.assert_array_equal(mods, r_mods)
    _assert_same(info, r_info)
    assert make_ccf.get_ccf_dat_name(setup, False) \
        == f'ccfdat_nocont_{setup}.npz'


def test_fit_batch_loads_banks_from_the_library(desi_library):
    """ccf.fit_batch with banks=None reads the library as the
    reference's does and gives the same picks."""
    cfg = _config(desi_library)
    lams = {'desi_b': (4620.0, 4880.0), 'desi_r': (4880.0, 5140.0),
            'desi_z': (5140.0, 5390.0)}
    rng = np.random.RandomState(2)
    vel = rng.uniform(-300, 300, 3)
    batches = []
    for s, (l0, l1) in lams.items():
        lam = np.linspace(l0, l1, 200)
        flux = np.array([rsim.fake_spectrum(lam / (1 + v / 299792.458),
                                            6000.0, 3.0, -1.0, 0.3)
                         for v in vel])
        flux += rng.normal(size=flux.shape) * flux / 50.0
        batches.append((s, lam, flux, flux / 50.0, None))
    want = rccf.fit_batch(batches, freeze(cfg))
    got = ccf.fit_batch(batches, cfg, device='cpu')
    np.testing.assert_array_equal(got['best_id'], want['best_id'])
    np.testing.assert_allclose(got['best_vel'], want['best_vel'], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.abs(got['best_vel'] - vel), 0, atol=10.0)


def test_loaders_need_h5py_only_when_reading(desi_library):
    """Without h5py (as on the card's machine) the modules import and
    reading a library raises ImportError."""
    code = ("import sys\n"
            "sys.modules['h5py'] = None\n"
            "from rvspecfit_torch.pipeline import library\n"
            "from rvspecfit_torch.fit import ccf\n"
            "try:\n"
            f"    library.read_template_artifacts('desi_b', "
            f"dict(template_lib={desi_library!r}))\n"
            "except ImportError:\n"
            "    print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
