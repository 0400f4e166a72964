"""The port stands alone (no jax, no JAX package), its kernel wrappers
dispatch on the tensors' device, and chip_smoke.py refuses to run
without a CUDA card."""
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import rvspecfit_torch
from rvspecfit_torch import convert, device, simulation
from rvspecfit_torch.ops import ccf_chisq, spline, spline_eval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        rvspecfit_torch.__path__, 'rvspecfit_torch.'))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {'rvspecfit_torch.ops.spline_eval', 'rvspecfit_torch.fit.batch',
            'rvspecfit_torch.convert', 'rvspecfit_torch.ops.clip',
            'rvspecfit_torch.serializer', 'rvspecfit_torch.pipeline.library',
            'rvspecfit_torch.survey.desi', 'rvspecfit_torch.io.fitsio',
            'rvspecfit_torch.utils', 'rvspecfit_torch.frozendict',
            'rvspecfit_torch.fit.find_best', 'rvspecfit_torch.fit.vel_fit',
            'rvspecfit_torch.fit.likelihood',
            'rvspecfit_torch.survey.weave', 'rvspecfit_torch.interp.nn',
            'rvspecfit_torch.interp.mapper',
            'rvspecfit_torch.pipeline.train_nn',
            'rvspecfit_torch.interp.triangulation',
            'rvspecfit_torch.validation',
            'rvspecfit_torch.pipeline.read_grid',
            'rvspecfit_torch.pipeline.mask_grid',
            'rvspecfit_torch.pipeline.make_interpol',
            'rvspecfit_torch.pipeline.regularize_grid',
            'rvspecfit_torch.pipeline.make_nd',
            'rvspecfit_torch.pipeline.make_ccf',
            'rvspecfit_torch.parallel.distributed',
            'rvspecfit_torch.parallel.mesh',
            'rvspecfit_torch.perf',
            'rvspecfit_torch.pipeline.prewarm'} <= set(mods)
    # h5py, yaml and matplotlib are missing on the card's machine too;
    # the trainer takes optax's place and computes its PCA without
    # sklearn
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['optax'] = None\n"
            "sys.modules['sklearn'] = None\n"
            "sys.modules['rvspecfit_tpu'] = None\n"
            "sys.modules['h5py'] = None\n"
            "sys.modules['yaml'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            # the trainer with its PCA initialization runs too
            "import numpy as np\n"
            "from rvspecfit_torch.pipeline import train_nn\n"
            "rng = np.random.RandomState(0)\n"
            "train_nn.train_interpolator(rng.rand(12, 4), rng.rand(12, 9),"
            " width=4, nlayers=1, npc=3, num_epochs=1, device='cpu')\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def _spline_inputs(device, dtype=torch.float64):
    geom = spline.SplineGeometry.from_knots(np.linspace(4500.0, 5500.0, 50),
                                            log_step=False, device=device)
    coeffs = torch.zeros((2, 4, 49), dtype=dtype, device=device)
    u = torch.full((2, 7), 3.5, dtype=dtype, device=device)
    return geom, coeffs, u


def _ccf_inputs(device, cdtype=torch.complex128, rdtype=torch.float64):
    c = lambda *s: torch.ones(s, dtype=cdtype, device=device)
    r = lambda *s: torch.ones(s, dtype=rdtype, device=device)
    return c(3, 9), c(3, 9), c(2, 9), c(2, 9), r(9, 5), r(9, 5)


def test_cpu_tensors_take_the_plain_versions():
    before = (spline_eval.launches, spline_eval.adjoint_launches,
              ccf_chisq.launches)
    geom, coeffs, u = _spline_inputs('cpu')
    assert torch.equal(
        spline_eval.spline_eval_index(geom, coeffs, u),
        spline_eval.spline_eval_index_plain(geom, coeffs, u))
    assert torch.equal(
        spline_eval.spline_eval_index_vjp(geom, u, u, 49),
        spline_eval.spline_eval_index_vjp_plain(geom, u, u, 49))
    args = _ccf_inputs('cpu')
    assert torch.equal(ccf_chisq.ccf_chisq(*args),
                       ccf_chisq.ccf_chisq_plain(*args))
    assert (spline_eval.launches, spline_eval.adjoint_launches,
            ccf_chisq.launches) == before


def test_other_devices_raise_instead_of_falling_back():
    geom, coeffs, u = _spline_inputs('meta')
    with pytest.raises(ValueError):
        spline_eval.spline_eval_index(geom, coeffs, u)
    with pytest.raises(ValueError):
        spline_eval.spline_eval_index_vjp(geom, u, u, 49)
    with pytest.raises(ValueError):
        ccf_chisq.ccf_chisq(*_ccf_inputs('meta'))


def _bank():
    rng = np.random.RandomState(0)
    tfft = rng.normal(size=(3, 9)) + 1j * rng.normal(size=(3, 9))
    return tfft, tfft * 2.0, dict(params=np.zeros((3, 4)))


def test_entry_points_without_device_need_the_card(monkeypatch):
    """device=None means the CUDA card: without one the entry points
    raise instead of returning CPU tensors; device='cpu' still works."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        simulation.build_template_model(2, 2, 2, 2, npix=64)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.ccf_bank(*_bank())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        spline.SplineGeometry.from_knots(np.linspace(4500.0, 5500.0, 50),
                                         log_step=False)
    tm = simulation.build_template_model(2, 2, 2, 2, npix=64, device='cpu')
    assert tm.geom.h.device.type == tm.state.dats.device.type == 'cpu'
    assert tm.state.dats.dtype == torch.float64
    tfft, _, info = convert.ccf_bank(*_bank(), device='cpu')
    assert tfft.device.type == 'cpu' and tfft.dtype == torch.complex128
    assert info['params'].shape == (3, 4)


def test_working_dtype_is_float64_on_the_card():
    """The card computes in float64 like the CPU (ROADMAP C.1, C.2)."""
    for dev in ('cuda', 'cpu', torch.device('cuda', 0)):
        assert device.dtype_for(dev) == torch.float64
        assert device.complex_dtype_for(dev) == torch.complex128
    assert device.complex_of(torch.float32) == torch.complex64
    assert device.complex_of(torch.float64) == torch.complex128


def test_default_device_is_cuda_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert device.default_device() == torch.device('cuda')
    assert device.resolve_device(None) == torch.device('cuda')
    assert device.resolve_device('cpu') == torch.device('cpu')


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('rdtype,cdtype', [
    (torch.float16, torch.complex32), (torch.bfloat16, torch.complex64)])
def test_kernel_wrappers_reject_float64_cuda_tensors(cuda_device, rdtype,
                                                     cdtype):
    """The kernels take float64 (the card's working type) and float32;
    any other dtype raises (no fallback).  Named from when the kernels
    took float32 alone and float64 was the refused type."""
    geom, coeffs, u = _spline_inputs(cuda_device, rdtype)
    with pytest.raises(TypeError):
        spline_eval.spline_eval_index(geom, coeffs, u)
    with pytest.raises(TypeError):
        spline_eval.spline_eval_index_vjp(geom, u, u, 49)
    with pytest.raises(TypeError):
        ccf_chisq.ccf_chisq(*_ccf_inputs(cuda_device, cdtype, rdtype))


def test_chip_smoke_refuses_without_cuda_or_package(tmp_path):
    """Non-zero exit and no result line: without CUDA here, and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    alone = tmp_path / 'chip_smoke.py'
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), alone)
    for cwd, script in ((REPO, 'chip_smoke.py'), (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=''))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
