"""The port's offline template pipeline end to end, on the CPU: a
library and its CCF bank built by the rvstorch_* command lines alone,
in a process where ``jax`` and ``rvspecfit_tpu`` cannot be imported,
against the same library built by the reference's command lines: each
loads in the other package's loader, and the port's group fit through
either gives the same velocities and recovers the injected ones."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rvspecfit_tpu.fit import ccf as rccf
from rvspecfit_tpu.pipeline import library as rlib
from rvspecfit_tpu.pipeline import make_ccf as rmake_ccf
from rvspecfit_tpu.pipeline import make_interpol as rmake_interpol
from rvspecfit_tpu.pipeline import make_nd as rmake_nd
from rvspecfit_tpu.pipeline import mask_grid as rmask_grid
from rvspecfit_tpu.pipeline import read_grid as rread_grid
from rvspecfit_tpu.utils import freeze
from rvspecfit_torch import simulation
from rvspecfit_torch.fit import batch, ccf
from rvspecfit_torch.pipeline import library
from rvspecfit_torch.survey import desi
from test_torch_offline import CCF_ARGS, INTERPOL_ARGS, SETUP, write_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(min_vel=-1000, max_vel=1000, vel_step0=5, max_vsini=500,
              min_vsini=1e-2, min_vel_step=0.2, second_minimizer=True)
# three arms inside the library's 4600-5400 A at +-1000 km/s
LAYOUT = {'b': (4620.0, 4880.0), 'r': (4880.0, 5140.0),
          'z': (5140.0, 5390.0)}


def build_commands(root, out):
    """The offline pipeline's command lines (without the program):
    catalogue, PHOENIX mask, DESI-style specs, regular grid, CCF bank
    with vsini 0 and 300."""
    db = os.path.join(root, 'files.db')
    return [
        ('read_grid', ['--prefix', root, '--templdb', db,
                       '--glob_mask', 'specs/*fits']),
        ('mask_grid', ['--templdb', db, '--phoenix']),
        ('make_interpol', INTERPOL_ARGS + [
            '--templdb', db, '--templprefix', root, '--oprefix', out,
            '--wavefile', os.path.join(root, 'wave.fits')]),
        ('make_nd', ['--prefix', out, '--setup', SETUP, '--regulargrid']),
        ('make_ccf', CCF_ARGS + ['--prefix', out, '--oprefix', out])]


@pytest.fixture(scope='module')
def libraries(tmp_path_factory):
    """{'port': library directory the rvstorch_* command lines built in a
    process without jax and rvspecfit_tpu, 'ref': the reference's from
    the same FITS grid}."""
    base = tmp_path_factory.mktemp('offline_e2e')
    libs = {}
    for key in ('port', 'ref'):
        root = str(base / f'{key}_grid')
        write_grid(root)
        libs[key] = str(base / f'{key}_lib')
        cmds = build_commands(root, libs[key])
        if key == 'ref':
            mods = dict(read_grid=rread_grid, mask_grid=rmask_grid,
                        make_interpol=rmake_interpol, make_nd=rmake_nd,
                        make_ccf=rmake_ccf)
            for name, args in cmds:
                mods[name].main(args)
            continue
        cmds[-1][1].append('--cpu')
        code = ("import importlib, sys\n"
                "sys.modules['jax'] = None\n"
                "sys.modules['rvspecfit_tpu'] = None\n"
                f"for name, args in {cmds!r}:\n"
                "    importlib.import_module("
                "'rvspecfit_torch.pipeline.' + name).main(args)\n"
                "from rvspecfit_torch.fit import ccf\n"
                "from rvspecfit_torch.pipeline import library\n"
                f"cfg = dict(template_lib={libs[key]!r})\n"
                f"tm = library.load_template_model({SETUP!r}, cfg,"
                " device='cpu')\n"
                f"bank = ccf.get_ccf_info({SETUP!r}, cfg, device='cpu')\n"
                "assert 'jax' not in sys.modules or sys.modules['jax'] "
                "is None\n"
                "print(tuple(tm.state.dats.shape), tuple(bank[0].shape))\n")
        out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        npix = len(rmake_interpol.make_output_grid(4600.0, 5400.0, 0.5,
                                                   True))
        assert out.stdout.split('\n')[-2] == f'(54, {npix}) (54, 1025)'
    return libs


def _config(lib):
    return dict(CONFIG, template_lib=lib)


def _points():
    rng = np.random.RandomState(3)
    return np.column_stack([rng.uniform(4200, 9800, 8),
                            rng.uniform(0.7, 4.8, 8),
                            rng.uniform(-1.9, -0.1, 8),
                            rng.uniform(0.05, 0.95, 8)])


def test_libraries_load_in_both_loaders(libraries):
    """The port-built library in the reference's loader equals the
    reference-built one there, and the reference-built library in the
    port's loader equals the port-built one; so do the banks (within
    rtol 1e-8 of the reference's, the continua being fitted by two
    IRLS implementations)."""
    cfg = {k: _config(v) for k, v in libraries.items()}
    p = _points()
    rmods = {k: rlib.load_template_model(SETUP, freeze(c), cache=False)
             for k, c in cfg.items()}
    pmods = {k: library.load_template_model(SETUP, c, device='cpu')
             for k, c in cfg.items()}
    np.testing.assert_array_equal(
        np.asarray(rmods['port'].eval_batch(jnp.asarray(p))[0]),
        np.asarray(rmods['ref'].eval_batch(jnp.asarray(p))[0]))
    got = pmods['ref'].eval_batch(torch.as_tensor(p))[0].numpy()
    np.testing.assert_array_equal(
        got, pmods['port'].eval_batch(torch.as_tensor(p))[0].numpy())
    np.testing.assert_allclose(
        got, np.asarray(rmods['ref'].eval_batch(jnp.asarray(p))[0]),
        rtol=1e-12)
    rbank = {k: rccf.get_ccf_info(SETUP, freeze(c)) for k, c in cfg.items()}
    pbank = {k: ccf.get_ccf_info(SETUP, c, device='cpu')
             for k, c in cfg.items()}
    for i in range(2):
        want = np.asarray(rbank['ref'][i])
        for got in (np.asarray(rbank['port'][i]),
                    np.stack([pbank['ref'][i].real.numpy(),
                              pbank['ref'][i].imag.numpy()])):
            np.testing.assert_allclose(got, want, rtol=1e-8,
                                       atol=1e-8 * np.abs(want).max())
    np.testing.assert_allclose(pbank['port'][2], rbank['ref'][2],
                               rtol=1e-8, atol=1e-8)
    for key in ('params', 'vsinis', 'vsini_is_none', 'parnames'):
        np.testing.assert_array_equal(pbank['port'][3][key],
                                      rbank['ref'][3][key])


def test_group_fit_through_the_port_built_library(libraries):
    """The port's group fit (CCF start from the library's bank, NM,
    polish, refinement, Hessian errors) on fibers drawn from the
    library: through the port-built library it gives the velocities it
    gives through the reference-built one (within 1e-8 km/s), and it
    recovers the injected velocities."""
    tms = {k: library.load_template_model(SETUP, _config(v), device='cpu')
           for k, v in libraries.items()}
    arms_data, truth = simulation.model_exposure(
        tms['port'], 4, npix_arm=300, seed=5, layout=LAYOUT)
    arms = [batch.BatchArm(n, *a, setup=SETUP) for n, a in arms_data.items()]
    out = {k: desi._run_group_fit(arms, {SETUP: tm}, _config(libraries[k]),
                                  {'npoly': 6})
           for k, tm in tms.items()}
    vel = out['port']['ref']['best_vel']
    np.testing.assert_allclose(vel, out['ref']['ref']['best_vel'], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out['port']['vrad_ccf'],
                               out['ref']['vrad_ccf'], rtol=0, atol=1e-8)
    dv = vel - truth['vel']
    assert (np.abs(dv) < np.maximum(10.0, 5 * out['port']['ref']['vel_err'])
            ).all()
    assert (out['port']['fun'] <= out['port']['nm']['fun']).all()
