"""The triangulation branch of the port's library loader and its host
TriInterp against the reference's, in float64 on the CPU, on
triangulation libraries that the reference's make_nd builds from the
desi_library fixture's desi_b setup: a rectilinear one (converted
exactly), an irregular one (raises, or resampled through its Delaunay
interpolant where asked)."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvspecfit_tpu import serializer as rserializer
from rvspecfit_tpu.interp.triangulation import TriInterp as RTriInterp
from rvspecfit_tpu.pipeline import library as rlib
from rvspecfit_tpu.pipeline import make_nd
from rvspecfit_torch.interp.triangulation import TriInterp
from rvspecfit_torch.pipeline import library

SETUP = 'desi_b'
FILES = ('specs_%s.h5', 'interp_%s.h5', 'interpdat_%s.npy')


def _copy_lib(src, dst):
    os.makedirs(dst)
    for pat in FILES:
        shutil.copy(os.path.join(src, pat % SETUP), dst)
    return dst


@pytest.fixture(scope='module')
def tri_lib(desi_library, tmp_path_factory):
    """desi_b rebuilt by the reference's make_nd without --regulargrid:
    a triangulation library (jittered points and ghost corners) whose
    points are the rectilinear 4,4,3,2 grid."""
    lib = _copy_lib(desi_library, str(tmp_path_factory.mktemp('tri') / 'l'))
    make_nd.execute(SETUP, prefix=lib)
    return lib


def _irregular_lib(tri_lib, path, seed=1, scale=0.2):
    """tri_lib's points each moved by up to ``scale`` grid steps
    (tests/test_pipeline_e2e.py's irregular libraries)."""
    lib = _copy_lib(tri_lib, path)
    fn = os.path.join(lib, f'interp_{SETUP}.h5')
    fd = rserializer.load_dict_from_hdf5(fn)
    vec = np.asarray(fd['vec'], np.float64)
    real = np.asarray(fd['extraflags']) == 0
    pts = vec[:, real]
    step = np.array([np.ptp(v) for v in pts]) / \
        (np.array([len(np.unique(np.round(v, 5))) for v in pts]) - 1)
    rng = np.random.RandomState(seed)
    vec[:, real] = pts + rng.uniform(-scale, scale, pts.shape) \
        * step[:, None]
    os.remove(fn)
    rserializer.save_dict_to_hdf5(fn, dict(fd, vec=vec))
    return lib


def _config(lib, **kw):
    return dict(template_lib=lib, **kw)


def _points():
    rng = np.random.RandomState(4)
    return np.column_stack([rng.uniform(3800, 10500, 16),
                            rng.uniform(0.2, 5.3, 16),
                            rng.uniform(-2.3, 0.3, 16),
                            rng.uniform(-0.2, 1.2, 16)])


def _assert_same_model(got, want):
    """Same kind, names and grid axes, and the same spectra and
    outside distances at points inside and outside the grid (the
    distances within 1e-12: the reference expands the squared distance
    to the nearest node, which cancels to ~1e-13 where the port takes
    differences, ROADMAP C)."""
    assert got.kind == want.kind == 'grid'
    assert got.parnames == want.parnames and got.log_ids == want.log_ids
    for a, b in zip(got.state.uvecs, want.state.uvecs):
        np.testing.assert_array_equal(a, np.asarray(b))
    p = _points()
    spec, out = got.eval_batch(torch.as_tensor(p))
    rspec, rout = want.eval_batch(jnp.asarray(p))
    np.testing.assert_allclose(spec.numpy(), np.asarray(rspec), rtol=1e-12)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=0,
                               atol=1e-12)
    assert (out.numpy() > 0).any() and (out.numpy() == 0).any()


def test_rectilinear_triangulation_library_gives_the_reference_grid(
        tri_lib, desi_library):
    """Ghost corners and jitter stripped: the reference's grid model, and
    at the nodes the --regulargrid library's spectra."""
    cfg = _config(tri_lib)
    fd, dats = library.read_template_artifacts(SETUP, cfg)
    assert fd['interpolation_type'] == 'regulargrid'
    assert fd['idgrid'].shape == (4, 4, 3, 2) and (fd['idgrid'] >= 0).all()
    got = library.load_template_model(SETUP, cfg, device='cpu')
    _assert_same_model(got, rlib.load_template_model(SETUP, cfg,
                                                     cache=False))
    regular = library.load_template_model(SETUP, _config(desi_library),
                                          device='cpu')
    nodes = np.column_stack([10**fd['vec'][0], fd['vec'][1:].T])
    np.testing.assert_allclose(got.eval_batch(torch.as_tensor(nodes))[0],
                               regular.eval_batch(torch.as_tensor(nodes))[0],
                               rtol=1e-5)


def test_irregular_triangulation_library_raises(tri_lib, tmp_path):
    """An irregular point set is refused as the reference refuses it,
    naming the offline resampler."""
    lib = _irregular_lib(tri_lib, str(tmp_path / 'irr'))
    for load in (lambda: library.load_template_model(SETUP, _config(lib),
                                                     device='cpu'),
                 lambda: rlib.load_template_model(SETUP, _config(lib),
                                                  cache=False)):
        with pytest.raises(RuntimeError, match='rvst_regularize_grid'):
            load()


@pytest.mark.parametrize('how', ['env', 'config', 'env_n'])
def test_auto_regularized_library_matches_reference(tri_lib, tmp_path,
                                                    monkeypatch, how):
    """RVST_AUTO_REGULARIZE=1, config['auto_regularize'], and
    RVST_AUTO_REGULARIZE_N nodes per dimension: the resampled grid
    model equals the reference's; at its nodes inside the hull it is
    the Delaunay interpolant (float32 storage)."""
    lib = _irregular_lib(tri_lib, str(tmp_path / 'auto'))
    cfg = _config(lib, auto_regularize=how == 'config')
    if how != 'config':
        monkeypatch.setenv('RVST_AUTO_REGULARIZE', '1')
    if how == 'env_n':
        monkeypatch.setenv('RVST_AUTO_REGULARIZE_N', '5')
    got = library.load_template_model(SETUP, cfg, device='cpu')
    want = rlib.load_template_model(SETUP, cfg, cache=False)
    _assert_same_model(got, want)
    n = 5 if how == 'env_n' else 6   # clip(round(2 * 96**0.25), 4, 12)
    assert [len(u) for u in got.state.uvecs] == [n] * 4

    fd = rserializer.load_dict_from_hdf5(os.path.join(
        lib, f'interp_{SETUP}.h5'))
    dats = np.load(os.path.join(lib, f'interpdat_{SETUP}.npy'))
    tri = TriInterp.from_points(fd['vec'].T, dats)
    uv = [np.asarray(u) for u in got.state.uvecs]
    mids = np.array([[u[len(u) // 2 - k] for u in uv] for k in (0, 1)])
    ext = mids.copy()
    ext[:, 0] = 10**ext[:, 0]
    spec = got.eval_batch(torch.as_tensor(ext))[0].numpy()
    for k in range(2):
        np.testing.assert_allclose(spec[k], tri(mids[k]), rtol=1e-5)


def test_auto_regularize_refuses_a_grid_over_4_gib(tri_lib, tmp_path,
                                                   monkeypatch):
    lib = _irregular_lib(tri_lib, str(tmp_path / 'big'))
    monkeypatch.setenv('RVST_AUTO_REGULARIZE', '1')
    monkeypatch.setenv('RVST_AUTO_REGULARIZE_N', '200')
    with pytest.raises(RuntimeError, match='GiB'):
        library.read_template_artifacts(SETUP, _config(lib))


def test_tri_interp_matches_reference(tri_lib):
    """The host TriInterp: barycentric values (with and without exp)
    inside the hull, NaN outside, and batch."""
    fd = rserializer.load_dict_from_hdf5(os.path.join(
        tri_lib, f'interp_{SETUP}.h5'))
    dats = np.load(os.path.join(tri_lib, f'interpdat_{SETUP}.npy'))
    pts = fd['vec'].T
    rng = np.random.RandomState(5)
    inside = [w @ pts[:-16] for w in rng.dirichlet(np.ones(len(pts) - 16),
                                                   size=4)]
    probe = np.array(inside + [pts.max(0) + 1.0])
    for exp in (True, False):
        got = TriInterp.from_points(pts, dats, exp=exp)
        want = RTriInterp.from_points(pts, dats, exp=exp)
        for p in probe[:-1]:
            np.testing.assert_allclose(got(p), want(p), rtol=1e-14)
        assert np.isnan(got(probe[-1])) and np.isnan(want(probe[-1]))
    np.testing.assert_allclose(got.batch(probe[:2]), want.batch(probe[:2]),
                               rtol=1e-14)
    one = TriInterp.from_points(pts, dats[:, :1], exp=False)
    assert isinstance(one(probe[0]), float)
