"""The port's prewarm (rvspecfit_torch/pipeline/prewarm.py): its
synthetic coadd equals the reference's for the same seed, and ``main``
fits one synthetic exposure through the driver on the CPU, with the
shapes from the library (--setups) or from a coadd (--like)."""
import numpy as np
import pytest

from rvspecfit_tpu.pipeline import prewarm as rprewarm
from rvspecfit_torch.io import fitsio
from rvspecfit_torch.pipeline import prewarm


@pytest.mark.parametrize('resol', [None, 11])
def test_synth_coadd_like_equals_the_references(resol, tmp_path):
    waves = {'b': np.linspace(4620.0, 4880.0, 90),
             'r': np.linspace(4880.0, 5140.0, 70)}
    ndiag = {s: resol for s in waves}
    prewarm.synth_coadd_like(str(tmp_path / 'port.fits'), waves, 4,
                             resol_ndiag=ndiag, seed=3)
    rprewarm.synth_coadd_like(str(tmp_path / 'ref.fits'), waves, 4,
                              resol_ndiag=ndiag, seed=3)
    got = fitsio.read(str(tmp_path / 'port.fits'))
    want = fitsio.read(str(tmp_path / 'ref.fits'))
    assert got.names() == want.names()
    assert ('B_RESOLUTION' in got.names()) == (resol is not None)
    for name in got.names()[1:]:
        g, w = got[name].data, want[name].data
        if isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_array_equal(g, w)


def test_main_setups_and_like_modes_on_the_cpu(desi_library, tmp_path,
                                               monkeypatch):
    """--setups: the grids come from the library trimmed by the
    velocity range; --like: from a coadd's wavelength extensions.  Both
    fit one 3-fiber exposure through the driver, leave nothing behind
    and build no kernel on the CPU."""
    from rvspecfit_torch.survey import desi
    calls = []
    real = desi.proc_many

    def spy(files, outdir, **kw):
        calls.append((kw['setups'], kw['device']))
        return real(files, outdir, **kw)
    monkeypatch.setattr(desi, 'proc_many', spy)
    monkeypatch.setattr(prewarm, 'build_kernels', lambda: calls.append(
        'built'))
    assert prewarm.main(['--templ_lib', desi_library, '--setups', 'b',
                         '--nfibers', '3', '--device', 'cpu',
                         '--log_level', 'WARNING']) == 0
    like = str(tmp_path / 'coadd-like.fits')
    waves = {s: np.linspace(l0, l1, 120) for s, (l0, l1) in
             (('b', (4630.0, 4870.0)), ('r', (4890.0, 5130.0)))}
    prewarm.synth_coadd_like(like, waves, 2)
    assert prewarm.main(['--like', like, '--templ_lib', desi_library,
                         '--setups', 'b,r', '--nfibers', '3', '--device',
                         'cpu', '--log_level', 'WARNING']) == 0
    assert [(s, d.type) for s, d in calls] == [(('b',), 'cpu'),
                                               (('b', 'r'), 'cpu')]
