"""Continuum basis (polynomial + Gaussian RBF), host float64.

Counterpart of rvspecfit_tpu/ops/basis.py (same definition; the port
keeps its own copy so that nothing of the JAX package is imported).
"""
import numpy as np


def continuum_basis(lam, npoly, rbf=True):
    """(npoly, npix) continuum basis on the wavelength grid ``lam``.

    With ``rbf`` the first three rows are 1, x, x^2 of the normalized
    wavelength x in [-1, 1] and the rest Gaussian RBFs on a uniform
    grid of centers with width 1/nrbf; otherwise Chebyshev T_0..T_{npoly-1}.
    """
    lam = np.asarray(lam, dtype=np.float64)
    x = (lam - lam[0]) / (lam[-1] - lam[0]) * 2.0 - 1.0
    out = np.zeros((npoly, lam.shape[0]))
    if not rbf:
        eye = np.eye(npoly)
        for i in range(npoly):
            out[i] = np.polynomial.Chebyshev(eye[i])(x)
        return out
    npoly0 = 3
    for i in range(min(npoly0, npoly)):
        out[i] = x**i
    nrbf = npoly - npoly0
    if nrbf > 0:
        sig = 1.0 / nrbf
        centers = np.linspace(-1.0, 1.0, nrbf)
        out[npoly0:] = np.exp(-0.5 * (x[None, :] - centers[:, None])**2
                              / sig**2)
    return out
