"""Continuum-marginalized chi-square, batched over trials.

Counterpart of rvspecfit_tpu/ops/chisq.py.  With data D = spec/espec
and design rows S_p = basis_p * template / espec,

    -2 log L = log det(S S^T) + 2 sum(log espec) + || D - a^T S ||^2

with a the weighted-least-squares continuum coefficients.  The
residual form (not D^T D - v^T M^-1 v) keeps float32 stable.
"""
from __future__ import annotations

import torch


def chol_solve_logdet(m, v, ridge_rel=1e-10):
    """Solve m a = v for SPD (..., n, n) m; return (a, log det m).

    A factorization that fails is retried once with a relative ridge
    on the diagonal, skipped when the ridge is below the dtype's
    epsilon (it would round away); what still fails gives NaN, like
    the reference's unrolled Cholesky on a non-PD matrix.
    """
    n = m.shape[-1]
    chol, info = torch.linalg.cholesky_ex(m)
    ok = info == 0
    if ridge_rel > torch.finfo(m.dtype).eps:
        scale = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1) / n
        eye = torch.eye(n, dtype=m.dtype, device=m.device)
        chol2, info2 = torch.linalg.cholesky_ex(
            m + (ridge_rel * scale)[..., None, None] * eye)
        chol = torch.where(ok[..., None, None], chol, chol2)
        ok = ok | (info2 == 0)
    chol = torch.where(ok[..., None, None], chol, torch.nan)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                            dim2=-1)).sum(-1)
    # the two triangular solves of cholesky_solve (as the reference's
    # cho_solve): on the card they are cuBLAS's, which a CUDA graph can
    # capture (Nelder-Mead's iteration is one, fit/nm_graph.py), where
    # the batched cholesky_solve (MAGMA's) cannot be
    y = torch.linalg.solve_triangular(chol, v[..., None], upper=False)
    a = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
    return a, logdet


def basis_products(polys):
    """(npoly^2, npix) pairwise basis products; row p*npoly+q is
    polys[p] * polys[q]."""
    npoly = polys.shape[0]
    return (polys[:, None, :] * polys[None, :, :]).reshape(
        npoly * npoly, polys.shape[1])


def chisq_continuum_marg_batch(dvec, templ_over_espec, polys, polys_prod,
                               log_espec_sum, with_coeffs=False):
    """Batched continuum-marginalized -2 log L.

    dvec : (..., npix) broadcastable against templ_over_espec (..., npix);
    polys : (npoly, npix); polys_prod : (npoly^2, npix) from
    :func:`basis_products`; log_espec_sum broadcastable to the output.
    Returns (...) chisq [and (..., npoly) continuum coefficients].
    """
    npoly = polys.shape[0]
    # exact scale normalization: t/s keeps the normal matrix O(npix)
    # whatever the flux units; chi-square is corrected analytically by
    # the marginalization volume term 2 npoly log(s)
    scale = torch.clamp(templ_over_espec.abs().amax(-1, keepdim=True),
                        min=torch.finfo(templ_over_espec.dtype).tiny)
    tnorm = templ_over_espec / scale
    m = ((tnorm * tnorm) @ polys_prod.T).reshape(
        tnorm.shape[:-1] + (npoly, npoly))
    v = (dvec * tnorm) @ polys.T
    a, logdet = chol_solve_logdet(m, v)
    resid = dvec - (a @ polys) * tnorm
    chisq = (logdet + 2.0 * npoly * torch.log(scale[..., 0])
             + 2.0 * log_espec_sum + (resid * resid).sum(-1))
    if with_coeffs:
        return chisq, a / scale
    return chisq


def chisq_continuum_marg(dvec, templ_over_espec, polys, log_espec_sum,
                         with_coeffs=False):
    """Continuum-marginalized -2 log L of one dataset and one template.

    dvec, templ_over_espec : (npix,); polys : (npoly, npix);
    log_espec_sum : scalar.  Returns the scalar chisq [and the (npoly,)
    continuum coefficients], with the design rows S = polys * t / s
    formed explicitly as the reference's single-trial form does.
    """
    npoly = polys.shape[0]
    scale = torch.clamp(templ_over_espec.abs().amax(),
                        min=torch.finfo(templ_over_espec.dtype).tiny)
    st = polys * (templ_over_espec / scale)[None, :]      # (npoly, npix)
    a, logdet = chol_solve_logdet(st @ st.T, st @ dvec)
    resid = dvec - a @ st
    chisq = (logdet + 2.0 * npoly * torch.log(scale)
             + 2.0 * log_espec_sum + resid @ resid)
    if with_coeffs:
        return chisq, a / scale
    return chisq
