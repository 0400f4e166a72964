"""Batched Nelder-Mead simplex minimization.

Counterpart of rvspecfit_tpu/fit/neldermead.py: scipy's decisions
(alpha=1, gamma=2, rho=0.5, sigma=0.5) over a batch of instances, with
either of the reference's two candidate schemes (``RVST_NM_SCHEME``,
:func:`nm_scheme`):

* ``scan2`` (the default): per iteration each live instance evaluates
  the reflection, then ONE second candidate derived from it (expansion
  or a contraction): two sequential (B, 1) objective calls;
* ``cand4``: the reflection, the expansion and both contractions in
  one (B, 4) objective call: half the calls, twice the trials.

Both take the same decisions.  The rare shrink evaluates the shrunk
simplex only when a live instance needs it.  Converged instances are
frozen by masking, and the convergence test is scipy's with a
per-dimension ``xatol``.

The objective is ``fun(x (B, K, n)) -> (B, K)``: instance b evaluates
its own K candidate points.

The bookkeeping is float64 on every device: the simplexes, their
values, the centroid, the candidate points and the convergence test.
The objective runs in its template model's dtype (float64, the working
dtype, unless the caller built a float32 model), through
:func:`in_working_dtype`, so no simplex step is rounded to a float32
objective's precision.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from rvspecfit_torch import trace

SCHEMES = ('scan2', 'cand4')

# Simplex noise of the reference's build_simplex: the first n*n values
# of jax.random.normal(jax.random.PRNGKey(seed), (1, n, n),
# dtype=float64) for n <= 8, printed once with jax_enable_x64 for the
# two seeds a fit uses (vel_fit.SIMPLEX_SEED for the first simplex and
# SIMPLEX_SEED + 1 for the restart; the (1, n, n) draw of a key is the
# prefix of its (1, 8, 8) draw).  tests/test_torch_fit.py regenerates
# them with jax and checks them equal.
_SIMPLEX_NOISE = {
    20260816: (
        -0.3259224800865604, 0.4453569339051415, 0.05023294401855108,
        1.6448976525765462, -2.669126776273744, -0.1961999470027015,
        -1.7850076525064944, -0.31643544567529586, -0.16830852184678882,
        -0.21948654560571837, 0.6491894523462637, -1.169435147852792,
        0.024281875848720925, 1.1339750584309587, -0.1178122871451387,
        0.07263940106733055, 0.9014346630242449, -0.4849259794677525,
        -0.02530292298147122, 0.08576460165017599, 0.3459980632031683,
        0.5954482938179733, -0.4515999806788624, -0.8104073294191708,
        2.3035219697908222, -1.1669537664430223, -0.6931761344073224,
        -0.823514253416359, -1.7583371607766582, -0.40561509641342136,
        -0.6138914943627476, 0.8723729284052837, -1.522024243455728,
        1.6489269515089906, 1.7506610945986822, -0.7893530382580054,
        -1.096075368590413, 1.1498423409583636, 0.11378788581597074,
        0.01812176213706551, -0.27489370034541827, 0.8947070166440427,
        -1.298785180825874, 0.30288227674693335, 1.3544919796338084,
        -0.6922119917232951, -0.3947063407044753, -0.3202184869995693,
        0.3856311909945513, 2.139569868216646, 1.9909591383580194,
        -0.5885915286378912, -0.21961835346830588, 0.7535853804337647,
        -0.2806105060744635, 2.0467604490201103, -0.4362388124029686,
        0.14816495915238004, 0.2519500537893454, -0.16407503043388616,
        0.10335789843251164, -0.6181956218801462, 1.773091079213544,
        0.20980384630801327),
    20260817: (
        0.4301653841835445, 0.7643120722688838, -0.10686631694586154,
        -0.36597870712089, 1.241980542278682, 1.9062102173183129,
        -0.29567278987448464, -1.6185125264518425, -0.3556644739261916,
        0.11138215949018777, 0.4483510909886471, -0.3644157045685581,
        0.3861176795613195, -0.4308871436902449, -0.22692132295344206,
        0.6904190553231672, -1.6510639789919963, -1.1338110922587614,
        0.14796523941314949, -0.006588203220443575, -1.5660275536061823,
        -0.9385015641698253, 1.6165401603707847, 1.7338899782410262,
        1.5510943699453195, -1.3976713012419888, 0.07147991432814552,
        -0.14606248965256732, -1.0726456442562662, -0.5339648401213772,
        1.716540432661895, -0.4070370425292495, -1.6108311305136283,
        0.03772542092353579, 1.1616718130954022, 1.163936867032758,
        -0.7234718239567663, 2.141090238005038, -0.7674153518104849,
        0.4619164468819982, -1.9778311272466074, 0.33811493089264844,
        -0.10203764523101957, -0.047827436863969446, -0.3055173337141247,
        -0.6808351433118104, -2.3044640657164766, -0.2997242869981945,
        0.4446623315799656, -0.0730607065174703, 1.137288388908361,
        -1.218467443318818, -0.8811880472726566, -1.3875759192424086,
        -0.10028171994434518, -0.22200832752433744, 0.9363260758726415,
        0.3024509056721733, -0.26314442698874424, 0.24522950040611016,
        0.25605029320875017, -0.926673681061464, 1.7747299471206752,
        2.157192220380507),
}


def simplex_noise(seed, n):
    """(n, n) float64 noise of the reference simplex for ``seed``."""
    if seed not in _SIMPLEX_NOISE or not 1 <= n <= 8:
        raise ValueError(f'no simplex noise table for seed {seed}, n={n}')
    return np.asarray(_SIMPLEX_NOISE[seed][:n * n]).reshape(n, n)


def build_simplex(x0, scales, seed):
    """Host (B, n) start points -> (B, n+1, n) simplexes: the start
    point, then the start point plus scaled noise rows."""
    x0 = np.atleast_2d(np.asarray(x0, np.float64))
    noise = simplex_noise(seed, x0.shape[1])
    verts = x0[:, None, :] + np.asarray(scales)[None, None, :] * noise
    return np.concatenate([x0[:, None, :], verts], axis=1)


def nm_scheme(scheme=None):
    """The candidate scheme: ``scheme``, or where it is None
    ``RVST_NM_SCHEME`` (default ``scan2``, the reference's default).
    Any other value than those of ``SCHEMES`` raises ValueError (the
    reference runs ``scan2`` for it)."""
    if scheme is None:
        scheme = os.environ.get('RVST_NM_SCHEME', 'scan2')
    if scheme not in SCHEMES:
        raise ValueError(f'Nelder-Mead scheme {scheme!r} (RVST_NM_SCHEME):'
                         f' expected one of {SCHEMES}')
    return scheme


def nm_ncand(scheme=None):
    """Objective trials per NM iteration and instance under ``scheme``
    (None: :func:`nm_scheme`)."""
    return 2 if nm_scheme(scheme) == 'scan2' else 4


def _stats(simplex, fvals):
    """Worst/best rows, worst, second-worst and best values."""
    big = torch.finfo(simplex.dtype).max / 4
    fsafe = torch.where(torch.isfinite(fvals), fvals, big)
    iw = torch.argmax(fsafe, dim=1, keepdim=True)
    ib = torch.argmin(fsafe, dim=1, keepdim=True)
    f_second = fsafe.scatter(1, iw, -big).amax(1)
    return (iw, ib, fvals.gather(1, iw)[:, 0], f_second,
            fvals.gather(1, ib)[:, 0])


def _row(simplex, i):
    """simplex[b, i[b], :] for an index column i (B, 1)."""
    return simplex.gather(1, i[:, :, None].expand(
        -1, 1, simplex.shape[2]))[:, 0]


def converged(simplex, fvals, fatol, xatol):
    """scipy's test with a per-dimension (or scalar) ``xatol``."""
    _, ib, _, _, f_best = _stats(simplex, fvals)
    best = _row(simplex, ib)
    fspread = (fvals - f_best[:, None]).abs().amax(1)
    xdev = (simplex - best[:, None, :]).abs().amax(1)          # (B, n)
    xa = torch.as_tensor(xatol, dtype=simplex.dtype, device=simplex.device)
    return (fspread <= fatol) & (xdev <= xa).all(1)


def _step(fun, simplex, fvals, done, fatol, xatol, scheme=None):
    """One iteration on an unsorted simplex under ``scheme`` (None:
    :func:`nm_scheme`)."""
    alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5
    n = simplex.shape[2]
    iw, ib, f_worst, f_second, f_best = _stats(simplex, fvals)
    worst = _row(simplex, iw)
    best = _row(simplex, ib)
    centroid = (simplex.sum(1) - worst) / n

    xr = centroid + alpha * (centroid - worst)
    if nm_scheme(scheme) == 'cand4':
        # every candidate in one call, in the reference's order
        xe = centroid + gamma * (xr - centroid)
        xc_out = centroid + rho * (xr - centroid)
        xc_in = centroid - rho * (centroid - worst)
        fr, fe, fco, fci = fun(torch.stack([xr, xe, xc_out, xc_in],
                                           1)).unbind(1)
        # under this scheme f2 is a contraction's value when the
        # expansion is rejected: the expansion's test reads fe
        take_expansion = (fr < f_best) & (fe < fr)
        inside = fr >= f_worst
        x2 = torch.where(take_expansion[:, None], xe,
                         torch.where(inside[:, None], xc_in, xc_out))
        f2 = torch.where(take_expansion, fe, torch.where(inside, fci, fco))
    else:
        fr = fun(xr[:, None, :])[:, 0]
        # the one second candidate: fr < f_best -> expansion; fr >=
        # f_worst -> inside contraction; otherwise outside contraction
        # (for fr in [f_best, f_second) scipy accepts xr and this value
        # goes unused)
        x2 = torch.where((fr < f_best)[:, None],
                         centroid + gamma * (xr - centroid),
                         torch.where((fr >= f_worst)[:, None],
                                     centroid - rho * (centroid - worst),
                                     centroid + rho * (xr - centroid)))
        f2 = fun(x2[:, None, :])[:, 0]
        take_expansion = (fr < f_best) & (f2 < fr)

    expand = fr < f_best
    contract_out = (fr >= f_second) & (fr < f_worst)
    contract_in = fr >= f_worst
    accept_r = (~expand & ~contract_out & ~contract_in) | \
        (expand & ~take_expansion)
    accept_2 = take_expansion | (contract_out & (f2 <= fr)) | \
        (contract_in & (f2 < f_worst))
    shrink = ~(accept_r | accept_2)

    new_point = torch.where(accept_2[:, None], x2, xr)
    new_f = torch.where(accept_2, f2, fr)
    replace = torch.zeros_like(fvals, dtype=torch.bool).scatter(
        1, iw, True) & ~shrink[:, None]                      # (B, n+1)
    simplex_upd = torch.where(replace[:, :, None], new_point[:, None, :],
                              simplex)
    fvals_upd = torch.where(replace, new_f[:, None], fvals)

    if bool((shrink & ~done).any()):
        shrunk = best[:, None, :] + sigma * (simplex - best[:, None, :])
        simplex_upd = torch.where(shrink[:, None, None], shrunk,
                                  simplex_upd)
        fvals_upd = torch.where(shrink[:, None], fun(shrunk), fvals_upd)

    simplex_new = torch.where(done[:, None, None], simplex, simplex_upd)
    fvals_new = torch.where(done[:, None], fvals, fvals_upd)
    return simplex_new, fvals_new, done | converged(simplex_new, fvals_new,
                                                    fatol, xatol)


def nm_init(fun, simplex, fatol, xatol):
    """Evaluate starting simplexes -> (fvals, done)."""
    fvals = fun(simplex)
    return fvals, converged(simplex, fvals, fatol, xatol)


def nm_chunk(fun, simplex, fvals, done, fatol, xatol, chunk, scheme=None,
             stats=None):
    """Advance up to ``chunk`` iterations under ``scheme`` (None:
    :func:`nm_scheme`, read once), stopping early once every instance
    has converged.  Returns (simplex, fvals, done, iters).

    Each iteration is a span ``fit.nm.iter`` (:mod:`rvspecfit_torch.
    trace`) with ``live``, the instances not yet converged as it began;
    it ends where the loop reads the mask to decide whether to go on,
    so it holds the iteration's device work.  ``stats``, a dict,
    receives ``live_iters``, the sum of ``live`` over the iterations."""
    scheme = nm_scheme(scheme)
    it = live_iters = 0
    live = int((~done).sum())
    while it < chunk and live:
        with trace.span('fit.nm.iter', live=live):
            simplex, fvals, done = _step(fun, simplex, fvals, done, fatol,
                                         xatol, scheme)
            it += 1
            live_iters += live
            live = int((~done).sum())
    if stats is not None:
        stats['live_iters'] = live_iters
    return simplex, fvals, done, it


def in_working_dtype(fun, dtype):
    """``fun`` called with its trial points cast to ``dtype`` and its
    values cast back to float64 (a no-op pair where ``dtype`` is
    float64)."""
    return lambda x: fun(x.to(dtype)).to(torch.float64)


def minimize_batch(fun, simplex, fatol=1e-3, xatol=1e-2, maxiter=2000,
                   dtype=None, scheme=None):
    """Minimize ``fun`` from a batch of starting simplexes.

    simplex : (B, n+1, n) tensor; the bookkeeping runs in float64 on
        its device and ``fun`` gets its points in ``dtype`` (default:
        the simplex's dtype), see :func:`in_working_dtype`
    fatol, xatol : scipy's absolute tolerances (``xatol`` scalar or per
        dimension)
    maxiter : iteration cap; the loop runs :func:`nm_chunk` for up to
        64 iterations at a time, stopping once every instance converged
    scheme : ``'scan2'``, ``'cand4'`` or None (:func:`nm_scheme`, read
        once per call)

    Returns dict(x (B, n), fun (B,), converged (B,), nit,
    final_simplex (B, n+1, n)) as float64 tensors, each simplex sorted
    by value (row 0 the best vertex) as the reference returns it.
    """
    scheme = nm_scheme(scheme)
    fun = in_working_dtype(fun, dtype or simplex.dtype)
    simplex = simplex.to(torch.float64)
    xatol = torch.as_tensor(np.asarray(xatol, np.float64),
                            device=simplex.device)
    fvals, done = nm_init(fun, simplex, fatol, xatol)
    nit = 0
    while nit < maxiter and not bool(done.all()):
        simplex, fvals, done, it = nm_chunk(fun, simplex, fvals, done,
                                            fatol, xatol,
                                            min(64, maxiter - nit), scheme)
        nit += it
    order = torch.argsort(fvals, dim=1, stable=True)
    fvals = fvals.gather(1, order)
    simplex = simplex.gather(1, order[:, :, None].expand_as(simplex))
    return dict(x=simplex[:, 0], fun=fvals[:, 0], converged=done, nit=nit,
                final_simplex=simplex)
