"""The plain reference of the CCF first guess, written from its published
definition (upstream rvspecfit's make_ccf and fitter_ccf) in plain
NumPy, SciPy and PyTorch, in float64.  It imports nothing of the program
under test and takes nothing that the program made: the template grid
and the observed spectra that the benchmark generated, and the answer it
judges (the velocity, the chi-square and the bank template that the
program's CCF chose).

For one arm of one spectrum and the chosen template:

1. the data: pixels in the driver's mask, those with an error over 10
   times the median error, and those whose 11-pixel median filter is not
   positive are masked (their error 1e9 times the median error) and
   filled by linear interpolation between good neighbours; the robust
   continuum (below) divides the flux, its square multiplies the inverse
   variance (0 where masked), and both are resampled linearly onto the
   CCF grid (``npoints`` log-uniform points on [lam0, lam1] of the
   template setup), the inverse variance as that of the interpolated
   value;
2. the template: the grid node, rotation-broadened at the bank's vsini,
   divided by its robust continuum (errors max(1e-5 model, 1e-2 median)),
   resampled linearly in log-lambda onto the CCF grid (1 outside);
3. the robust continuum: exp of a quadratic interpolating spline in
   log-flux with nodes every ``splinestep`` km/s, fitted under the
   soft-L1 loss sum 2 (sqrt(1 + r^2) - 1), r = (model - flux) / error,
   by 40 reweighted Gauss-Newton steps with step halving from the binned
   medians (which leave some fits short of convergence: the reference
   takes the same 40 steps, so that the CCF's answer is judged and not
   its optimizer's stop);
4. chi2(v) = sum over arms and pixels of ivar T(v)^2 - 2 flux ivar T(v),
   with T(v) the template shifted by the lag -v / step (step = (exp((ln
   lam1 - ln lam0) / npoints) - 1) 3e5 km/s), by its band-limited
   (Fourier) interpolation, on the velocity grid of 2 int(max_vel /
   vel_step0) + 1 points over +-max_vel; the velocity is the grid
   minimum refined by a parabola through its neighbours, the chi-square
   that at the grid minimum plus sum(flux^2 ivar).
"""
import math

import numpy as np
import scipy.interpolate
import scipy.signal
import torch

from benchlib import reference

MAXERR = 10.0
NITER = 40
FRACS = (1.0, 0.5, 0.25)


def ccf_conf(lam0, lam1, step, splinestep=1000.0, maxcontpts=20):
    """The CCF grid of a template setup: (log lam0, log lam1, npoints,
    splinestep)."""
    logl0, logl1 = math.log(lam0), math.log(lam1)
    npoints = 2**int(math.ceil(math.log2(int((lam1 - lam0) / step))))
    splinestep = max(splinestep, 3e5 * (math.exp((logl1 - logl0)
                                                 / maxcontpts) - 1))
    return logl0, logl1, npoints, splinestep


def spline_basis(lam, splinestep):
    """(npix, n) quadratic interpolating splines through nodes every
    ``splinestep`` km/s from lam's start, and the nodes' bin edges."""
    lstep = math.log(1 + splinestep / 3e5)
    n = int(math.ceil(math.log(lam.max() / lam.min()) / lstep))
    nodes = lam.min() * np.exp(np.arange(n) * lstep)
    edges = lam.min() * np.exp((np.arange(n + 1) - 0.5) * lstep)
    phi = np.stack([scipy.interpolate.UnivariateSpline(
        nodes, np.eye(n)[j], s=0, k=2)(lam) for j in range(n)], 1)
    return phi, edges


def robust_continuum(lam, flux, err, splinestep):
    """(N, npix) continua of the rows of ``flux`` (N, npix) with errors
    ``err``: the soft-L1 fit of exp(phi p) from the log binned medians,
    by NITER Gauss-Newton steps on the reweighted problem (weights
    1 / sqrt(1 + r^2), a ridge of 1e-10 of the normal matrix's mean
    diagonal), each taken at the best of 1, 1/2, 1/4 of its length or
    not at all, as the CCF's definition states it."""
    phi_np, edges = spline_basis(lam, splinestep)
    dev = flux.device
    phi = torch.as_tensor(phi_np, device=dev)
    n = phi.shape[1]
    which = np.searchsorted(edges, lam, side='right') - 1
    med = _median(flux)
    med = torch.where(med <= 0, med.abs() + (med == 0), med)
    p = torch.empty((flux.shape[0], n), dtype=torch.float64, device=dev)
    for b in range(n):
        sel = torch.as_tensor(np.nonzero(which == b)[0], device=dev)
        if len(sel):
            p[:, b] = torch.log(torch.maximum(_median(flux[:, sel]),
                                              1e-3 * med))
        else:
            p[:, b] = torch.log(med)

    def fit(p):
        model = torch.exp((p @ phi.T).clamp(-100, 100))
        r = (model - flux) / err
        return 2 * (torch.sqrt(1 + r * r) - 1).sum(1), model, r

    cur = fit(p)[0]
    eye = torch.eye(n, dtype=p.dtype, device=dev)
    for _ in range(NITER):
        _, model, r = fit(p)
        w = 1 / torch.sqrt(1 + r * r)
        a = model / err
        mat = (phi.T[None] * (w * a * a)[:, None, :]) @ phi
        rhs = -(w * a * r) @ phi
        mat = mat + (1e-10 * torch.diagonal(mat, dim1=1, dim2=2).sum(1) / n
                     + 1e-30)[:, None, None] * eye
        step = torch.linalg.solve(mat, rhs[..., None])[..., 0]
        step = torch.where(torch.isfinite(step), step, 0.0)
        tries = torch.stack([fit(p + f * step)[0] for f in FRACS])
        best = torch.cat([tries, cur[None]]).argmin(0)
        frac = torch.as_tensor(FRACS + (0.0,), dtype=p.dtype,
                               device=dev)[best]
        p = p + frac[:, None] * step
        cur = torch.minimum(cur, tries.min(0).values)
    return torch.exp((p @ phi.T).clamp(-100, 100))


def _median(x):
    s = x.sort(1).values
    n = x.shape[1]
    return 0.5 * (s[:, (n - 1) // 2] + s[:, n // 2])


def infill(lam, flux, bad):
    """Masked pixels replaced by linear interpolation between the
    nearest good neighbours (the nearest good value at the ends)."""
    out = flux.copy()
    for i in range(len(flux)):
        good = ~bad[i]
        if good.any() and bad[i].any():
            out[i, bad[i]] = np.interp(lam[bad[i]], lam[good],
                                       flux[i, good])
    return out


class CcfArm:
    """One arm of the judged spectra as the CCF sees them: wavelengths,
    flux and error (N, npix) as the driver hands them to the CCF, its
    mask, the template grid and the setup's CCF grid."""

    def __init__(self, lam, flux, err, bad, grid, setup, step, device):
        self.lam = np.asarray(lam, np.float64)
        self.flux = np.asarray(flux, np.float64)
        self.err = np.asarray(err, np.float64)
        self.bad = np.asarray(bad, bool)
        self.grid = grid
        self.conf = ccf_conf(setup['lam0'], setup['lam1'], step)
        self.device = device

    def prepared(self):
        """(proc, ivar) (N, npoints) on the CCF grid."""
        logl0, logl1, npoints, splinestep = self.conf
        to = lambda a: torch.as_tensor(a, device=self.device)  # noqa
        flux, err = self.flux, self.err
        mederr = np.median(err, axis=1)
        medf = scipy.signal.medfilt(flux, (1, 11))
        bad = self.bad | (err > MAXERR * mederr[:, None]) | (medf <= 0)
        cerr = np.where(bad, 1e9 * mederr[:, None], err)
        cflux = infill(self.lam, flux, bad)
        cont = robust_continuum(self.lam, to(cflux), to(cerr),
                                splinestep).cpu().numpy()
        medv = np.median(cflux, axis=1)[:, None]
        cont = np.where(medv > 0, np.maximum(1e-2 * medv, cont),
                        np.maximum(cont, 1.0))
        nflux = np.where(bad, 0.0, flux / cont)
        civar = np.where(bad, 0.0, cont**2 / cerr**2)
        ccf_lam = np.exp(np.linspace(logl0, logl1, npoints))
        j = np.searchsorted(self.lam, ccf_lam) - 1
        inside = (j >= 0) & (j <= len(self.lam) - 2)
        jc = np.clip(j, 0, len(self.lam) - 2)
        rw = np.where(inside, (ccf_lam - self.lam[jc])
                      / (self.lam[jc + 1] - self.lam[jc]), 0.0)
        lw = 1 - rw
        proc = inside * (lw * nflux[:, jc] + rw * nflux[:, jc + 1])
        li, ri = civar[:, jc], civar[:, jc + 1]
        with np.errstate(divide='ignore', invalid='ignore'):
            iv = np.where(li * ri > 0, li * ri / (lw**2 * ri + rw**2 * li),
                          0.0)
        return proc, inside * iv

    def templates(self, params, vsinis):
        """(N, npoints) bank templates at grid nodes ``params`` (N, 4)
        and rotation ``vsinis`` on the CCF grid."""
        logl0, logl1, npoints, splinestep = self.conf
        g = self.grid
        spec = g.spectra(torch.as_tensor(params, device=g.logspec.device)
                         )[0]
        spec = reference.broaden(spec, vsinis, g.log_step)
        med = _median(spec)
        err = torch.maximum(spec * 1e-5, 1e-2 * med[:, None])
        cont = robust_continuum(g.lam, spec, err, splinestep)
        cont = torch.maximum(cont, 1e-2 * _median(cont)[:, None])
        norm = (spec / cont).cpu().numpy()
        logl = np.linspace(logl0, logl1, npoints)
        return np.stack([np.interp(logl, np.log(g.lam), row, left=1.0,
                                   right=1.0) for row in norm])


def ccf_answer(arms, params, vsinis, max_vel, vel_step0):
    """The CCF's velocity and chi-square (N,) of the judged spectra
    against the bank templates ``params`` (N, 4), ``vsinis`` (N,) that
    the program chose, summed over the arms ``arms`` (CcfArm)."""
    nv = 2 * int(max_vel / vel_step0) + 1
    vgrid = np.linspace(-max_vel, max_vel, nv)
    chi = sse = 0.0
    for a in arms:
        logl0, logl1, npoints, _ = a.conf
        proc, iv = a.prepared()
        t = a.templates(params, vsinis)
        step = (math.exp((logl1 - logl0) / npoints) - 1) * 3e5
        k = np.arange(npoints // 2 + 1)
        wk = np.where((k == 0) | (2 * k == npoints), 1.0, 2.0)
        # sum_n x_n T(n + lag) = (1/N) sum_k w_k Re(T_k conj(X_k)
        # exp(2 pi i k lag / N)) for real x and T
        rot = np.exp(2j * np.pi * np.outer(k, -vgrid / step) / npoints)
        corr = lambda tt, x: ((np.fft.rfft(tt) * np.conj(np.fft.rfft(x)))  # noqa
                              * wk) @ rot / npoints
        chi = chi + (corr(t * t, iv) - 2 * corr(t, proc * iv)).real
        sse = sse + (proc * proc * iv).sum(1)
    pix = chi.argmin(1)
    pc = np.clip(pix, 1, nv - 2)
    rows = np.arange(len(pix))
    y0, y1, y2 = chi[rows, pc - 1], chi[rows, pc], chi[rows, pc + 1]
    a2 = y0 - 2 * y1 + y2
    with np.errstate(divide='ignore', invalid='ignore'):
        refined = vgrid[pc] + np.where(a2 > 0, 0.5 * (y0 - y2) / a2, 0.0) \
            * (vgrid[1] - vgrid[0])
    interior = (pix > 0) & (pix < nv - 1)
    return np.where(interior, refined, vgrid[pix]), chi[rows, pix] + sse, sse
