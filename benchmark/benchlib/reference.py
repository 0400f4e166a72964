"""The plain reference: the fit's likelihood and best-fit models,
written from their published definitions in plain PyTorch, NumPy and
SciPy, in float64.  It imports nothing of the program under test and
takes nothing that the program made: only the template grid and the
observed spectra that the benchmark generated, and the answers it
judges.

For an answer (velocity v, parameters p, rotation vsini) and one arm:

1. the template: multilinear interpolation of the stored log-spectra
   over the (log10 Teff, log g, [Fe/H], [alpha/Fe]) grid, exponentiated
   (outside the grid, the nearest node, with the penalty
   distance x 10 x npix_total added to -2 log L);
2. rotation (where the fit models it): the piecewise-linear template
   convolved with a limb-darkened (eps = 0.6) rotation profile on the
   log-uniform grid, zero-padded at the ends;
3. the natural cubic spline of the template in wavelength, evaluated
   at the rest-frame wavelengths lam * sqrt((1 - v/c) / (1 + v/c));
4. the continuum: the basis 1, x, x^2 and npoly - 3 Gaussians (centres
   uniform on [-1, 1], width 1 / (npoly - 3)) of x = the arm's
   wavelength mapped onto [-1, 1]; with S_k = basis_k t / sigma and
   D = flux / sigma,
   -2 log L = log det(S S^T) + 2 sum log sigma + |D - a^T S|^2,
   a = (S S^T)^-1 S D, and the best-fit model (a^T basis) t.
The true chi-square of an arm is sum_good ((model - flux) / sigma)^2.
"""
import math

import numpy as np
import scipy.interpolate
import torch

C_KMS = 299792.458


class Grid:
    """The template grid of one setup: knots lam (P,), stored
    log-spectra (nspec, P) row-major over the nodes ``nodes`` (four
    arrays, Teff first, interpolated in log10)."""

    def __init__(self, lam, logspec, nodes):
        self.lam = np.asarray(lam, np.float64)
        self.logspec = logspec
        dev = logspec.device
        self.u = [torch.as_tensor(np.log10(nodes[0]), device=dev)] + [
            torch.as_tensor(np.asarray(x, np.float64), device=dev)
            for x in nodes[1:]]
        self.lens = [len(x) for x in nodes]
        self.strides = [int(np.prod(self.lens[i + 1:]))
                        for i in range(4)]
        mesh = torch.meshgrid(*self.u, indexing='ij')
        pts = torch.stack([m.reshape(-1) for m in mesh], 1)
        self.ptp = pts.amax(0) - pts.amin(0)
        self.pts = pts / self.ptp
        self.log_step = math.log(self.lam[1] / self.lam[0])

    def spectra(self, params):
        """(N, P) template spectra and (N,) outside-grid distances at
        (N, 4) external parameters."""
        q = params.clone()
        q[:, 0] = torch.log10(q[:, 0])
        n = q.shape[0]
        flat = torch.zeros(n, dtype=torch.long, device=q.device)
        inside = torch.ones(n, dtype=torch.bool, device=q.device)
        lo_ids, fracs = [], []
        for i, u in enumerate(self.u):
            j = torch.searchsorted(u, q[:, i].contiguous(), right=True) - 1
            inside &= (j >= 0) & (j < len(u) - 1)
            j = j.clamp(0, len(u) - 2)
            lo_ids.append(j)
            fracs.append((q[:, i] - u[j]) / (u[j + 1] - u[j]))
        acc = torch.zeros((n, self.logspec.shape[1]),
                          dtype=torch.float64, device=q.device)
        for corner in range(16):
            bits = [(corner >> (3 - i)) & 1 for i in range(4)]
            idx = sum((lo_ids[i] + bits[i]) * self.strides[i]
                      for i in range(4))
            w = torch.ones(n, dtype=torch.float64, device=q.device)
            for i in range(4):
                w = w * (fracs[i] if bits[i] else 1 - fracs[i])
            acc += w[:, None] * self.logspec[idx]
        d2 = ((q / self.ptp)[:, None, :] - self.pts[None]).pow(2).sum(-1)
        near = d2.argmin(1)
        dist = torch.where(inside, 0.0, d2.min(1).values.sqrt())
        out = torch.where(inside[:, None], acc, self.logspec[near])
        return torch.exp(out), dist


def rotation_kernel(vsini, log_step, eps=0.6):
    """Normalized taps (2h+1,) of the rotation profile at ``vsini``
    km/s: the profile K(x) = c1 sqrt(1-x^2) + c2 (1-x^2) integrated
    against the linear-interpolation hat of each pixel offset; a delta
    at vsini ~ 0."""
    r = vsini / C_KMS / log_step
    if r <= 1e-6:
        return np.ones(1)
    norm = math.pi * (1 - eps / 3)
    c1, c2 = 2 * (1 - eps) / norm, (math.pi / 2) * eps / norm

    def prim(x):               # primitives of K(x) and x K(x)
        x = np.clip(x, -1, 1)
        sq = np.sqrt(np.clip(1 - x * x, 0, None))
        return (c1 * 0.5 * (x * sq + np.arcsin(x)) + c2 * (x - x**3 / 3),
                -c1 / 3 * (1 - x * x) * sq + c2 * (x * x / 2 - x**4 / 4))

    def seg(a, b, slope, icpt):
        k0b, k1b = prim(b)
        k0a, k1a = prim(a)
        return np.where(b > a, slope * (k1b - k1a) + icpt * (k0b - k0a), 0)

    h = int(math.ceil(r)) + 1
    k = np.arange(h + 1, dtype=np.float64)
    w = seg(k / r, (k + 1) / r, -r, 1 + k) + seg((k - 1) / r, k / r, r,
                                                   1 - k)
    full = np.concatenate([w[1:][::-1], w])
    return full / full.sum()


def broaden(spec, vsinis, log_step):
    """Rows of ``spec`` (N, P) convolved ('same', zero-padded) with the
    rotation profile of each row's vsini."""
    out = spec.clone()
    for i, vs in enumerate(vsinis):
        kern = rotation_kernel(float(vs), log_step)
        if len(kern) == 1:
            continue
        h = len(kern) // 2
        kt = torch.as_tensor(kern[::-1].copy(), device=spec.device)
        out[i] = torch.nn.functional.conv1d(
            spec[i][None, None], kt[None, None], padding=h)[0, 0]
    return out


def spline(grid, spec):
    """The natural cubic splines (in wavelength, on the grid's knots)
    through the rows of ``spec`` (N, P)."""
    return scipy.interpolate.CubicSpline(grid.lam, spec.cpu().numpy().T,
                                         bc_type='natural')


def shifted(grid, cs, lam, vels, tidx, device):
    """(M, npix) values at the arm's wavelengths ``lam`` of the splines
    ``cs`` of rows ``tidx`` (M,), each at its velocity's rest frame."""
    out = np.empty((len(vels), len(lam)))
    for i, (v, t) in enumerate(zip(vels, tidx)):
        beta = v / C_KMS
        rest = lam * np.exp(0.5 * (np.log1p(-beta) - np.log1p(beta)))
        j = np.clip(np.searchsorted(grid.lam, rest, side='right') - 1, 0,
                    len(grid.lam) - 2)
        dx = rest - grid.lam[j]
        c = cs.c[:, j, t]
        out[i] = ((c[0] * dx + c[1]) * dx + c[2]) * dx + c[3]
    return torch.as_tensor(out, device=device)


def continuum_basis(lam, npoly):
    """(npoly, npix) basis: 1, x, x^2, then Gaussians."""
    x = (lam - lam[0]) / (lam[-1] - lam[0]) * 2 - 1
    rows = [x**i for i in range(min(3, npoly))]
    nrbf = npoly - 3
    for c in np.linspace(-1, 1, max(nrbf, 0)):
        rows.append(np.exp(-0.5 * (x - c)**2 * nrbf**2))
    return np.array(rows)


class Arm:
    """One arm of the observed data: wavelengths, flux and sigma (N,
    npix) float64, the mask of good pixels, the template grid and the
    continuum basis."""

    def __init__(self, lam, flux, sigma, good, grid, npoly, device):
        to = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                       device=device)
        self.lam = np.asarray(lam, np.float64)
        self.flux, self.sigma = to(flux), to(sigma)
        self.good = torch.as_tensor(np.asarray(good, bool), device=device)
        self.grid = grid
        self.basis = to(continuum_basis(self.lam, npoly))
        self.ccf = None             # a reference_ccf.CcfArm, if judged


def prepare(arms, params, vsinis, use_vsini):
    """Per arm, the splines of the templates at (N, 4) ``params`` (and
    rotation ``vsinis``) and their outside-grid distances."""
    dev = arms[0].flux.device
    p = torch.as_tensor(np.asarray(params, np.float64), device=dev)
    out = []
    for a in arms:
        t, dist = a.grid.spectra(p)
        if use_vsini:
            t = broaden(t, vsinis, a.grid.log_step)
        out.append((spline(a.grid, t), dist))
    return out


def likelihood(arms, prep, rows, tidx, vels, chunk=2048):
    """-2 log L, true chi-square (sums over arms) and per-arm models at
    M points: data rows ``rows``, templates ``tidx`` of ``prep`` and
    velocities ``vels`` (each (M,)).  Returns ((M,), (M,), [(M, npix)])."""
    dev = arms[0].flux.device
    rows, tidx = np.asarray(rows), np.asarray(tidx)
    vels = np.asarray(vels, np.float64)
    badchi = 10.0 * sum(len(a.lam) for a in arms)
    m2ll = torch.zeros(len(rows), dtype=torch.float64, device=dev)
    chi2 = torch.zeros_like(m2ll)
    models = []
    for a, (cs, dist) in zip(arms, prep):
        arm_models = []
        for lo in range(0, len(rows), chunk):
            sl = slice(lo, lo + chunk)
            r = torch.as_tensor(rows[sl], device=dev)
            t = shifted(a.grid, cs, a.lam, vels[sl], tidx[sl], dev)
            sig, flux = a.sigma[r], a.flux[r]
            s = a.basis[None] * (t / sig)[:, None, :]      # (m, k, npix)
            d = flux / sig
            mat = s @ s.transpose(1, 2)
            coef = torch.linalg.solve(mat, (s @ d[:, :, None]))[..., 0]
            resid = d - (coef[:, None, :] @ s)[:, 0]
            m2ll[sl] += (torch.linalg.slogdet(mat)[1]
                         + 2 * torch.log(sig).sum(1) + (resid**2).sum(1)
                         + dist[torch.as_tensor(tidx[sl], device=dev)]
                         * badchi)
            model = (coef @ a.basis) * t
            chi2[sl] += torch.where(a.good[r], (model - flux) / sig,
                                    0.0).pow(2).sum(1)
            arm_models.append(model)
        models.append(torch.cat(arm_models))
    return m2ll, chi2, models


def evaluate(arms, rows, vels, params, vsinis, use_vsini):
    """-2 log L, true chi-square (sums over arms) and per-arm models of
    the answers: data rows ``rows`` (N,), velocities (N,), parameters
    (N, 4), vsinis (N,).  Returns ((N,), (N,), [(N, npix)])."""
    prep = prepare(arms, params, vsinis, use_vsini)
    return likelihood(arms, prep, rows, np.arange(len(rows)), vels)


def velocity_error(arms, rows, vels, params, vsinis, use_vsini, sig0,
                   half=10, per=8):
    """The velocity's posterior r.m.s. about its minimum (N,): -2 log L
    on a grid of ``per`` points a ``sig0`` over +-``half`` ``sig0`` around
    ``vels``, the minimum refined by a parabola through its neighbours,
    and the weights exp(-(-2 log L - min) / 2)."""
    n = len(rows)
    off = np.arange(-half * per, half * per + 1) / per
    grid = np.asarray(vels)[:, None] + np.asarray(sig0)[:, None] * off
    prep = prepare(arms, params, vsinis, use_vsini)
    m = likelihood(arms, prep, np.repeat(rows, len(off)),
                   np.repeat(np.arange(n), len(off)),
                   grid.ravel())[0].cpu().numpy().reshape(n, len(off))
    i = np.clip(m.argmin(1), 1, len(off) - 2)
    k = np.arange(n)
    y0, y1, y2 = m[k, i - 1], m[k, i], m[k, i + 1]
    a2 = y0 - 2 * y1 + y2
    step = grid[:, 1] - grid[:, 0]
    with np.errstate(divide='ignore', invalid='ignore'):
        best = grid[k, i] + np.where(a2 > 0, 0.5 * (y0 - y2) / a2, 0) * step
    w = np.exp(-0.5 * np.clip(m - m.min(1)[:, None], 0, 1400))
    w /= w.sum(1)[:, None]
    return np.sqrt((w * (grid - best[:, None])**2).sum(1))


def param_hessian(arms, rows, vels, params, vsinis, use_vsini, steps):
    """(N, 4, 4) Hessians of (-2 log L) / 2 in the four parameters
    (Teff in K): central differences at steps ``steps`` (N, 4) and at
    half of them, combined by Richardson's extrapolation (which cancels
    the error of order step^2)."""
    params = np.asarray(params, np.float64)
    f = lambda p: evaluate(arms, rows, vels, p, vsinis,  # noqa: E731
                           use_vsini)[0].cpu().numpy()
    f0 = f(params)

    def central(h):
        hes = np.zeros((len(rows), 4, 4))
        e = lambda i, s: np.eye(4)[i][None] * h * s  # noqa: E731
        for i in range(4):
            hes[:, i, i] = (f(params + e(i, 1)) - 2 * f0
                            + f(params + e(i, -1))) / h[:, i]**2
            for j in range(i):
                d = (f(params + e(i, 1) + e(j, 1))
                     - f(params + e(i, 1) + e(j, -1))
                     - f(params + e(i, -1) + e(j, 1))
                     + f(params + e(i, -1) + e(j, -1)))
                hes[:, i, j] = hes[:, j, i] = d / (4 * h[:, i] * h[:, j])
        return hes
    return 0.5 * (4 * central(steps / 2) - central(steps)) / 3
