"""Natural cubic splines on uniform (log-)knot grids: geometry + solve.

Counterpart of rvspecfit_tpu/ops/spline.py.  The knot geometry
(spacings, Thomas factors, banded-inverse taps) is precomputed once on
the host in float64 with numpy; the coefficient solve runs on tensors
of any leading batch shape.  Evaluation at Doppler-shifted fractional
indices is kernel A and lives in ops/spline_eval.py; :func:`spline_eval`
and :func:`spline_fit_eval` evaluate one spline at wavelengths.

Two solves give the same natural spline:

* the banded inverse: the spline system factors as diag(h) @ K with K
  a Toeplitz tridiagonal whose inverse rows decay as ~0.268^|i-j|, so
  z = K^-1 (u/h) is a (2w+1)-tap cross-correlation (``conv1d``) plus
  exact corrections for the first/last E rows (two small matmuls).
  The correlation is an autograd pair (:class:`BandCorrelation`): its
  backward is the correlation with the flipped taps, so derivatives of
  any order are forward ``conv1d`` calls on contiguous rows (autograd's
  own double backward of ``conv1d`` takes a far slower cuDNN path at
  the polish's shapes on an H100, see PERF.md);
* a sequential Thomas solve for short (m2 < 4E) or non-geometric
  grids, where the banded form does not apply.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from rvspecfit_torch.device import dtype_for, resolve_device

_W_BAND, _E_ROWS = 22, 30      # truncation ~0.268^22 ~ 3e-13
ARRAY_FIELDS = ('h', 'hinv', 'xs', 'denom_inv', 'fwd_a', 'cp',
                'inv_kernel', 'inv_top', 'inv_bot')


def geometry_arrays(xs, log_step, validate=True):
    """Host float64 precompute of a knot grid (numpy dict).

    Same arrays as the reference SplineGeometry.from_knots
    (rvspecfit_tpu/ops/spline.py:104-200)."""
    xs64 = np.asarray(xs, dtype=np.float64)
    n = xs64.shape[0]
    if n < 4:
        raise ValueError('Need at least 4 knots for a cubic spline')
    if validate:
        steps = np.diff(np.log(xs64)) if log_step else np.diff(xs64)
        if not np.allclose(steps, steps[0], rtol=1e-8, atol=0):
            raise ValueError(
                'Knots must be uniformly spaced (in log if log_step)')
    step = float(np.log(xs64[1] / xs64[0])) if log_step \
        else float(xs64[1] - xs64[0])

    h = np.diff(xs64)
    c = h[1:-1]
    b = 2.0 * (h[:-1] + h[1:])
    m = n - 2
    denom = np.empty(m)
    cp = np.zeros(m)
    denom[0] = b[0]
    for i in range(1, m):
        cp[i - 1] = c[i - 1] / denom[i - 1]
        denom[i] = b[i] - c[i - 1] * cp[i - 1]
    fwd_a = np.zeros(m)
    fwd_a[1:] = -c / denom[1:]

    inv_kernel = inv_top = inv_bot = None
    hr = h[1:] / h[:-1]
    q = float(hr[0]) if len(hr) else 1.0
    geometric = np.allclose(hr, q, rtol=1e-9, atol=0)
    if m >= 4 * _E_ROWS and geometric:
        from scipy.linalg import solve_banded

        # rows of K^-1 = columns of (K^T)^-1; K^T is tridiagonal with
        # upper diagonal 1 and lower diagonal q
        ab = np.zeros((3, m))
        ab[0, 1:] = 1.0
        ab[1, :] = 2.0 * (1.0 + q)
        ab[2, :-1] = q
        mid = m // 2
        want = list(range(_E_ROWS)) + [mid] + \
            list(range(m - _E_ROWS, m))
        rhs = np.zeros((m, len(want)))
        rhs[want, np.arange(len(want))] = 1.0
        rows = solve_banded((1, 1), ab, rhs).T
        inv_row = {i: rows[k] for k, i in enumerate(want)}
        kern = inv_row[mid][mid - _W_BAND:mid + _W_BAND + 1]

        def correction(i):
            toep = np.zeros(m)
            lo = max(0, i - _W_BAND)
            hi = min(m, i + _W_BAND + 1)
            toep[lo:hi] = kern[lo - (i - _W_BAND):(hi - i) + _W_BAND]
            return inv_row[i] - toep

        wtop = _E_ROWS + _W_BAND + 1
        inv_kernel = kern
        inv_top = np.stack([correction(i)[:wtop] for i in range(_E_ROWS)])
        inv_bot = np.stack([correction(m - _E_ROWS + i)[-wtop:]
                            for i in range(_E_ROWS)])
    return dict(x0=float(xs64[0]), x_last=float(xs64[-1]), step=step, n=n,
                log_step=bool(log_step), h=h, hinv=1.0 / h, xs=xs64,
                denom_inv=1.0 / denom, fwd_a=fwd_a, cp=cp,
                inv_kernel=inv_kernel, inv_top=inv_top, inv_bot=inv_bot)


@dataclasses.dataclass(frozen=True)
class SplineGeometry:
    """Knot-grid constants for spline construction and evaluation.

    ``step`` is the log-step when ``log_step`` (knots uniform in
    log x), else the linear step.  Tensor fields live on one device in
    one dtype; ``inv_*`` are None when the Thomas solve is used.
    """

    x0: float
    x_last: float
    step: float
    n: int
    log_step: bool
    h: torch.Tensor
    hinv: torch.Tensor
    xs: torch.Tensor
    denom_inv: torch.Tensor
    fwd_a: torch.Tensor
    cp: torch.Tensor
    inv_kernel: torch.Tensor | None = None
    inv_top: torch.Tensor | None = None
    inv_bot: torch.Tensor | None = None

    @classmethod
    def from_arrays(cls, *, x0, x_last, step, n, log_step, device=None,
                    dtype=None, **arrays):
        """Build from host arrays (the names of ``geometry_arrays``)."""
        device = resolve_device(device)
        dtype = dtype or dtype_for(device)
        to = lambda a: None if a is None else torch.as_tensor(
            np.asarray(a, np.float64), dtype=dtype, device=device)
        return cls(float(x0), float(x_last), float(step), int(n),
                   bool(log_step),
                   **{k: to(arrays.get(k)) for k in ARRAY_FIELDS})

    @classmethod
    def from_knots(cls, xs, log_step, device=None, dtype=None,
                   validate=True):
        return cls.from_arrays(**geometry_arrays(xs, log_step, validate),
                               device=device, dtype=dtype)


def spline_coeffs(geom: SplineGeometry, ys):
    """Natural-cubic-spline coefficients of knot values ``ys``.

    ys : (..., n) -> (..., 4, n-1) planes-first (A, B, C, D) with
    S(x) = A dxl^3 + B dxr^3 + C dxl + D dxr on [x_i, x_{i+1}],
    dxl = x - x_i, dxr = x_{i+1} - x.
    """
    batch = ys.shape[:-1]
    yb = ys.reshape(-1, ys.shape[-1])
    if geom.inv_kernel is not None:
        z_int = _banded_inverse_solve(geom, yb)
    else:
        z_int = _thomas_solve(geom, yb)
    z = F.pad(z_int, (1, 1))                              # (B, n)
    h, hinv = geom.h, geom.hinv
    sixth = 1.0 / 6.0
    a_coef = z[:, 1:] * hinv * sixth
    b_coef = z[:, :-1] * hinv * sixth
    c_coef = yb[:, 1:] * hinv - z[:, 1:] * h * sixth
    d_coef = yb[:, :-1] * hinv - z[:, :-1] * h * sixth
    out = torch.stack([a_coef, b_coef, c_coef, d_coef], dim=-2)
    return out.reshape(batch + (4, geom.n - 1))


class BandCorrelation(torch.autograd.Function):
    """'same'-size cross-correlation of rows x (B, m) with odd-length
    taps k (2w+1,), zero-padded: y_i = sum_d k[d+w] x_{i+d}.  Linear in
    x with constant taps; its adjoint is the correlation with the
    flipped taps, which is also its backward (so it differentiates any
    number of times)."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(k)
        w = (k.shape[0] - 1) // 2
        return F.conv1d(x.contiguous()[:, None, :], k[None, None, :],
                        padding=w)[:, 0, :]

    @staticmethod
    def backward(ctx, g):
        k, = ctx.saved_tensors
        return BandCorrelation.apply(g, k.flip(0)), None


def _banded_inverse_solve(geom, yb):
    """Interior second derivatives z (B, n-2) via the banded inverse."""
    hinv = geom.hinv
    m2 = geom.n - 2
    slopes = (yb[:, 1:] - yb[:, :-1]) * hinv
    up = 6.0 * (slopes[:, 1:] - slopes[:, :-1]) * hinv[:m2]
    # the row-Toeplitz application sum_d kern[d+w] u_{j+d}
    z = BandCorrelation.apply(up, geom.inv_kernel)
    e_rows, wtop = geom.inv_top.shape
    top = z[:, :e_rows] + up[:, :wtop] @ geom.inv_top.T
    bot = z[:, m2 - e_rows:] + up[:, m2 - wtop:] @ geom.inv_bot.T
    return torch.cat([top, z[:, e_rows:m2 - e_rows], bot], dim=1)


def _thomas_solve(geom, yb):
    """Interior second derivatives by the sequential Thomas solve with
    the precomputed elimination factors (short or non-geometric
    grids)."""
    slopes = (yb[:, 1:] - yb[:, :-1]) * geom.hinv
    rhs = 6.0 * (slopes[:, 1:] - slopes[:, :-1]) * geom.denom_inv
    m = geom.n - 2
    dp = [rhs[:, 0]]
    for i in range(1, m):
        dp.append(geom.fwd_a[i] * dp[-1] + rhs[:, i])
    z = [dp[m - 1]]
    for i in range(m - 2, -1, -1):
        z.append(dp[i] - geom.cp[i] * z[-1])
    return torch.stack(z[::-1], dim=-1)


def fractional_index(geom: SplineGeometry, x):
    """Host float64 fractional knot indices of query points ``x``."""
    x = np.asarray(x, dtype=np.float64)
    if geom.log_step:
        return (np.log(x) - np.log(geom.x0)) / geom.step
    return (x - geom.x0) / geom.step


def fractional_index_device(geom: SplineGeometry, x):
    """Fractional knot indices of the query tensor ``x`` in its own
    precision (enough for nearest-pixel gathers; spline evaluation uses
    the host float64 :func:`fractional_index`)."""
    if geom.log_step:
        return (torch.log(x) - np.log(geom.x0)) / geom.step
    return (x - geom.x0) / geom.step


def nearest_eval_index(geom: SplineGeometry, values, u):
    """Nearest-knot evaluation at fractional indices ``u``: the
    ``fast_interp`` mode (reference: py/rvspecfit/spec_fit.py:913-918),
    one gather of the template's own pixel values instead of the cubic
    spline.

    values : (R, n) knot values; u : (R, m) fractional indices, each row
    read from its row of ``values``.  Returns (vals (R, m), inrange):
    the index is ``round(u)`` (halves to even) clipped to [0, n-1], and
    ``inrange`` is 0 <= u < n-1."""
    idx = torch.clamp(torch.round(u), 0, geom.n - 1).long()
    inrange = (u >= 0) & (u < geom.n - 1)
    return torch.gather(values, -1, idx), inrange


def doppler_index_shift(geom: SplineGeometry, vels):
    """Per-trial fractional-index shift of the Doppler factor.

    Log grids: a constant index shift log(dop)/step with
    log(dop) = (log1p(-beta) - log1p(beta))/2 (cancellation-free).
    Linear grids: returns (dop - 1), to be multiplied by the per-pixel
    lam/step.
    """
    beta = vels / 299792.458
    logdop = 0.5 * (torch.log1p(-beta) - torch.log1p(beta))
    if geom.log_step:
        return logdop / geom.step
    return torch.expm1(logdop)


def spline_eval(geom: SplineGeometry, coeffs, x):
    """One spline's values at query points ``x`` (reference:
    rvspecfit_tpu/ops/spline.py:290).

    coeffs : (4, n-1) planes-first (:func:`spline_coeffs` of one knot
    vector); x : query points of any shape (a tensor, or host values
    placed on the coefficients' device).  Returns (values, inrange):
    outside [x0, x_last) the clamped end interval's cubic, and inrange
    True where x0 <= x < x_last.  The knot bracketing x is computed from
    the uniform grid, as the reference does.
    """
    x = torch.as_tensor(x, dtype=coeffs.dtype, device=coeffs.device)
    if geom.log_step:
        idx_f = (torch.log(x) - np.log(geom.x0)) / geom.step
    else:
        idx_f = (x - geom.x0) / geom.step
    idx = torch.clamp(idx_f.to(torch.int32), 0, geom.n - 2).long()
    inrange = (x >= geom.x0) & (x < geom.x_last)
    if geom.log_step:
        xl = geom.x0 * torch.exp(idx.to(x.dtype) * geom.step)
        xr = xl * np.exp(geom.step)
    else:
        xl = geom.x0 + idx.to(x.dtype) * geom.step
        xr = xl + geom.step
    dxl, dxr = x - xl, xr - x
    cf = coeffs[:, idx]                                   # (4, ...)
    return (cf[0] * dxl * dxl * dxl + cf[1] * dxr * dxr * dxr
            + cf[2] * dxl + cf[3] * dxr), inrange


def spline_fit_eval(geom: SplineGeometry, ys, x):
    """The natural spline through knot values ``ys`` (n,) at ``x``:
    :func:`spline_eval` of :func:`spline_coeffs` (reference:
    rvspecfit_tpu/ops/spline.py:419)."""
    return spline_eval(geom, spline_coeffs(geom, ys), x)
