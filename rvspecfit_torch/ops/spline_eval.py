"""Kernel A: Doppler spline evaluation at fractional knot indices, and
its adjoint.

Counterpart of rvspecfit_tpu/ops/pallas_spline.py (the Pallas kernel)
and of rvspecfit_tpu/ops/spline.spline_eval_index (its plain
semantics).  Every template evaluation of the fused likelihood goes
through :func:`spline_eval_index`:

* per-row mode (``rows_per_coeff=1``): row r of ``u`` uses coefficient
  row r — one optimizer trial per row;
* shared mode (``rows_per_coeff=V``): V consecutive query rows
  (velocities) share one fiber's coefficient row, which is indexed,
  never broadcast in memory.

The evaluation is linear in the coefficients, out = K(u) c.  So in
per-row mode the autograd pair :class:`SplineEval` /
:class:`SplineEvalAdjoint` gives exact derivatives of any order in the
coefficients through two kernels: the backward of K(u) c is the adjoint
K(u)^T g (:func:`spline_eval_index_vjp`), and the backward of the
adjoint is K(u) again.  The derivative in the queries (the velocity's
gradient, which the single-object fit's BFGS needs) is kernel A again:
on every interval d/du of the cubic is a cubic of the same form, whose
coefficients :func:`derivative_coeffs` gives, so d out/du = K(u) c'.

On a CPU tensor the wrappers run the plain versions (whose own
autograd serves); on a CUDA tensor they launch ``csrc/spline_eval.cu``
in its float64 form (the card's working type) or its float32 form, by
the tensors' dtype, or raise.  There is no fallback from a kernel to a
plain version.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from rvspecfit_torch import trace
from rvspecfit_torch.ops import cuda_build


def _intervals(geom, u, nm1):
    """Interval index (long) and the offsets dxl, dxr of every query:
    clamped to the knot range, NaN offsets (interval 0) for a NaN
    query."""
    idx = torch.clamp(torch.floor(u), 0, nm1 - 1)
    frac = u - idx
    iidx = torch.where(torch.isfinite(idx), idx, 0).long()
    if geom.log_step:
        xl = geom.x0 * torch.exp(idx * geom.step)
        ef = torch.expm1(frac * geom.step)
        dxl = xl * ef
        dxr = xl * (math.expm1(geom.step) - ef)
    else:
        dxl = frac * geom.step
        dxr = (1.0 - frac) * geom.step
    return iidx, dxl, dxr


def spline_eval_index_plain(geom, coeffs, u, rows_per_coeff=1):
    """Plain-torch spline evaluation (the kernel's oracle).

    geom : ops.spline.SplineGeometry (x0, step, log_step are read)
    coeffs : (C, 4, n-1) planes-first coefficients
    u : (C * rows_per_coeff, npix) fractional knot indices
    Returns (C * rows_per_coeff, npix) values; a query outside the
    knot range takes the clamped end interval's cubic, a NaN query
    gives NaN.
    """
    iidx, dxl, dxr = _intervals(geom, u, coeffs.shape[-1])
    crow = torch.arange(u.shape[0], device=u.device) // rows_per_coeff
    cf = coeffs[crow[:, None], :, iidx]                   # (R, npix, 4)
    return (cf[..., 0] * dxl * dxl * dxl + cf[..., 1] * dxr * dxr * dxr
            + cf[..., 2] * dxl + cf[..., 3] * dxr)


def spline_eval_index_vjp_plain(geom, u, g, nm1):
    """Plain-torch adjoint of per-row evaluation (the adjoint kernel's
    oracle): (R, npix) queries u and upstream gradient g -> (R, 4, nm1)
    with g[r, p] (dxl^3, dxr^3, dxl, dxr) added into column i(r, p)."""
    iidx, dxl, dxr = _intervals(geom, u, nm1)
    vals = torch.stack([g * dxl * dxl * dxl, g * dxr * dxr * dxr,
                        g * dxl, g * dxr], dim=1)         # (R, 4, npix)
    out = torch.zeros((u.shape[0], 4, nm1), dtype=vals.dtype,
                      device=u.device)
    return out.scatter_add_(2, iidx[:, None, :].expand(-1, 4, -1), vals)


def _argtypes(real, nint):
    """Pointers u/coeffs, .., then ``nint`` ints, the geometry's three
    reals of the launcher's form, the stream."""
    return [ctypes.c_void_p] * 3 + [ctypes.c_int] * nint + [real] * 3 \
        + [ctypes.c_void_p]


# rvst_spline_eval[_f64](coeffs, u, out, rows, npix, nm1, rows_per_coeff,
# log_step, x0, step, expm1_step, stream)
ARGTYPES = _argtypes(ctypes.c_float, 5)
ARGTYPES_F64 = _argtypes(ctypes.c_double, 5)
# rvst_spline_adjoint[_f64](u, g, dcoeffs, rows, npix, nm1, log_step, x0,
# step, expm1_step, stream)
ADJOINT_ARGTYPES = _argtypes(ctypes.c_float, 4)
ADJOINT_ARGTYPES_F64 = _argtypes(ctypes.c_double, 4)


def _bind(name, argtypes):
    fn = getattr(cuda_build.load('spline_eval'), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def build(dtype=torch.float32):
    """Compile (first call) and bind the C launcher of kernel A's
    ``dtype`` form (float32 or float64)."""
    if dtype == torch.float64:
        return _bind('rvst_spline_eval_f64', ARGTYPES_F64)
    return _bind('rvst_spline_eval', ARGTYPES)


@functools.lru_cache(maxsize=None)
def build_adjoint(dtype=torch.float32):
    """Compile (first call) and bind the C launcher of the adjoint's
    ``dtype`` form (same source and library as kernel A)."""
    if dtype == torch.float64:
        return _bind('rvst_spline_adjoint_f64', ADJOINT_ARGTYPES_F64)
    return _bind('rvst_spline_adjoint', ADJOINT_ARGTYPES)


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{name}: tensors on '
                         f'{" / ".join(str(t.device) for t in tensors)}; '
                         'need one CUDA device or CPU')
    dt = tensors[0].dtype
    if dt not in (torch.float32, torch.float64) \
            or any(t.dtype != dt for t in tensors):
        raise TypeError(f'{name}: CUDA kernel takes all float64 or all '
                        'float32, got '
                        f'{" / ".join(str(t.dtype) for t in tensors)}')


_FORMS = {torch.float64: 'float64', torch.float32: 'float32'}


def _geo_args(geom):
    return (int(geom.log_step), geom.x0, geom.step,
            math.expm1(geom.step) if geom.log_step else 0.0)


def _launch(geom, coeffs, u, rows_per_coeff):
    """Kernel A on CUDA tensors (checks, launch; the counter
    ``kernel_a.<mode>.<form>`` of trace.counters, and, while a profiler
    records, an event ``kernel_a`` with the launch's shapes)."""
    _check_cuda('spline_eval', u, coeffs)
    if coeffs.dim() != 3 or coeffs.shape[1] != 4 or u.dim() != 2 \
            or u.shape[0] != coeffs.shape[0] * rows_per_coeff:
        raise ValueError(f'spline_eval: bad shapes coeffs '
                         f'{tuple(coeffs.shape)}, u {tuple(u.shape)}, '
                         f'rows_per_coeff {rows_per_coeff}')
    if not (coeffs.is_contiguous() and u.is_contiguous()):
        raise ValueError('spline_eval: inputs must be contiguous')
    out = torch.empty_like(u)
    log_step, x0, step, em1 = _geo_args(geom)
    with torch.cuda.device(u.device):
        err = build(u.dtype)(coeffs.data_ptr(), u.data_ptr(),
                             out.data_ptr(), u.shape[0], u.shape[1],
                             coeffs.shape[-1], rows_per_coeff, log_step, x0,
                             step, em1, cuda_build.current_stream(u))
    cuda_build.check_launch(err, 'spline_eval')
    form = _FORMS[u.dtype]
    trace.count(f'kernel_a.{"per_row" if rows_per_coeff == 1 else "shared"}'
                f'.{form}')
    trace.event('kernel_a', rows=u.shape[0], npix=u.shape[1],
                nm1=coeffs.shape[-1], rows_per_coeff=rows_per_coeff,
                form=form)
    return out


def spline_eval_index_vjp(geom, u, g, nm1):
    """The adjoint kernel on CUDA tensors, its plain version on CPU
    tensors: (R, npix) u and g -> (R, 4, nm1) dcoeffs of their dtype.  Same
    contract as :func:`spline_eval_index_vjp_plain`; the result does
    not depend on the launch (no atomics).  A launch adds to the counter
    ``kernel_a_adjoint.<form>`` and, while a profiler records, makes an
    event ``kernel_a_adjoint`` with its shapes (:mod:`rvspecfit_torch.trace`)."""
    if u.device.type == 'cpu':
        return spline_eval_index_vjp_plain(geom, u, g, nm1)
    _check_cuda('spline_eval_adjoint', u, g)
    if u.dim() != 2 or g.shape != u.shape:
        raise ValueError(f'spline_eval_adjoint: bad shapes u '
                         f'{tuple(u.shape)}, g {tuple(g.shape)}')
    u, g = u.contiguous(), g.contiguous()
    out = torch.empty((u.shape[0], 4, nm1), dtype=u.dtype, device=u.device)
    log_step, x0, step, em1 = _geo_args(geom)
    with torch.cuda.device(u.device):
        err = build_adjoint(u.dtype)(
            u.data_ptr(), g.data_ptr(), out.data_ptr(), u.shape[0],
            u.shape[1], nm1, log_step, x0, step, em1,
            cuda_build.current_stream(u))
    cuda_build.check_launch(err, 'spline_eval_adjoint')
    form = _FORMS[u.dtype]
    trace.count(f'kernel_a_adjoint.{form}')
    trace.event('kernel_a_adjoint', rows=u.shape[0], npix=u.shape[1],
                nm1=nm1, form=form)
    return out


def derivative_coeffs(geom, coeffs):
    """(C, 4, n-1) coefficients of d/du of every interval's cubic, in
    the same form: with s = dxl, r = dxr = h - s, the cubic A s^3 +
    B r^3 + C s + D r has d/du = (3A s^2 - 3B r^2 + C - D) ds/du, ds/du
    = step (linear knots) or step (xl + s) (log knots), a cubic in s
    that is written back as A' s^3 + B' r^3 + C' s + D' r."""
    nm1 = coeffs.shape[-1]
    a, b, c, d = coeffs.unbind(1)
    i = torch.arange(nm1, dtype=coeffs.dtype, device=coeffs.device)
    step = geom.step
    if geom.log_step:
        xl = geom.x0 * torch.exp(i * step)
        h = xl * math.expm1(step)
    else:
        xl = None
        h = torch.full_like(i, step)
    q2, q1, q0 = 3 * (a - b), 6 * b * h, c - d - 3 * b * h * h
    if xl is None:
        p3, p2, p1, p0 = torch.zeros_like(q2), step * q2, step * q1, \
            step * q0
    else:
        p3, p2 = step * q2, step * (xl * q2 + q1)
        p1, p0 = step * (xl * q1 + q0), step * xl * q0
    b2 = p2 / (3 * h)
    d2 = (p0 - b2 * h**3) / h
    return torch.stack([p3 + b2, b2, p1 + 3 * h * h * b2 + d2, d2], 1)


# the two functions an autograd pair is built from: forward(geom, coeffs,
# u) and adjoint(geom, u, g, nm1)
Route = collections.namedtuple('Route', 'forward adjoint')
KERNELS = Route(lambda geom, c, u: _launch(geom, c.contiguous(), u, 1),
                spline_eval_index_vjp)
PLAIN = Route(spline_eval_index_plain, spline_eval_index_vjp_plain)


class SplineEval(torch.autograd.Function):
    """out = K(u) coeffs in per-row mode; the backward with respect to
    the coefficients is the adjoint, with respect to the queries K(u)
    of the derivative's coefficients.  ``route`` picks the kernels or
    the plain versions."""

    @staticmethod
    def forward(ctx, coeffs, u, geom, route):
        ctx.save_for_backward(coeffs, u)
        ctx.geom, ctx.route, ctx.nm1 = geom, route, coeffs.shape[-1]
        return route.forward(geom, coeffs, u)

    @staticmethod
    def backward(ctx, g):
        coeffs, u = ctx.saved_tensors
        dc = du = None
        if ctx.needs_input_grad[0]:
            dc = SplineEvalAdjoint.apply(u, g, ctx.geom, ctx.route, ctx.nm1)
        if ctx.needs_input_grad[1]:
            du = g * SplineEval.apply(derivative_coeffs(ctx.geom, coeffs),
                                      u, ctx.geom, ctx.route)
        return dc, du, None, None


class SplineEvalAdjoint(torch.autograd.Function):
    """dcoeffs = K(u)^T g; the backward with respect to g is K(u)."""

    @staticmethod
    def forward(ctx, u, g, geom, route, nm1):
        ctx.save_for_backward(u)
        ctx.geom, ctx.route = geom, route
        return route.adjoint(geom, u, g, nm1)

    @staticmethod
    def backward(ctx, gd):
        u, = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            raise NotImplementedError('spline_eval: the mixed second '
                                      'derivative in u and the '
                                      'coefficients is not implemented')
        dg = None
        if ctx.needs_input_grad[1]:
            dg = SplineEval.apply(gd, u, ctx.geom, ctx.route)
        return None, dg, None, None, None


def spline_eval_index(geom, coeffs, u, rows_per_coeff=1):
    """Kernel A on CUDA tensors, its plain version on CPU tensors.

    Same contract as :func:`spline_eval_index_plain`.  CUDA inputs must
    be all float64 or all float32 on one device.  Per-row mode is
    differentiable through kernel launches (:class:`SplineEval`); shared
    mode is not differentiated (a CUDA call that asks for it raises).
    """
    if u.device.type == 'cpu':
        return spline_eval_index_plain(geom, coeffs, u, rows_per_coeff)
    if rows_per_coeff == 1:
        return SplineEval.apply(coeffs, u, geom, KERNELS)
    if torch.is_grad_enabled() and (coeffs.requires_grad
                                    or u.requires_grad):
        raise NotImplementedError('spline_eval: shared mode has no adjoint')
    return _launch(geom, coeffs, u, rows_per_coeff)
