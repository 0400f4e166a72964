"""Kernel A: Doppler spline evaluation at fractional knot indices.

Counterpart of rvspecfit_tpu/ops/pallas_spline.py (the Pallas kernel)
and of rvspecfit_tpu/ops/spline.spline_eval_index (its plain
semantics).  Every template evaluation of the fused likelihood goes
through :func:`spline_eval_index`:

* per-row mode (``rows_per_coeff=1``): row r of ``u`` uses coefficient
  row r — one optimizer trial per row;
* shared mode (``rows_per_coeff=V``): V consecutive query rows
  (velocities) share one fiber's coefficient row, which is indexed,
  never broadcast in memory.

On a CPU tensor the wrapper runs :func:`spline_eval_index_plain`; on a
CUDA tensor it launches ``csrc/spline_eval.cu`` or raises.  There is
no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from rvspecfit_torch.ops import cuda_build

# kernel launches by this process (chip_smoke.py resets and reads it)
launches = 0


def spline_eval_index_plain(geom, coeffs, u, rows_per_coeff=1):
    """Plain-torch spline evaluation (the kernel's oracle).

    geom : ops.spline.SplineGeometry (x0, step, log_step are read)
    coeffs : (C, 4, n-1) planes-first coefficients
    u : (C * rows_per_coeff, npix) fractional knot indices
    Returns (C * rows_per_coeff, npix) values; a query outside the
    knot range takes the clamped end interval's cubic, a NaN query
    gives NaN.
    """
    nm1 = coeffs.shape[-1]
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
    crow = torch.arange(u.shape[0], device=u.device) // rows_per_coeff
    cf = coeffs[crow[:, None], :, iidx]                   # (R, npix, 4)
    return (cf[..., 0] * dxl * dxl * dxl + cf[..., 1] * dxr * dxr * dxr
            + cf[..., 2] * dxl + cf[..., 3] * dxr)


@functools.lru_cache(maxsize=None)
def build():
    """Compile (first call) and bind the kernel's C launcher."""
    fn = cuda_build.load('spline_eval').rvst_spline_eval
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spline_eval_index(geom, coeffs, u, rows_per_coeff=1):
    """Kernel A on CUDA tensors, its plain version on CPU tensors.

    Same contract as :func:`spline_eval_index_plain`.  CUDA inputs must
    be contiguous float32 on one device.
    """
    if u.device.type == 'cpu':
        return spline_eval_index_plain(geom, coeffs, u, rows_per_coeff)
    global launches
    if u.device.type != 'cuda' or coeffs.device != u.device:
        raise ValueError(f'spline_eval: tensors on {u.device} / '
                         f'{coeffs.device}; need one CUDA device or CPU')
    if coeffs.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f'spline_eval: CUDA kernel takes float32, got '
                        f'{coeffs.dtype} / {u.dtype}')
    if coeffs.dim() != 3 or coeffs.shape[1] != 4 or u.dim() != 2 \
            or u.shape[0] != coeffs.shape[0] * rows_per_coeff:
        raise ValueError(f'spline_eval: bad shapes coeffs '
                         f'{tuple(coeffs.shape)}, u {tuple(u.shape)}, '
                         f'rows_per_coeff {rows_per_coeff}')
    if not (coeffs.is_contiguous() and u.is_contiguous()):
        raise ValueError('spline_eval: inputs must be contiguous')
    nm1 = coeffs.shape[-1]
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        err = build()(coeffs.data_ptr(), u.data_ptr(), out.data_ptr(),
                      u.shape[0], u.shape[1], nm1, rows_per_coeff,
                      int(geom.log_step), geom.x0, geom.step,
                      math.expm1(geom.step) if geom.log_step else 0.0,
                      cuda_build.current_stream(u))
    cuda_build.check_launch(err, 'spline_eval')
    launches += 1
    return out
