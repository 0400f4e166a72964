"""Kernel B: fused CCF chi-square contributions of one arm.

Counterpart of rvspecfit_tpu/ops/pallas_ccf.py (the Pallas kernel) and
of fit/ccf._ccf_batch_cont / _ccf_batch_nocont (its plain semantics):

    c0[b,t,v] = sum_f Re(T[t,f] S[b,f]) Ecos[f,v] - Im(T S) Esin[f,v]
    c1[b,t,v] = the same with T2 and IV
    out = -2 c0 + c1            (continuum)
    out = -c0^2 / c1            (no continuum)

T, T2 : (T, F) complex template-bank rFFTs; S, IV : (B, F) complex
conjugated exposure spectrum/ivar rFFTs; Ecos, Esin : (F, V) real
DFT-at-lag matrices (fit/ccf._dft_mats).  Output (B, T, V).

On CPU tensors the wrapper runs :func:`ccf_chisq_plain`; on CUDA
tensors it launches ``csrc/ccf_chisq.cu`` or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rvspecfit_torch.ops import cuda_build

# kernel launches by this process (chip_smoke.py resets and reads it)
launches = 0

# complex elements of one (fibers, T, F) product tile of the plain
# version: bounds its intermediate (256 MB in complex64)
_PLAIN_TILE_ELEMS = 1 << 25


def _corr_at_lags(afft, bfft, ecos, esin):
    """(T, F) x (B, F) complex -> (B, T, V) correlations at the lags."""
    prod = afft[None, :, :] * bfft[:, None, :]
    return prod.real @ ecos - prod.imag @ esin


def ccf_chisq_plain(tfft, t2fft, sfft_conj, ivfft_conj, ecos, esin,
                    continuum=True):
    """Plain-torch CCF chi-square (the kernel's oracle), materializing
    the complex products one fiber tile at a time."""
    nt, nf = tfft.shape
    mb = max(1, _PLAIN_TILE_ELEMS // (nt * nf))
    outs = []
    for i0 in range(0, sfft_conj.shape[0], mb):
        c0 = _corr_at_lags(tfft, sfft_conj[i0:i0 + mb], ecos, esin)
        c1 = _corr_at_lags(t2fft, ivfft_conj[i0:i0 + mb], ecos, esin)
        outs.append(-2.0 * c0 + c1 if continuum else -(c0 * c0) / c1)
    return torch.cat(outs)


@functools.lru_cache(maxsize=None)
def build():
    """Compile (first call) and bind the kernel's C launcher."""
    fn = cuda_build.load('ccf_chisq').rvst_ccf_chisq
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ccf_chisq(tfft, t2fft, sfft_conj, ivfft_conj, ecos, esin,
              continuum=True):
    """Kernel B on CUDA tensors, its plain version on CPU tensors.

    CUDA inputs: contiguous complex64 (T, F), (T, F), (B, F), (B, F)
    and float32 (F, V), (F, V) on one device (no lazy-conjugate views).
    """
    if tfft.device.type == 'cpu':
        return ccf_chisq_plain(tfft, t2fft, sfft_conj, ivfft_conj, ecos,
                               esin, continuum)
    global launches
    cplx = (tfft, t2fft, sfft_conj, ivfft_conj)
    real = (ecos, esin)
    dev = tfft.device
    if dev.type != 'cuda' or any(x.device != dev for x in cplx + real):
        raise ValueError('ccf_chisq: inputs must share one CUDA device '
                         'or all lie on the CPU')
    if any(x.dtype != torch.complex64 for x in cplx) \
            or any(x.dtype != torch.float32 for x in real):
        raise TypeError('ccf_chisq: CUDA kernel takes complex64 FFTs and '
                        'float32 DFT matrices, got '
                        f'{[x.dtype for x in cplx + real]}')
    nt, nf = tfft.shape
    nb = sfft_conj.shape[0]
    nv = ecos.shape[1]
    if t2fft.shape != (nt, nf) or sfft_conj.shape != (nb, nf) \
            or ivfft_conj.shape != (nb, nf) or ecos.shape != (nf, nv) \
            or esin.shape != (nf, nv) or nb > 65535:
        raise ValueError('ccf_chisq: inconsistent shapes '
                         f'{[tuple(x.shape) for x in cplx + real]}')
    if not all(x.is_contiguous() and not x.is_conj()
               for x in cplx + real):
        raise ValueError('ccf_chisq: inputs must be contiguous and '
                         'physically conjugated')
    out = torch.empty((nb, nt, nv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build()(*(x.data_ptr() for x in cplx + real),
                      out.data_ptr(), nb, nt, nf, nv, int(continuum),
                      cuda_build.current_stream(tfft))
    cuda_build.check_launch(err, 'ccf_chisq')
    launches += 1
    return out
