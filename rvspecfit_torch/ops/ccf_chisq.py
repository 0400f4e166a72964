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

The kernel (``csrc/ccf_chisq.cu``) computes this as one GEMM over
flattened (fiber, template) rows, :func:`contraction_operands` in
plain torch, on tensor cores: for complex64 inputs in 3xTF32
(:func:`tf32_split`), for complex128 inputs (the card's working type)
in float64 on the FP64 tensor cores, split over F into
:func:`f64_splits` slices where there are few rows.

On CPU tensors the wrapper runs :func:`ccf_chisq_plain`; on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rvspecfit_torch.ops import cuda_build

# kernel launches by this process, in either form and in the float32
# (3xTF32) form alone (chip_smoke.py resets and reads them)
launches = 0
float32_launches = 0

# complex elements of one (fibers, T, F) product tile of the plain
# version: bounds its intermediate (512 MB in complex128)
_PLAIN_TILE_ELEMS = 1 << 25

# the kernels' row blocks (gridDim.y <= 65535) and 32-bit offsets
_BLOCK_ROWS = {torch.complex64: 128, torch.complex128: 64}
_INT32_MAX = 2**31 - 1
# the float64 kernel's tiling (csrc/ccf_chisq.cu, namespace f64):
# velocities per column block with and without continuum, frequencies
# per K chunk
_F64_BN = {True: 224, False: 96}
_F64_FREQ = 8


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


def contraction_operands(tfft, t2fft, sfft_conj, ivfft_conj, ecos, esin,
                         continuum=True):
    """The kernel's GEMM form of the same function, in plain torch.

    Returns (A list, E): rows of A are the flattened (fiber, template)
    pairs, its columns [Re X(f) | -Im X(f)], and E = [Ecos; Esin]
    (2F, V), so that A @ E = sum_f Re X Ecos - Im X Esin.  With
    continuum A = [R] with R = -2 T S + T2 IV and the output is
    (A @ E); without, A = [P, Q] with P = T S, Q = T2 IV, c0 = P @ E,
    c1 = Q @ E and the output is -c0^2 / c1.  Materializes (B T, 2F):
    for tests at small shapes."""
    nf = tfft.shape[1]
    p = tfft[None] * sfft_conj[:, None]
    q = t2fft[None] * ivfft_conj[:, None]
    rows = lambda x: torch.cat([x.real, -x.imag], -1).reshape(-1, 2 * nf)
    ops = [rows(-2.0 * p + q)] if continuum else [rows(p), rows(q)]
    return ops, torch.cat([ecos, esin])


def tf32_split(x):
    """(hi, lo) of a float32 tensor as the kernel splits its operands:
    hi = x rounded to TF32 (the low 13 mantissa bits to nearest, ties
    away from zero, as cvt.rna.tf32.f32), lo = the same rounding of
    x - hi (exact in float32)."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x.to(torch.float32).contiguous())
    return hi, rna(x - hi)


def kernel_operands(tfft, t2fft, sfft_conj, ivfft_conj, ecos, esin):
    """The kernel's operand layouts, interleaved for 16-byte copies:
    (T, F, 2) complex (T, T2), (B, F, 2) complex (S, IV), and the B
    operand split once per call into (F, V, 4) float32 (Ecos hi,
    Ecos lo, Esin hi, Esin lo) by :func:`tf32_split`."""
    return (torch.stack([tfft, t2fft], -1),
            torch.stack([sfft_conj, ivfft_conj], -1),
            torch.stack(tf32_split(ecos) + tf32_split(esin), -1))


def kernel_operands_f64(tfft, t2fft, sfft_conj, ivfft_conj, ecos, esin):
    """The float64 kernel's operand layouts: (T, F, 2) complex (T, T2),
    (B, F, 2) complex (S, IV) and (F, V, 2) real (Ecos, Esin)."""
    return (torch.stack([tfft, t2fft], -1),
            torch.stack([sfft_conj, ivfft_conj], -1),
            torch.stack([ecos, esin], -1))


def f64_splits(nb, nt, nf, nv, continuum, nsm):
    """Slices of F the float64 kernel takes on a card of ``nsm`` SMs:
    enough (fiber, template, velocity) blocks for two waves of one
    block an SM, with at least 4 chunks of 8 frequencies a slice, and
    no empty slice (1 where the rows alone fill the card)."""
    blocks = -(-nv // _F64_BN[bool(continuum)]) \
        * -(-nb * nt // _BLOCK_ROWS[torch.complex128])
    nchunks = -(-nf // _F64_FREQ)
    nsplit = max(1, min(-(-2 * nsm // max(blocks, 1)), nchunks // 4))
    per = -(-nchunks // nsplit)
    return max(1, -(-nchunks // per))


# rvst_ccf_chisq(tt2, siv, e_quads, out, nb, nt, nf, nv, continuum, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# rvst_ccf_chisq_f64(tt2, siv, e, out, ws, nb, nt, nf, nv, continuum,
# nsplit, stream)
ARGTYPES_F64 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def build(dtype=torch.float32):
    """Compile (first call) and bind the C launcher of the kernel's
    ``dtype`` form (float32: 3xTF32, float64)."""
    lib = cuda_build.load('ccf_chisq')
    if dtype == torch.float64:
        fn, fn.argtypes = lib.rvst_ccf_chisq_f64, ARGTYPES_F64
    else:
        fn, fn.argtypes = lib.rvst_ccf_chisq, ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def ccf_chisq(tfft, t2fft, sfft_conj, ivfft_conj, ecos, esin,
              continuum=True):
    """Kernel B on CUDA tensors, its plain version on CPU tensors.

    CUDA inputs: contiguous complex (T, F), (T, F), (B, F), (B, F) and
    real (F, V), (F, V) on one device (no lazy-conjugate views), all
    complex128 / float64 (the float64 kernel) or all complex64 / float32
    (the 3xTF32 kernel).
    """
    if tfft.device.type == 'cpu':
        return ccf_chisq_plain(tfft, t2fft, sfft_conj, ivfft_conj, ecos,
                               esin, continuum)
    global launches, float32_launches
    cplx = (tfft, t2fft, sfft_conj, ivfft_conj)
    real = (ecos, esin)
    dev = tfft.device
    if dev.type != 'cuda' or any(x.device != dev for x in cplx + real):
        raise ValueError('ccf_chisq: inputs must share one CUDA device '
                         'or all lie on the CPU')
    cdt = tfft.dtype
    rdt = {torch.complex64: torch.float32,
           torch.complex128: torch.float64}.get(cdt)
    if rdt is None or any(x.dtype != cdt for x in cplx) \
            or any(x.dtype != rdt for x in real):
        raise TypeError('ccf_chisq: CUDA kernel takes complex128 FFTs and '
                        'float64 DFT matrices, or complex64 and float32, '
                        f'got {[x.dtype for x in cplx + real]}')
    nt, nf = tfft.shape
    nb = sfft_conj.shape[0]
    nv = ecos.shape[1]
    if t2fft.shape != (nt, nf) or sfft_conj.shape != (nb, nf) \
            or ivfft_conj.shape != (nb, nf) or ecos.shape != (nf, nv) \
            or esin.shape != (nf, nv):
        raise ValueError('ccf_chisq: inconsistent shapes '
                         f'{[tuple(x.shape) for x in cplx + real]}')
    if -(-nb * nt // _BLOCK_ROWS[cdt]) > 65535 \
            or 2 * max(nb, nt) * nf > _INT32_MAX or nf * nv > _INT32_MAX:
        raise ValueError(f'ccf_chisq: B, T, F, V = {nb}, {nt}, {nf}, {nv} '
                         'exceed the kernel\'s grid or 32-bit offsets')
    if not all(x.is_contiguous() and not x.is_conj()
               for x in cplx + real):
        raise ValueError('ccf_chisq: inputs must be contiguous and '
                         'physically conjugated')
    out = torch.empty((nb, nt, nv), dtype=rdt, device=dev)
    stream = cuda_build.current_stream(tfft)
    with torch.cuda.device(dev):
        if cdt == torch.complex64:
            tt2, siv, e_quads = kernel_operands(*cplx, *real)
            err = build()(tt2.data_ptr(), siv.data_ptr(), e_quads.data_ptr(),
                          out.data_ptr(), nb, nt, nf, nv, int(continuum),
                          stream)
        else:
            tt2, siv, e = kernel_operands_f64(*cplx, *real)
            nsplit = f64_splits(nb, nt, nf, nv, continuum, _sm_count(dev))
            ws = None if nsplit == 1 else torch.empty(
                nsplit * (1 if continuum else 2) * nb * nt * nv,
                dtype=torch.float64, device=dev)
            err = build(torch.float64)(
                tt2.data_ptr(), siv.data_ptr(), e.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), nb, nt, nf, nv,
                int(continuum), nsplit, stream)
    cuda_build.check_launch(err, 'ccf_chisq')
    launches += 1
    if cdt == torch.complex64:
        float32_launches += 1
    return out
