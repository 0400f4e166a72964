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
in float64 on the FP64 tensor cores, in blocks of templates x fibers
that :func:`plan_f64` picks, on zero-padded layouts of the bank and
the DFT matrices (:func:`bank_operands`) that the wrapper builds on
its first launch on them and keeps while the bank lives.

On CPU tensors the wrapper runs :func:`ccf_chisq_plain`; on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from rvspecfit_torch import trace
from rvspecfit_torch.ops import cuda_build

# complex elements of one (fibers, T, F) product tile of the plain
# version: bounds its intermediate (512 MB in complex128)
_PLAIN_TILE_ELEMS = 1 << 25

# the float32 kernel's row blocks (gridDim.y <= 65535) and 32-bit offsets
_BLOCK_ROWS = 128
_INT32_MAX = 2**31 - 1
# the float64 kernel's tiling (csrc/ccf_chisq.cu, namespace f64):
# frequencies per stage, velocities per column block, rows per block
# with and without continuum; a slice takes at least F64_MIN_CHUNKS
# stages, and a cluster at most F64_MAX_CLUSTER slices (the portable
# size; the launcher refuses more)
F64_FREQ = 8
F64_COLS = 136
F64_ROWS = {True: 128, False: 64}
F64_MIN_CHUNKS = 4
F64_MAX_CLUSTER = 8


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


class F64Plan(NamedTuple):
    """How the float64 kernel covers (B, T, F, V): blocks of ``t_blk``
    templates x ``b_blk`` fibers x F64_COLS velocities, ``ncb`` x
    ``ntt`` x ``nbt`` of them, each over ``nchunks`` stages of F64_FREQ
    frequencies split into ``nslices`` slices, ``csize`` slices to a
    thread-block cluster."""
    t_blk: int
    b_blk: int
    ncb: int
    ntt: int
    nbt: int
    nchunks: int
    nslices: int
    csize: int

    @property
    def tiles(self):
        return self.ncb * self.ntt * self.nbt

    @property
    def nclusters(self):
        """Clusters per block: their sums go through a workspace where
        there is more than one."""
        return self.nslices // self.csize

    def slice_chunks(self, s):
        """Stages [begin, end) of slice ``s``, as the kernel splits them;
        slice s is rank s % csize of cluster s // csize, and the sums
        are added in that order."""
        return (s * self.nchunks // self.nslices,
                (s + 1) * self.nchunks // self.nslices)


@functools.lru_cache(maxsize=64)
def plan_f64(nb, nt, nf, nv, continuum, nsm):
    """The float64 kernel's blocks and slices on a card of ``nsm`` SMs.

    The block's template count is the power of two that pads (B, T) to
    the fewest rows, then the one with the fewest operand rows to copy.
    Where the blocks are fewer than the SMs, F is split into slices
    (balanced, none empty, each of at least F64_MIN_CHUNKS stages) so
    that one wave fills the card, in clusters of at most
    F64_MAX_CLUSTER."""
    rows = F64_ROWS[bool(continuum)]

    def cost(t):
        b = rows // t
        return -(-nt // t) * t * -(-nb // b) * b, t + b
    t_blk = min((1 << i for i in range(rows.bit_length())), key=cost)
    b_blk = rows // t_blk
    ncb, ntt, nbt = -(-nv // F64_COLS), -(-nt // t_blk), -(-nb // b_blk)
    nchunks = -(-nf // F64_FREQ)
    want = max(1, min(nsm // (ncb * ntt * nbt), nchunks // F64_MIN_CHUNKS))
    csize = min(F64_MAX_CLUSTER, want)
    return F64Plan(t_blk, b_blk, ncb, ntt, nbt, nchunks,
                   csize * (want // csize), csize)


def padded_freqs(nf):
    """F rounded up to whole stages of F64_FREQ frequencies."""
    return -(-nf // F64_FREQ) * F64_FREQ


def template_operand(tfft, t2fft, continuum=True):
    """The float64 kernel's bank operand: (Fp / F64_FREQ, T, 17)
    complex, per stage and template the stage's (-2 T, T2) with
    continuum (the factor is exact, and saves the kernel a multiply) or
    (T, T2) without, interleaved by frequency, then a zero (an odd
    stride keeps the kernel's shared loads free of bank conflicts); zeros
    past F.  A block's templates in a stage are one contiguous run."""
    nt, nf = tfft.shape
    fp = padded_freqs(nf)
    pair = tfft.new_zeros((nt, fp, 2))
    pair[:, :nf, 0] = -2.0 * tfft if continuum else tfft
    pair[:, :nf, 1] = t2fft
    out = tfft.new_zeros((fp // F64_FREQ, nt, 2 * F64_FREQ + 1))
    out[..., :-1] = pair.view(nt, fp // F64_FREQ, 2 * F64_FREQ).transpose(
        0, 1)
    return out


def exposure_operand(sfft_conj, ivfft_conj):
    """The float64 kernel's (Fp / F64_FREQ, B, 17) complex exposure
    operand: per stage and fiber the stage's S, then its IV, then a
    zero; zeros past F.  A block's fibers in a stage are one contiguous
    run, one bulk copy (laid out per call where the blocks fill the
    card; at few rows the kernel reads S and IV as they are)."""
    nb, nf = sfft_conj.shape
    nfull = nf // F64_FREQ
    out = sfft_conj.new_zeros((padded_freqs(nf) // F64_FREQ, nb,
                               2 * F64_FREQ + 1))
    parts = out[..., :-1].unflatten(-1, (2, F64_FREQ))
    for h, x in enumerate((sfft_conj, ivfft_conj)):
        parts[:nfull, :, h] = x[:, :nfull * F64_FREQ].view(
            nb, nfull, F64_FREQ).transpose(0, 1)
        if nf > nfull * F64_FREQ:
            parts[nfull, :, h, :nf - nfull * F64_FREQ] = \
                x[:, nfull * F64_FREQ:]
    return out


def dft_operand(ecos, esin):
    """The float64 kernel's (ceil(V / F64_COLS), Fp, F64_COLS + 2, 2)
    real operand: per column block of F64_COLS velocities and frequency
    (Ecos, Esin), two zero columns of padding (the kernel's shared row
    stride), zeros past F and V.  A stage of a column block is one
    contiguous run."""
    nf, nv = ecos.shape
    ncb = -(-nv // F64_COLS)
    pair = ecos.new_zeros((padded_freqs(nf), ncb * F64_COLS, 2))
    pair[:nf, :nv, 0] = ecos
    pair[:nf, :nv, 1] = esin
    out = ecos.new_zeros((ncb, pair.shape[0], F64_COLS + 2, 2))
    out[:, :, :F64_COLS] = pair.view(pair.shape[0], ncb, F64_COLS,
                                     2).transpose(0, 1)
    return out


# the float64 kernel's bank operands by id of the bank's tfft: (the
# t2fft, ecos and esin they were built from, the four inputs' versions
# and the mode, (tt2, e), and on the card the stream they were built on
# and an event recorded after the build); dropped when that tfft is
# freed
_bank_cache = {}


def bank_operands(tfft, t2fft, ecos, esin, continuum=True):
    """(:func:`template_operand`, :func:`dft_operand`) of a bank and its
    DFT matrices: built on the first call and kept while ``tfft``
    lives; built anew for other ``t2fft``, ``ecos`` or ``esin`` tensors,
    for the other mode and after any of the four was written to.

    On the card the operands are built on the calling thread's current
    stream; a later call on another stream (another thread's) waits for
    the build's event and marks the operands as used by its stream, so
    that the caching allocator does not hand their memory out while that
    stream may still read them.  A CUDA graph captures no such wait: its
    capture starts after the device is synchronized, so operands built
    before are complete, and operands built during a capture are its
    own nodes."""
    key = (tfft._version, t2fft._version, ecos._version, esin._version,
           bool(continuum))
    hit = _bank_cache.get(id(tfft))
    if hit is not None and hit[1] == key and all(
            a is b for a, b in zip(hit[0], (t2fft, ecos, esin))):
        ops, built_on, event = hit[2:]
        if event is not None and not torch.cuda.is_current_stream_capturing():
            stream = torch.cuda.current_stream(tfft.device)
            if stream != built_on:
                stream.wait_event(event)
                for t in ops:
                    t.record_stream(stream)
        return ops
    if hit is None:
        weakref.finalize(tfft, _bank_cache.pop, id(tfft), None)
    ops = (template_operand(tfft, t2fft, continuum), dft_operand(ecos, esin))
    built_on = event = None
    if tfft.device.type == 'cuda' and \
            not torch.cuda.is_current_stream_capturing():
        built_on = torch.cuda.current_stream(tfft.device)
        event = torch.cuda.Event()
        event.record(built_on)
    _bank_cache[id(tfft)] = ((t2fft, ecos, esin), key, ops, built_on, event)
    return ops


# rvst_ccf_chisq(tt2, siv, e_quads, out, nb, nt, nf, nv, continuum, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# rvst_ccf_chisq_f64(tt2, sfft, ivfft, siv, e, out, ws, nb, nt, nf, nv,
# continuum, tlog, nslices, csize, stream)
ARGTYPES_F64 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
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


def launch_f64(fn, args, continuum, out):
    """Launch the float64 C launcher ``fn`` (this source's, or another
    build of it) on the six CUDA inputs into ``out``, with the bank's
    operands (:func:`bank_operands`); returns its cudaError_t."""
    tfft, t2fft, sfft_conj, ivfft_conj, ecos, esin = args
    nt, nf = tfft.shape
    nb, nv = sfft_conj.shape[0], ecos.shape[1]
    tt2, e = bank_operands(tfft, t2fft, ecos, esin, continuum)
    plan = plan_f64(nb, nt, nf, nv, bool(continuum), _sm_count(tfft.device))
    if plan.tiles > _INT32_MAX:
        raise ValueError(f'ccf_chisq: B, T, F, V = {nb}, {nt}, {nf}, {nv} '
                         'exceed the kernel\'s grid')
    ws = None if plan.nclusters == 1 else torch.empty(
        plan.nclusters * (1 if continuum else 2) * nb * nt * nv,
        dtype=torch.float64, device=tfft.device)
    # one bulk copy a stage for the block's fibers where the blocks fill
    # the card; at few rows each warp copies its fibers' S and IV itself
    siv = exposure_operand(sfft_conj, ivfft_conj) if plan.nslices == 1 \
        else None
    ptr = lambda x: None if x is None else x.data_ptr()
    return fn(tt2.data_ptr(), sfft_conj.data_ptr(), ivfft_conj.data_ptr(),
              ptr(siv), e.data_ptr(), out.data_ptr(), ptr(ws), nb, nt, nf,
              nv, int(continuum), plan.t_blk.bit_length() - 1,
              plan.nslices, plan.csize, cuda_build.current_stream(tfft))


def ccf_chisq(tfft, t2fft, sfft_conj, ivfft_conj, ecos, esin,
              continuum=True):
    """Kernel B on CUDA tensors, its plain version on CPU tensors.

    CUDA inputs: contiguous complex (T, F), (T, F), (B, F), (B, F) and
    real (F, V), (F, V) on one device (no lazy-conjugate views), all
    complex128 / float64 (the float64 kernel) or all complex64 / float32
    (the 3xTF32 kernel).  A launch adds to the counter
    ``kernel_b.<form>`` (:mod:`rvspecfit_torch.trace`).
    """
    if tfft.device.type == 'cpu':
        return ccf_chisq_plain(tfft, t2fft, sfft_conj, ivfft_conj, ecos,
                               esin, continuum)
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
    if cdt == torch.complex64 and (
            -(-nb * nt // _BLOCK_ROWS) > 65535
            or 2 * max(nb, nt) * nf > _INT32_MAX or nf * nv > _INT32_MAX):
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
            err = launch_f64(build(torch.float64), cplx + real, continuum,
                             out)
    cuda_build.check_launch(err, 'ccf_chisq')
    trace.count('kernel_b.float32' if cdt == torch.complex64
                else 'kernel_b.float64')
    return out
