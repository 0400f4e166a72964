"""Kernel B's work (the CCF product-contraction, ops/ccf_chisq.py): the
least time an NVIDIA H100 SXM could take for one call at B fibres, T
bank templates, F frequencies and V velocities, whatever implements
it.  The contraction is a GEMM of M = B T, N = V, K = 2F per
accumulator (one with the continuum, two without), issued once at the
FP64 tensor-core peak in the float64 form and three times at the TF32
peak in the float32 form (3xTF32), against the bytes of its inputs and
output read or written once.  A copy of chip_smoke.py's ccf_bound."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchlib import peaks  # noqa: E402


def bound_s(nb, nt, nf, nv, form='float64', continuum=True):
    """(seconds, 'operations' or 'bytes')."""
    nacc = 1 if continuum else 2
    es = 8 if form == 'float64' else 4
    passes, peak = ((1, peaks.H100_SXM['fp64_tensor_flops'])
                    if form == 'float64'
                    else (3, peaks.H100_SXM['tf32_tensor_flops']))
    flops = passes * nacc * 2.0 * nb * nt * nv * 2 * nf
    nbytes = es * (2 * 2 * (nt + nb) * nf + 2 * nf * nv + nb * nt * nv)
    t_ops = flops / peak
    t_bytes = nbytes / peaks.H100_SXM['hbm_bytes_per_s']
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')
