"""Kernel A's adjoint's work (ops/spline_eval.spline_eval_index_vjp):
the least time an NVIDIA H100 SXM could take for one launch of ``rows``
rows of ``npix`` queries and upstream gradients into the dense (rows,
4, nm1) coefficient gradient, whatever implements it.  The byte model
of chip_smoke.py's adjoint_bound_ms: the queries and gradients read
once and the output written once, at the HBM peak."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchlib import peaks  # noqa: E402


def bound_s(rows, npix, nm1, form='float64'):
    """(seconds, 'bytes')."""
    es = 8 if form == 'float64' else 4
    nbytes = 2 * es * rows * npix + 4 * es * rows * nm1
    return nbytes / peaks.H100_SXM['hbm_bytes_per_s'], 'bytes'
