"""Kernel A's work (the Doppler spline evaluation, ops/spline_eval.py):
the least time an NVIDIA H100 SXM could take for one launch of
``rows`` query rows of ``npix`` points on coefficient rows of ``nm1``
intervals, ``rows_per_coeff`` query rows sharing one coefficient row,
whatever implements it.  The byte model of chip_smoke.py's
spline_bound_ms: the queries read and the values written once, and the
4 coefficients of every distinct interval that each coefficient row's
queries touch, at the HBM peak.

The distinct intervals depend on the query values, which a launch does
not report.  They are counted from the shapes: npix (at most nm1) a
coefficient row, the intervals of one query row whose pixels are no
finer than the template's knots (0.8-A pixels on knots of 0.4 A or less
in the DESI cells); the rows that share a coefficient row touch at
least as many.  A query row whose pixels clamp at the template's ends,
or lie finer than its knots, touches fewer: the cells' velocities stay
inside the templates' padding, and a CPU test checks the count against
the exact one on a cell's own grids."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchlib import peaks  # noqa: E402


def intervals(rows, npix, nm1, rows_per_coeff=1):
    """The distinct intervals counted for one launch."""
    return rows // rows_per_coeff * min(npix, nm1)


def bound_s(rows, npix, nm1, rows_per_coeff=1, form='float64'):
    """(seconds, 'bytes')."""
    es = 8 if form == 'float64' else 4
    nbytes = 2 * es * rows * npix + 4 * es * intervals(rows, npix, nm1,
                                                       rows_per_coeff)
    return nbytes / peaks.H100_SXM['hbm_bytes_per_s'], 'bytes'
