"""Regularize an irregular template grid (offline, host).

The port's own copy of rvspecfit_tpu/pipeline/regularize_grid.py: fill
holes and refine the [Fe/H], [alpha/Fe] sampling of an irregular grid
by RBF (multiquadric, epsilon 1) interpolation of spectra inside
overlapping windows of neighbouring teff ranks, producing a new
specs_{setup}.h5 whose (teff, logg) x (feh, alpha) sampling is a
filled regular product, ready for ``rvstorch_make_nd --regulargrid``
and the card's regular-grid interpolator.  Reading and writing the
files needs ``h5py``.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import scipy.interpolate

from rvspecfit_torch import serializer


def find_best_overlaps(n, width):
    """Split [0, n) into maximally-overlapping windows of ``width``
    stepping by width//2."""
    if n <= width:
        return [(0, n)]
    step = max(width // 2, 1)
    out = []
    start = 0
    while True:
        stop = min(start + width, n)
        out.append((start, stop))
        if stop == n:
            break
        start = min(start + step, n - width)
    return out


def check_holes_2d(vec2d, new_grid):
    """Warn when requested new grid points lie far outside the convex
    hull of the original (feh, alpha) points."""
    import scipy.spatial
    try:
        hull = scipy.spatial.ConvexHull(vec2d)
    except Exception:
        return
    eqs = hull.equations
    d = (new_grid @ eqs[:, :2].T + eqs[:, 2][None, :]).max(axis=1)
    nout = int((d > 1e-9).sum())
    if nout:
        logging.warning('%d requested grid points are outside the '
                        'original (feh, alpha) hull', nout)


def converter(input_h5, output_h5, new_fehs, new_alphas, window=12,
              rbf_neighbors=None):
    """Resample the library onto a dense (feh, alpha) grid at every
    observed (teff, logg) pair, from ``input_h5`` to ``output_h5``.
    """
    d = serializer.load_dict_from_hdf5(input_h5)
    vec = np.asarray(d['vec'], dtype=np.float64)   # (ndim, nspec)
    specs = np.asarray(d['specs'])
    parnames = [str(p) for p in d['parnames']]
    ite = parnames.index('teff')
    ilg = parnames.index('logg')
    ife = parnames.index('feh')
    ial = parnames.index('alpha')

    # rank-space mapping per dimension stabilizes the RBF distances
    def rank_map(x):
        u = np.unique(x)
        return np.interp(x, u, np.arange(len(u)), left=0,
                         right=len(u) - 1), u

    tr, tu = rank_map(vec[ite])
    new_grid = np.array([[f, a] for f in new_fehs for a in new_alphas])
    check_holes_2d(vec[[ife, ial]].T, new_grid)

    teff_ranks = np.unique(tr)
    windows = find_best_overlaps(len(teff_ranks), window)
    counts = np.zeros(0)
    new_vecs = []
    new_specs = []
    done_pairs = set()
    for (w0, w1) in windows:
        sel = (tr >= teff_ranks[w0]) & (tr <= teff_ranks[w1 - 1])
        if sel.sum() < 5:
            continue
        sub_vec = vec[:, sel]
        sub_specs = specs[sel]
        # per (teff, logg) pair in the CENTRAL part of the window
        central = teff_ranks[w0 + (0 if w0 == 0 else window // 4):
                             w1 - (0 if w1 == len(teff_ranks) else
                                   window // 4)]
        pts = np.column_stack([
            (sub_vec[ite] - sub_vec[ite].mean()) / max(
                sub_vec[ite].std(), 1e-9),
            (sub_vec[ilg] - sub_vec[ilg].mean()) / max(
                sub_vec[ilg].std(), 1e-9),
            (sub_vec[ife] - sub_vec[ife].mean()) / max(
                sub_vec[ife].std(), 1e-9),
            (sub_vec[ial] - sub_vec[ial].mean()) / max(
                sub_vec[ial].std(), 1e-9)])
        rbf = scipy.interpolate.RBFInterpolator(
            pts, sub_specs, kernel='multiquadric', epsilon=1.0,
            neighbors=rbf_neighbors)
        uniq_tl = {(t, g) for t, g in zip(sub_vec[ite], sub_vec[ilg])
                   if t in central or len(windows) == 1}
        for (t, g) in sorted(uniq_tl):
            if (t, g) in done_pairs:
                continue
            done_pairs.add((t, g))
            q = np.column_stack([
                np.full(len(new_grid), t), np.full(len(new_grid), g),
                new_grid[:, 0], new_grid[:, 1]])
            qn = (q - np.array([sub_vec[ite].mean(), sub_vec[ilg].mean(),
                                sub_vec[ife].mean(),
                                sub_vec[ial].mean()])) / \
                np.array([max(sub_vec[ite].std(), 1e-9),
                          max(sub_vec[ilg].std(), 1e-9),
                          max(sub_vec[ife].std(), 1e-9),
                          max(sub_vec[ial].std(), 1e-9)])
            pred = rbf(qn)
            new_specs.append(pred)
            for row in q:
                new_vecs.append(row)
    new_specs = np.vstack(new_specs).astype(specs.dtype)
    new_vec = np.array(new_vecs, dtype=np.float64).T
    # reorder columns to the parnames order of the input
    order = [ite, ilg, ife, ial]
    full_vec = np.zeros((vec.shape[0], new_vec.shape[1]))
    for out_i, in_i in enumerate(order):
        full_vec[in_i] = new_vec[out_i]

    out = dict(d)
    out['vec'] = full_vec
    out['specs'] = new_specs
    out['lognorms'] = np.zeros(new_specs.shape[0])
    out['file_ids'] = np.arange(new_specs.shape[0])
    serializer.save_dict_to_hdf5(output_h5, out)
    logging.info('regularized grid: %d -> %d templates',
                 specs.shape[0], new_specs.shape[0])


def main(args=None):
    if args is None:
        args = sys.argv[1:]
    parser = argparse.ArgumentParser(
        description='Fill holes / refine feh-alpha sampling of an '
        'irregular grid by windowed RBF interpolation')
    parser.add_argument('--input', type=str, required=True,
                        help='input specs_{setup}.h5')
    parser.add_argument('--output', type=str, required=True,
                        help='output specs_{setup}.h5')
    parser.add_argument('--fehs', type=str, default=None,
                        help='comma-separated new feh grid (overrides '
                        'the min/max/step form)')
    parser.add_argument('--alphas', type=str, default=None,
                        help='comma-separated new alpha grid (overrides '
                        'the min/max/step form)')
    # the range form, with the reference CLI's defaults
    parser.add_argument('--min_feh', type=float, default=-4.0)
    parser.add_argument('--max_feh', type=float, default=1.2)
    parser.add_argument('--step_feh', type=float, default=0.25)
    parser.add_argument('--min_alpha', type=float, default=-0.4)
    parser.add_argument('--max_alpha', type=float, default=1.2)
    parser.add_argument('--step_alpha', type=float, default=0.2)
    parser.add_argument('--window', type=int, default=12)
    args = parser.parse_args(args)
    if args.fehs is not None:
        fehs = [float(x) for x in args.fehs.split(',')]
    else:
        fehs = np.arange(args.min_feh,
                         args.max_feh + args.step_feh / 2,
                         args.step_feh).tolist()
    if args.alphas is not None:
        alphas = [float(x) for x in args.alphas.split(',')]
    else:
        alphas = np.arange(args.min_alpha,
                           args.max_alpha + args.step_alpha / 2,
                           args.step_alpha).tolist()
    converter(args.input, args.output, fehs, alphas,
              window=args.window)


if __name__ == '__main__':
    main()
