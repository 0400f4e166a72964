"""Mark problematic templates 'bad' in the template database.

The port's own copy of rvspecfit_tpu/pipeline/mask_grid.py: templates
flagged bad are left out by every later stage (make_interpol selects
``where not bad``).  What to mask:

* ``--where`` — repeated SQL predicates over the parameter columns,
  e.g. ``--where '(alpha+0.4)<0.01 and teff<4500'``;
* ``--phoenix`` — the known-bad PHOENIX templates (cool alpha=-0.4
  stars plus a handful of individual grid points).

``--output`` copies the database and flags the copy; ``--unmask``
clears the flag instead of setting it.
"""
from __future__ import annotations

import argparse
import logging
import shutil
import sqlite3
import sys

# the known-bad PHOENIX templates (surveys/mask_phoenix_grid.sh:14-36)
PHOENIX_RULES = [
    '(alpha+0.4)<0.01 and teff<4500',
    'abs(teff-3100)<1 and abs(logg-3)<0.01 and abs(feh+.5)<0.01 '
    'and abs(alpha-1.2)<0.01',
    'abs(teff-3700)<1 and abs(logg-4)<0.01 and abs(feh-.5)<0.01 '
    'and abs(alpha-1.2)<0.01',
    'abs(teff-2500)<1 and abs(logg-3)<0.01 and abs(feh-1)<0.01 '
    'and abs(alpha-1.2)<0.01',
    'abs(teff-2900)<1 and abs(logg-1.5)<0.01 and abs(feh+1)<0.01 '
    'and abs(alpha-0.6)<0.01',
    'abs(teff-3000)<1 and abs(logg-2)<0.01 and abs(feh+.5)<0.01 '
    'and abs(alpha-0.6)<0.01',
    'abs(teff-3000)<1 and abs(logg-2.5)<0.01 and abs(feh-0)<0.01 '
    'and abs(alpha-0.6)<0.01',
]


def mask_templates(dbfile, predicates, output=None, unmask=False):
    """Apply masking predicates; returns the total bad count after.

    If ``output`` is given the input db is copied there first and the
    copy is modified."""
    if output is not None and output != dbfile:
        shutil.copy(dbfile, output)
        dbfile = output
    val = 0 if unmask else 1
    with sqlite3.connect(dbfile) as conn:
        for pred in predicates:
            cur = conn.execute(
                f'UPDATE files SET bad={val} WHERE {pred}')
            logging.info('predicate %r marked %d templates', pred,
                         cur.rowcount)
        conn.commit()
        nbad, ntot = conn.execute(
            'SELECT sum(bad), count(*) FROM files').fetchone()
    logging.info('%s: %d/%d templates flagged bad', dbfile, nbad or 0,
                 ntot)
    return int(nbad or 0)


def main(args=None):
    if args is None:
        args = sys.argv[1:]
    parser = argparse.ArgumentParser(
        description='Flag problematic templates as bad in the '
        'template sqlite database')
    parser.add_argument('--templdb', type=str, required=True,
                        help='Input sqlite database (files.db)')
    parser.add_argument('--output', type=str, default=None,
                        help='Write to a copy instead of in place')
    parser.add_argument('--where', action='append', default=[],
                        help='SQL predicate selecting templates to '
                        'mask (repeatable)')
    parser.add_argument('--phoenix', action='store_true', default=False,
                        help='Apply the built-in PHOENIX bad-template '
                        'preset')
    parser.add_argument('--unmask', action='store_true', default=False,
                        help='Clear instead of set the bad flag')
    args = parser.parse_args(args)
    logging.basicConfig(level=logging.INFO)
    preds = list(args.where)
    if args.phoenix:
        preds += PHOENIX_RULES
    if not preds:
        parser.error('nothing to do: give --where and/or --phoenix')
    mask_templates(args.templdb, preds, output=args.output,
                   unmask=args.unmask)


if __name__ == '__main__':
    main()
