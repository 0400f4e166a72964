"""The port's FITS module against the reference's: a file written by
one reads back equal through the other, and the same HDU specs give
the same bytes from both."""
import os

import numpy as np
import pytest

from rvspecfit_tpu.io import fitsio as rfits
from rvspecfit_torch.io import fitsio as pfits

RNG = np.random.RandomState(5)
NROW = 7

IMAGES = {
    'u1': RNG.randint(0, 255, (3, 4)).astype('u1'),
    'i2': RNG.randint(-3000, 3000, (2, 5)).astype('i2'),
    'i4': RNG.randint(-2**30, 2**30, (6,)).astype('i4'),
    'i8': RNG.randint(-2**40, 2**40, (2, 3)).astype('i8'),
    'f4': RNG.normal(size=(3, 2, 4)).astype('f4'),
    'f8': RNG.normal(size=(5, 3)),
    'empty': None,
}

COLUMNS = {
    'L': RNG.rand(NROW) > 0.5,
    'B': RNG.randint(0, 255, NROW).astype('u1'),
    'I': RNG.randint(-3000, 3000, NROW).astype('i2'),
    'J': RNG.randint(-2**30, 2**30, NROW).astype('i4'),
    'K': RNG.randint(-2**60, 2**60, NROW).astype('i8'),
    'E': RNG.normal(size=NROW).astype('f4'),
    'D': RNG.normal(size=NROW),
    'unsigned': RNG.randint(0, 2**31, NROW).astype('u4'),
    'str': np.array(['TGT', 'SKY', '', 'a b', 'STAR', "q'x", 'Z'])[:NROW],
    'bytes': np.array([b'ab', b'c', b'', b'def', b'g', b'h', b'ij']),
    'array_E': RNG.normal(size=(NROW, 3)).astype('f4'),
    'array_K': RNG.randint(-9, 9, (NROW, 4)).astype('i8'),
    'array_L': RNG.rand(NROW, 2) > 0.5,
}

CARDS = {
    'bool': [('FLAG', True, 'a flag'), ('OFF', False, '')],
    'int': [('TILEID', 80605, 'tile'), ('BIG', -2**40, '')],
    'float': [('EXPTIME', 1234.5678, 's'), ('TINY', -3.25e-12, '')],
    'str': [('SPGRP', 'cumulative', 'group'), ('QUOTE', "it's", '')],
    'comment': [('COMMENT', 'a comment line', ''),
                ('HISTORY', 'made by a test', '')],
}


def _specs(kind, key):
    if kind == 'image':
        return [dict(kind='image', data=IMAGES[key],
                     header=[('SIMPLE2', 1, '')]),
                dict(kind='image', data=IMAGES['f4'], name='EXT')]
    if kind == 'table':
        return [dict(kind='image', data=None),
                dict(kind='table', name='TAB', data=[(key, COLUMNS[key])],
                     units={key: 'km/s'}, comments={key: 'a column'})]
    return [dict(kind='image', data=None, header=CARDS[key])]


def _assert_same(a, b):
    assert len(a) == len(b)
    for ha, hb in zip(a.hdus, b.hdus):
        assert ha.header.cards == hb.header.cards
        if isinstance(ha.data, dict):
            assert list(ha.data) == list(hb.data)
            for k in ha.data:
                assert ha.data[k].dtype == hb.data[k].dtype
                np.testing.assert_array_equal(ha.data[k], hb.data[k])
        elif ha.data is None:
            assert hb.data is None
        else:
            assert ha.data.dtype == hb.data.dtype
            np.testing.assert_array_equal(ha.data, hb.data)


CASES = ([('image', k) for k in IMAGES] + [('table', k) for k in COLUMNS]
         + [('header', k) for k in CARDS])


@pytest.mark.parametrize('kind,key', CASES)
def test_port_and_reference_write_the_same_bytes(tmp_path, kind, key):
    specs = _specs(kind, key)
    pf, rf = str(tmp_path / 'port.fits'), str(tmp_path / 'ref.fits')
    pfits.write(pf, specs)
    rfits.write(rf, specs)
    with open(pf, 'rb') as fa, open(rf, 'rb') as fb:
        assert fa.read() == fb.read()
    assert not os.path.exists(pf + '.tmp')
    # each reads what the other wrote, as the other reads it
    _assert_same(pfits.read(rf), rfits.read(rf))
    _assert_same(rfits.read(pf), pfits.read(pf))
    if kind == 'table':
        got = pfits.getdata(rf, 'TAB')[key]
        want = COLUMNS[key]
        if want.dtype.kind == 'S':
            want = np.char.decode(want, 'ascii')
        np.testing.assert_array_equal(got, want)
    if kind == 'header':
        hdr = pfits.getheader(rf)
        for k, v, _ in CARDS[key]:
            if k not in ('COMMENT', 'HISTORY'):
                assert hdr[k] == v
