"""Minimal FITS reader/writer (numpy only, no astropy).

A copy of rvspecfit_tpu/io/fitsio.py, so that the port reads coadd
files and writes RVTAB/RVMOD without importing the JAX package; for
the same HDU specs it writes the same bytes.  It implements the subset
of the standard the DESI driver needs:

* primary and IMAGE extension HDUs with integer/float data;
* BINTABLE extensions with logical/byte/int/float/double/string and
  fixed-length-array columns;
* header cards: strings, booleans, integers, floats, COMMENT/HISTORY;
* EXTNAME lookup, atomic writes (tmp + rename).

Numbers are stored big-endian per the standard; arrays are converted
to native order on read.
"""
from __future__ import annotations

import os

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_TO_DTYPE = {8: '>u1', 16: '>i2', 32: '>i4', 64: '>i8',
                    -32: '>f4', -64: '>f8'}
_DTYPE_TO_BITPIX = {'u1': 8, 'i2': 16, 'i4': 32, 'i8': 64,
                    'f4': -32, 'f8': -64}

_TFORM_TO_DTYPE = {'L': '>u1', 'B': '>u1', 'I': '>i2', 'J': '>i4',
                   'K': '>i8', 'E': '>f4', 'D': '>f8'}
_KIND_TO_TFORM = {('i', 2): 'I', ('i', 4): 'J', ('i', 8): 'K',
                  ('u', 1): 'B', ('f', 4): 'E', ('f', 8): 'D',
                  ('b', 1): 'L'}


class Header:
    """Ordered FITS header: mapping access plus comments."""

    def __init__(self, cards=None):
        self.cards = list(cards or [])   # (key, value, comment)

    def get(self, key, default=None):
        for k, v, _ in self.cards:
            if k == key:
                return v
        return default

    def __getitem__(self, key):
        val = self.get(key, _MISSING)
        if val is _MISSING:
            raise KeyError(key)
        return val

    def __setitem__(self, key, value):
        for i, (k, _, c) in enumerate(self.cards):
            if k == key:
                self.cards[i] = (key, value, c)
                return
        self.cards.append((key, value, ''))

    def __contains__(self, key):
        return self.get(key, _MISSING) is not _MISSING

    def keys(self):
        return [k for k, _, _ in self.cards]

    def items(self):
        return [(k, v) for k, v, _ in self.cards]


_MISSING = object()


class HDU:
    def __init__(self, data=None, header=None, name=None):
        self.data = data
        self.header = header if header is not None else Header()
        if name:
            self.header['EXTNAME'] = name

    @property
    def name(self):
        return self.header.get('EXTNAME', '')


class FITSFile:
    def __init__(self, hdus):
        self.hdus = list(hdus)

    def __len__(self):
        return len(self.hdus)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.hdus[key]
        key = str(key).upper()
        for h in self.hdus:
            if str(h.name).upper() == key:
                return h
        raise KeyError(f'No HDU named {key!r}')

    def __contains__(self, key):
        try:
            self[key]
            return True
        except KeyError:
            return False

    def names(self):
        return [h.name for h in self.hdus]


# ----------------------------- parsing -----------------------------

def _parse_value(raw):
    s = raw.strip()
    if not s:
        return None
    if s.startswith("'"):
        # FITS string: '' escapes a quote
        out = []
        i = 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        return ''.join(out).rstrip()
    if s == 'T':
        return True
    if s == 'F':
        return False
    try:
        if any(c in s for c in '.eEdD') and not s.lstrip('+-').isdigit():
            return float(s.replace('D', 'E').replace('d', 'e'))
        return int(s)
    except ValueError:
        return s


def _read_header(fp):
    cards = []
    while True:
        block = fp.read(BLOCK)
        if len(block) < BLOCK:
            if not cards:
                return None
            raise IOError('Truncated FITS header')
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode('ascii', 'replace')
            key = card[:8].strip()
            if key == 'END':
                done = True
                break
            if key in ('COMMENT', 'HISTORY', ''):
                cards.append((key, card[8:].rstrip(), ''))
                continue
            if card[8:10] != '= ':
                cards.append((key, card[8:].rstrip(), ''))
                continue
            rest = card[10:]
            # split off inline comment (avoiding quotes)
            comment = ''
            if rest.lstrip().startswith("'"):
                q = rest.find("'")
                j = q + 1
                while j < len(rest):
                    if rest[j] == "'":
                        if j + 1 < len(rest) and rest[j + 1] == "'":
                            j += 2
                            continue
                        break
                    j += 1
                valpart = rest[:j + 1]
                tail = rest[j + 1:]
                if '/' in tail:
                    comment = tail.split('/', 1)[1].strip()
            else:
                if '/' in rest:
                    valpart, comment = rest.split('/', 1)
                    comment = comment.strip()
                else:
                    valpart = rest
            cards.append((key, _parse_value(valpart), comment))
        if done:
            break
    return Header(cards)


# FITS stores only signed integers; unsigned types use the TZERO /
# BZERO offset convention (TSCAL/BSCALE 1, offset 2^(bits-1)), and
# signed bytes use offset -128.  Adding the offset equals flipping the
# sign bit, so the exact conversion is a view + XOR — no overflow, no
# float round-trip (the reference relies on astropy for this).
_UNSIGNED_OFFSETS = {
    'I': (1 << 15, np.uint16), 'J': (1 << 31, np.uint32),
    'K': (1 << 63, np.uint64),
}


def _apply_scaling(col, code, tscal, tzero):
    """Apply TSCAL/TZERO to a native-order integer/float column."""
    if tscal == 1 and tzero == 0:
        return col
    if tscal == 1 and code in _UNSIGNED_OFFSETS and \
            tzero == _UNSIGNED_OFFSETS[code][0]:
        off, udt = _UNSIGNED_OFFSETS[code]
        return col.view(udt) ^ udt(off)
    if tscal == 1 and code == 'B' and tzero == -128:
        return (col.view(np.uint8) ^ np.uint8(0x80)).view(np.int8).copy()
    return col * float(tscal) + float(tzero)


def _read_data(fp, header):
    naxis = int(header.get('NAXIS', 0))
    xt = str(header.get('XTENSION', '')).strip().upper()
    if naxis == 0:
        return None
    shape = [int(header[f'NAXIS{i}']) for i in range(1, naxis + 1)]
    if xt == 'BINTABLE':
        nbytes_row, nrows = shape
        tfields = int(header['TFIELDS'])
        names, dtypes = [], []
        for i in range(1, tfields + 1):
            name = str(header.get(f'TTYPE{i}', f'col{i}')).strip()
            tform = str(header[f'TFORM{i}']).strip()
            rep = ''
            j = 0
            while j < len(tform) and tform[j].isdigit():
                rep += tform[j]
                j += 1
            code = tform[j]
            rep = int(rep) if rep else 1
            if code == 'A':
                dt = f'S{rep}'
                names.append(name)
                dtypes.append((name, dt))
            else:
                base = _TFORM_TO_DTYPE[code]
                names.append(name)
                if rep == 1:
                    dtypes.append((name, base))
                else:
                    dtypes.append((name, base, (rep,)))
        rec_dt = np.dtype(dtypes)
        if rec_dt.itemsize != nbytes_row:
            raise IOError(f'BINTABLE row size mismatch: dtype '
                          f'{rec_dt.itemsize} vs NAXIS1 {nbytes_row}')
        # fromfile reads straight into the record array (no transient
        # bytes copy): peak memory stays ~1x the HDU size plus one
        # column during conversion; real coadds reach GBs
        data = np.fromfile(fp, dtype=rec_dt, count=nrows)
        if len(data) < nrows:
            raise IOError('Truncated FITS table data')
        pcount = int(header.get('PCOUNT', 0))
        pad = (-(nbytes_row * nrows + pcount)) % BLOCK
        fp.seek(pcount + pad, 1)
        # convert logicals ('T'/'F' bytes), byte order, and TSCAL/TZERO
        # column scaling (real survey products store unsigned ints via
        # the TZERO convention; the reference gets this from astropy)
        out = {}
        for i in range(1, tfields + 1):
            name = str(header.get(f'TTYPE{i}', f'col{i}')).strip()
            tform = str(header[f'TFORM{i}']).strip()
            code = tform.lstrip('0123456789')[0]
            col = data[name]
            if code == 'L':
                col = (col == ord('T'))
            elif code == 'A':
                col = np.char.decode(col.astype('S'), 'ascii')
                col = np.char.rstrip(col)
            else:
                col = col.astype(col.dtype.newbyteorder('='))
                col = _apply_scaling(col, code,
                                     header.get(f'TSCAL{i}', 1),
                                     header.get(f'TZERO{i}', 0))
            out[name] = col
        return out

    # image: fromfile avoids a transient bytes copy (memory stays ~1x
    # the HDU size even for GB-scale coadd arrays)
    bitpix = int(header['BITPIX'])
    dt = np.dtype(_BITPIX_TO_DTYPE[bitpix])
    count = int(np.prod(shape))
    arr = np.fromfile(fp, dtype=dt, count=count)
    if arr.size < count:
        raise IOError('Truncated FITS data')
    arr = arr.reshape(shape[::-1])
    fp.seek((-count * dt.itemsize) % BLOCK, 1)
    arr = arr.astype(arr.dtype.newbyteorder('='))
    bscale = header.get('BSCALE', 1)
    bzero = header.get('BZERO', 0)
    if bscale != 1 or bzero != 0:
        code = {16: 'I', 32: 'J', 64: 'K', 8: 'B'}.get(bitpix)
        arr = _apply_scaling(arr, code, bscale, bzero)
    return arr


def read(filename):
    """Read all HDUs of a FITS file."""
    hdus = []
    with open(filename, 'rb') as fp:
        while True:
            header = _read_header(fp)
            if header is None:
                break
            data = _read_data(fp, header)
            hdus.append(HDU(data=data, header=header))
    if not hdus:
        raise IOError(f'{filename}: not a FITS file')
    return FITSFile(hdus)


def getdata(filename, ext=0):
    return read(filename)[ext].data


def getheader(filename, ext=0):
    return read(filename)[ext].header


# ----------------------------- writing -----------------------------

def _format_card(key, value, comment=''):
    if key in ('COMMENT', 'HISTORY'):
        return f'{key:<8}{str(value):<72}'[:80]
    if isinstance(value, bool):
        vs = f'{"T" if value else "F":>20}'
    elif isinstance(value, (int, np.integer)):
        vs = f'{int(value):>20}'
    elif isinstance(value, (float, np.floating)):
        vs = f'{float(value):>20.14G}'
    elif value is None:
        vs = ' ' * 20
    else:
        s = str(value).replace("'", "''")
        vs = f"'{s:<8}'"
    card = f'{key[:8]:<8}= {vs}'
    if comment:
        card += f' / {comment}'
    return f'{card:<80}'[:80]


def _header_bytes(cards):
    text = ''.join(_format_card(*c) for c in cards)
    text += f'{"END":<80}'
    pad = (-len(text)) % BLOCK
    return (text + ' ' * pad).encode('ascii')


def _pad_block(b):
    return b + b'\0' * ((-len(b)) % BLOCK)


def _image_hdu_bytes(data, extra_cards, primary, name=None):
    cards = []
    if primary:
        cards.append(('SIMPLE', True, 'conforms to FITS standard'))
    else:
        cards.append(('XTENSION', 'IMAGE', 'image extension'))
    if data is None:
        cards += [('BITPIX', 8, ''), ('NAXIS', 0, '')]
    else:
        data = np.asarray(data)
        bzero_card = None
        if data.dtype.kind == 'u' and data.dtype.itemsize in (2, 4, 8):
            # unsigned image via the BZERO convention (exact)
            nbytes = data.dtype.itemsize
            off = 1 << (nbytes * 8 - 1)
            data = (data ^ data.dtype.type(off)).view(f'i{nbytes}')
            bzero_card = ('BZERO', off, 'unsigned-integer offset')
        kind = (data.dtype.kind, data.dtype.itemsize)
        if data.dtype.kind == 'b':
            data = data.astype('u1')
            kind = ('u', 1)
        if kind not in _DTYPE_TO_BITPIX and data.dtype.kind == 'i' and \
                data.dtype.itemsize == 1:
            data = data.astype('>i2')
            kind = ('i', 2)
        key = f'{kind[0]}{kind[1]}'
        if key not in _DTYPE_TO_BITPIX:
            data = data.astype('f8')
            key = 'f8'
        bitpix = _DTYPE_TO_BITPIX[key]
        cards += [('BITPIX', bitpix, ''),
                  ('NAXIS', data.ndim, '')]
        for i, n in enumerate(data.shape[::-1]):
            cards.append((f'NAXIS{i + 1}', int(n), ''))
        if bzero_card is not None:
            cards.append(bzero_card)
    if not primary:
        cards += [('PCOUNT', 0, ''), ('GCOUNT', 1, '')]
    if name:
        cards.append(('EXTNAME', name, ''))
    cards += list(extra_cards or [])
    out = _header_bytes(cards)
    if data is not None:
        out += _pad_block(np.ascontiguousarray(
            data.astype(data.dtype.newbyteorder('>'))).tobytes())
    return out


def _table_hdu_bytes(columns, extra_cards, name=None, units=None,
                     comments=None):
    """columns: list of (name, ndarray) — scalar or (nrow, k) arrays,
    or unicode/byte string arrays.  ``units``/``comments`` optionally
    map column names to TUNITn values / TTYPEn comments."""
    fields = []
    tzeros = {}
    for cname, col in columns:
        col = np.asarray(col)
        # unsigned ints / signed bytes have no native FITS type: store
        # sign-bit-flipped with the matching TZERO (exact round-trip;
        # see _apply_scaling)
        if col.dtype.kind == 'u' and col.dtype.itemsize in (2, 4, 8):
            nbytes = col.dtype.itemsize
            off = 1 << (nbytes * 8 - 1)
            col = (col ^ col.dtype.type(off)).view(f'i{nbytes}')
            tzeros[cname] = off
        elif col.dtype.kind == 'i' and col.dtype.itemsize == 1:
            col = col.view(np.uint8) ^ np.uint8(0x80)
            tzeros[cname] = -128
        if col.dtype.kind in 'US':
            width = int(col.dtype.itemsize
                        // (4 if col.dtype.kind == 'U' else 1))
            width = max(width, 1)
            enc = np.char.encode(col.astype(f'U{width}'), 'ascii') \
                if col.dtype.kind == 'U' else col
            fields.append((cname, f'{width}A', enc.astype(f'S{width}'),
                           np.dtype(f'S{width}')))
        elif col.dtype.kind == 'b':
            conv = np.where(col, ord('T'), ord('F')).astype('u1')
            fields.append((cname, 'L' if col.ndim == 1 else
                           f'{col.shape[1]}L', conv, np.dtype('u1')
                           if col.ndim == 1 else np.dtype(('u1',
                                                           col.shape[1]))))
        else:
            kind = (col.dtype.kind, col.dtype.itemsize)
            if kind not in _KIND_TO_TFORM:
                col = col.astype('f8')
                kind = ('f', 8)
            code = _KIND_TO_TFORM[kind]
            be = np.dtype(_TFORM_TO_DTYPE.get(code, f'>{kind[0]}{kind[1]}'))
            if code == 'B':
                be = np.dtype('>u1')
            if col.ndim == 1:
                fields.append((cname, code, col.astype(be), be))
            else:
                k = col.shape[1]
                fields.append((cname, f'{k}{code}', col.astype(be),
                               np.dtype((be, (k,)))))
    nrows = len(fields[0][2]) if fields else 0
    rec_dt = np.dtype([(f[0], f[3].base, f[3].shape) if f[3].shape else
                       (f[0], f[3]) for f in fields])
    rec = np.zeros(nrows, dtype=rec_dt)
    for cname, tform, data, _ in fields:
        rec[cname] = data
    cards = [('XTENSION', 'BINTABLE', 'binary table'),
             ('BITPIX', 8, ''), ('NAXIS', 2, ''),
             ('NAXIS1', rec_dt.itemsize, 'bytes per row'),
             ('NAXIS2', nrows, 'number of rows'),
             ('PCOUNT', 0, ''), ('GCOUNT', 1, ''),
             ('TFIELDS', len(fields), '')]
    units = units or {}
    comments = comments or {}
    for i, (cname, tform, _, _) in enumerate(fields, start=1):
        cards.append((f'TTYPE{i}', cname, str(comments.get(cname, ''))))
        cards.append((f'TFORM{i}', tform, ''))
        if cname in tzeros:
            cards.append((f'TZERO{i}', tzeros[cname],
                          'unsigned-integer offset'))
        if cname in units and units[cname]:
            cards.append((f'TUNIT{i}', str(units[cname]), ''))
    if name:
        cards.append(('EXTNAME', name, ''))
    cards += list(extra_cards or [])
    return _header_bytes(cards) + _pad_block(rec.tobytes())


def write(filename, hdu_specs, overwrite=True):
    """Write a FITS file atomically.

    hdu_specs : list of dicts with keys
        kind: 'image' | 'table'
        data: ndarray (image) or list of (name, array) columns (table)
        header: optional list of (key, value, comment) cards
        name: optional EXTNAME
    The first HDU must be an image (or empty primary).
    """
    if not overwrite and os.path.exists(filename):
        raise IOError(f'{filename} exists')
    chunks = []
    for i, spec in enumerate(hdu_specs):
        kind = spec.get('kind', 'image')
        cards = spec.get('header') or []
        if kind == 'image':
            chunks.append(_image_hdu_bytes(spec.get('data'), cards,
                                           primary=(i == 0),
                                           name=spec.get('name')))
        elif kind == 'table':
            if i == 0:
                chunks.append(_image_hdu_bytes(None, [], primary=True))
            chunks.append(_table_hdu_bytes(spec['data'], cards,
                                           name=spec.get('name'),
                                           units=spec.get('units'),
                                           comments=spec.get('comments')))
        else:
            raise ValueError(f'unknown HDU kind {kind!r}')
    tmp = filename + '.tmp'
    with open(tmp, 'wb') as fp:
        for c in chunks:
            fp.write(c)
    os.replace(tmp, filename)
