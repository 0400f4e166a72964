"""Hashable immutable mapping (a copy of rvspecfit_tpu/frozendict.py).

Configs are frozen so that they can key host-side caches.
"""
from collections.abc import Mapping


class frozendict(Mapping):
    __slots__ = ('_d', '_hash')

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, '_d', dict(*args, **kwargs))
        object.__setattr__(self, '_hash', None)

    def __getitem__(self, key):
        return self._d[key]

    def __contains__(self, key):
        return key in self._d

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def get(self, key, default=None):
        return self._d.get(key, default)

    def copy(self, **updates):
        d = dict(self._d)
        d.update(updates)
        return frozendict(d)

    def __hash__(self):
        if self._hash is None:
            h = 0
            for pair in self._d.items():
                h ^= hash(pair)
            object.__setattr__(self, '_hash', h)
        return self._hash

    def __eq__(self, other):
        if isinstance(other, frozendict):
            return self._d == other._d
        if isinstance(other, dict):
            return self._d == other
        return NotImplemented

    def __repr__(self):
        return f'frozendict({self._d!r})'

    def __reduce__(self):
        return (frozendict, (self._d,))
