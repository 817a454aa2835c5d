"""Named numpy RNG streams (a copy of the reference's ``core/rng.py``).

Every independent randomness consumer in the simulator draws from
``rng_stream(seed, name)``.  Legacy names keep their historical integer
offsets and salted tuples bit for bit; new names hash to a
``(crc32(name), seed)`` tuple.  The port draws all simulator noise here,
on the host, so it consumes exactly the numbers the reference does.
"""
from __future__ import annotations

import zlib
from typing import Union

import numpy as np

#: legacy integer-offset streams — pinned: changing these moves goldens
_LEGACY_OFFSETS = {"topology": 0, "noise": 1, "policy": 2, "churn": 3}
#: legacy salted-tuple streams — pinned for the same reason
_LEGACY_SALTS = {"arrival": 17, "noise_streamed": 29, "drift": 31,
                 "preempt": 37}
#: tuple salts already taken — a hashed stream landing on one would
#: alias a legacy stream whenever the base seeds coincide
_RESERVED = frozenset(_LEGACY_SALTS.values())


def rng_seed(seed: int, name: str) -> Union[int, tuple]:
    """The ``default_rng`` key stream ``name`` draws under base ``seed``."""
    if name in _LEGACY_OFFSETS:
        return seed + _LEGACY_OFFSETS[name]
    if name in _LEGACY_SALTS:
        return (_LEGACY_SALTS[name], seed)
    salt = zlib.crc32(name.encode()) % (2 ** 31)
    if salt in _RESERVED:  # pragma: no cover - crc32 of a future name
        salt += 41
    return (salt, seed)


def rng_stream(seed: int, name: str) -> np.random.Generator:
    """A fresh ``Generator`` on the named stream."""
    return np.random.default_rng(rng_seed(seed, name))


def rng_from_key(key) -> np.random.Generator:
    """A ``Generator`` from an externally pinned key (the campaign's
    RandomChoice seed blocks replay a serial run's stream)."""
    return np.random.default_rng(key)


def stream_identity(name: str) -> tuple:
    """Stream ``name``'s generator identity on two independent probe
    seeds: two names alias if and only if their identities agree (the
    linter's ``rng-stream-uniqueness`` proof)."""
    return rng_seed(0, name), rng_seed(12345, name)
