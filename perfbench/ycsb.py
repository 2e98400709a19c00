"""YCSB's key naming and scrambled-Zipfian request generator, frozen here.

Copied from the YCSB core package (Cooper et al., SoCC'10;
``site.ycsb.Utils.fnvhash64``, ``site.ycsb.generator.ZipfianGenerator``
and ``ScrambledZipfianGenerator``) and vectorised with NumPy. Java's
``ThreadLocalRandom`` is replaced by a seeded NumPy generator. Part of the
benchmark's yardstick: a later change to the program never edits it.
"""

from __future__ import annotations

import numpy as np

FNV_OFFSET_BASIS_64 = np.uint64(0xCBF29CE484222325)
FNV_PRIME_64 = np.uint64(1099511628211)

# ScrambledZipfianGenerator: a Zipfian over 10^10 items whose zeta is
# precomputed for the constant 0.99, then hashed onto the key range
ZIPFIAN_CONSTANT = 0.99
ITEM_COUNT = 10_000_000_000
ZETAN = 26.46902820178302


def fnvhash64(values) -> np.ndarray:
    """64-bit FNV-1 over the 8 low-to-high octets of each value, as
    ``Utils.fnvhash64``: int64 results, ``Math.abs`` applied (Long.MIN_VALUE,
    which Java leaves negative, wraps to itself here as well)."""
    v = np.asarray(values, dtype=np.int64).astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, dtype=np.uint64)
    for _ in range(8):
        h ^= v & np.uint64(0xFF)
        v = v >> np.uint64(8)
        h *= FNV_PRIME_64
    return np.abs(h.view(np.int64))


def key_names(record_count: int) -> list:
    """YCSB's record keys with ``insertorder=hashed`` (the default):
    ``"user" + fnvhash64(keynum)`` for keynum 0 .. record_count - 1."""
    return [f"user{h}" for h in fnvhash64(np.arange(record_count)).tolist()]


class ScrambledZipfian:
    """Record numbers in [0, items): a Zipfian draw over ``ITEM_COUNT``
    items with ``ZIPFIAN_CONSTANT``, hashed onto the range with
    ``fnvhash64(x) % items``, so popular records lie all over it."""

    def __init__(self, items: int) -> None:
        if items < 1:
            raise ValueError(f"ScrambledZipfian over {items} items")
        self.items = int(items)
        theta = ZIPFIAN_CONSTANT
        n = ITEM_COUNT + 1  # ZipfianGenerator(0, ITEM_COUNT): max - min + 1
        zeta2theta = 1.0 + 0.5 ** theta
        self._n = n
        self._theta = theta
        self._alpha = 1.0 / (1.0 - theta)
        self._eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (1.0 - zeta2theta / ZETAN)

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """``size`` record numbers (int64) from ``rng``'s uniform doubles."""
        u = rng.random(size)
        uz = u * ZETAN
        base = np.floor(self._n * (self._eta * u - self._eta + 1.0) ** self._alpha)
        z = np.where(uz < 1.0, 0.0, np.where(uz < 1.0 + 0.5 ** self._theta, 1.0, base))
        # Java's remainder truncates toward zero; fnvhash64 is never
        # negative but for Long.MIN_VALUE, which fmod keeps in range by abs
        return np.abs(np.fmod(fnvhash64(z.astype(np.int64)), self.items))
