"""Bit-exact threefry2x32: ``jax.random``'s keys, split and randint.

The JAX reference seeds every coded message from ``jax.random`` (random
heads and clean bits in ``codecs.container.fresh_stack``), so the port
cannot write the reference's bytes without the same bits. This module
reproduces ``jax.random`` in its *non-partitionable* threefry mode
(``jax_threefry_partitionable=False``), the mode the committed golden
blobs were written in:

  * ``PRNGKey(seed)`` -> ``[seed >> 32, seed & 0xFFFFFFFF]``;
  * ``split(key, n)`` hashes counts ``0 .. 2n-1`` and reshapes to
    ``[n, 2]``;
  * ``fold_in(key, data)`` hashes the pair ``[0, data]`` (the uint32
    ``data`` as a threefry seed: high word 0, low word ``data``);
  * ``random_bits`` hashes counts ``0 .. size-1`` (32-bit draws);
  * ``randint`` draws two words per value and folds them with the
    ``2^32 mod span`` multiplier, as ``jax._src.random._randint`` does.

``threefry_2x32`` splits its (odd-padded) count vector into halves,
hashes pair ``(x0[i], x1[i])`` with 20 rounds, and concatenates the two
output halves. Everything runs on the CPU in int64 masked to 32 bits;
keys are numpy ``uint32[2]`` arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return ((x << np.uint64(d)) | (x >> np.uint64(32 - d))) & _M32


def _hash(k1: int, k2: int, x0: np.ndarray,
          x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block function on uint64-held 32-bit words."""
    ks = [np.uint64(k1), np.uint64(k2),
          np.uint64(k1 ^ k2 ^ 0x1BD11BDA)]
    x = [(x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x[0], x[1]


def threefry_2x32(key: np.ndarray, count: np.ndarray) -> np.ndarray:
    """``jax._src.prng.threefry_2x32``: hash a uint32 count vector."""
    flat = np.asarray(count, np.uint64).ravel()
    odd = flat.size % 2
    if odd:
        flat = np.concatenate([flat, np.zeros(1, np.uint64)])
    half = flat.size // 2
    y0, y1 = _hash(int(key[0]), int(key[1]), flat[:half], flat[half:])
    out = np.concatenate([y0, y1])
    if odd:
        out = out[:-1]
    return out.astype(np.uint32).reshape(np.shape(count))


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as uint32[2]."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (non-partitionable): uint32[num, 2]."""
    counts = np.arange(num * 2, dtype=np.uint64)
    return threefry_2x32(key, counts).reshape(num, 2)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` (non-partitionable): uint32[2]."""
    data = int(data)
    if not 0 <= data <= 0xFFFFFFFF:
        raise ValueError("prng.fold_in: data must fit in uint32")
    return threefry_2x32(key, np.array([0, data], np.uint64))


def random_bits(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """32-bit ``jax.random.bits`` (non-partitionable): uint32[shape]."""
    size = int(np.prod(shape))
    if size >= 0xFFFFFFFF:
        raise ValueError("prng.random_bits: more than 2^32 - 1 words")
    return threefry_2x32(key, np.arange(size, dtype=np.uint64)) \
        .reshape(shape)


def randint(key: np.ndarray, shape: Tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``.

    For int32 bounds inside the int32 range (what the coder uses).
    """
    if not (-(1 << 31) <= minval and maxval <= (1 << 31) - 1):
        raise ValueError("prng.randint: bounds outside int32")
    k1, k2 = split(key)
    hi = random_bits(k1, shape).astype(np.uint64)
    lo = random_bits(k2, shape).astype(np.uint64)
    span = np.uint64((maxval - minval) & 0xFFFFFFFF)
    if maxval <= minval:
        span = np.uint64(1)
    mult = np.uint64((1 << 16) % int(span))
    mult = (mult * mult & _M32) % span
    off = ((hi % span) * mult & _M32) + lo % span
    off = (off & _M32) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
