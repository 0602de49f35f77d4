"""Threefry-2x32 keys and float32 uniforms on the host, bit for bit as
``jax.random`` computes them with ``jax_threefry_partitionable`` on (the
default since JAX 0.5).

The clustering strategy's k-means draws one uniform per center from a key
derived from the study's ask count (``core.kmeans``).  Those draws depend
on the key alone, not on the data, so the host makes them here in numpy
``uint32`` and the device gets a small tensor of uniforms.

A key is a uint32 array of shape (..., 2).  ``PRNGKey`` of a seed gives
(seed >> 32, seed & 0xFFFFFFFF); ``split`` hashes the 64-bit counters
0..num-1 (hi, lo words) under the key; ``uniform`` hashes counter 0 (one
value) and takes the high 23 bits of the two words' xor as the mantissa of
a float in [1, 2), minus 1.
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) of counters (x0, x1) under key
    words (k0, k1); every argument uint32, broadcast together."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed) -> np.ndarray:
    """The key of an integer seed (or an array of seeds, one key each):
    uint32 (..., 2)."""
    s = np.asarray(seed)
    if s.dtype.kind not in "iu":
        raise TypeError(f"PRNGKey needs an integer seed, got {s.dtype}")
    s64 = s.astype(np.int64).astype(np.uint64)
    hi = (s64 >> np.uint64(32)).astype(np.uint32)
    if s.dtype.itemsize <= 4:      # a 32-bit seed has no high word
        hi = np.zeros_like(hi)
    lo = (s64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``num`` new keys from ``key`` (..., 2): (..., num, 2)."""
    key = np.asarray(key, np.uint32)
    ctr = np.arange(num, dtype=np.uint64)
    c_hi = (ctr >> np.uint64(32)).astype(np.uint32)
    c_lo = (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key[..., None, 0], key[..., None, 1], c_hi, c_lo)
    return np.stack([b0, b1], axis=-1)


def uniform(key: np.ndarray) -> np.ndarray:
    """One float32 uniform in [0, 1) per key (..., 2): shape (...)."""
    key = np.asarray(key, np.uint32)
    zero = np.zeros((), np.uint32)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.astype(np.uint32).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), f).astype(np.float32)
