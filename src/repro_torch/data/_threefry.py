"""A numpy copy of the parts of ``jax.random`` the data pipeline draws from.

The JAX package makes its batches with ``jax.random`` under the default
threefry2x32 key and ``jax_threefry_partitionable=True`` (jax 0.9).  The port
must give the same tokens bit for bit without jax, so this module computes
the same functions on ``uint32`` numpy arrays:

* ``threefry2x32(k1, k2, x1, x2)``: the 20-round Threefry-2x32 hash
  (Salmon et al., SC'11), as ``jax._src.prng._threefry2x32_lowering``;
* ``prng_key(seed)``: ``jax.random.PRNGKey`` of a 32-bit seed, ``[0, seed]``;
* ``fold_in(key, data)``: the hash of the counter pair ``(0, data)``;
* ``split(key, num)``: the hash of the counters ``(0, i)`` for i < num,
  each output pair a key (the partitionable "fold-like" split);
* ``random_bits(key, shape)``: 32-bit words, the XOR of the two hash
  outputs of the 64-bit counter ``i`` (hi, lo) for the i-th element in C
  order;
* ``randint(key, shape, minval, maxval)``: jax's modular reduction of two
  draws of 32 bits (one per half of ``split(key)``) into ``[minval,
  maxval)``, int32;
* ``uniform_bits(key, shape, minval, maxval)``: float32 in ``[minval,
  maxval)`` from the top 23 bits of ``random_bits``, as ``jax.random.uniform``.

``jax.random.normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``;
the pipeline takes its uniform values from here and ``erfinv`` from torch,
which may differ from XLA's by an ulp.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the key pair (k1, k2) over the
    counter words (x1, x2), elementwise; uint32 in and out."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in 32 bits."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} is not a 32-bit unsigned value")
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter (0, data)."""
    a, b = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                        np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def _counters(shape) -> tuple[np.ndarray, np.ndarray]:
    """The hi and lo words of a uint64 iota laid out in ``shape``."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    hi, lo = _counters((num,))
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([a, b], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 uniform bits per element of ``shape``."""
    hi, lo = _counters(tuple(shape))
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return a ^ b


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(maxval - minval) if maxval > minval else np.uint32(1)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = np.uint32(mult * mult) % span
        off = (higher % span) * mult + lower % span
    off = off % span
    return (np.int32(minval) + off.astype(np.int32)).astype(np.int32)


def uniform(key: np.ndarray, shape, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``."""
    mn, mx = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(32 - 23)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(mn, floats * (mx - mn) + mn)
