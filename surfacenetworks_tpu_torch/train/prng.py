"""JAX's default counter-based generator on the host, in uint32 numpy
(counterpart of ``jax.random.key``, ``fold_in`` and ``uniform`` as JAX 0.9
computes them with ``jax_threefry_partitionable`` on, its default).

The normal trainer's ``--rotate-augment`` draws its angles as the JAX
trainer does, ``jax.random.uniform(fold_in(key(seed), step), (B, 3),
maxval=2*pi)``, so both packages rotate a step's meshes by the same
angles.  Threefry-2x32 (20 rounds, the key schedule of
``jax/_src/prng.py::_threefry2x32_lowering``) hashes a pair of 32-bit
counters under a pair of 32-bit key words:

* ``key(seed)``: the key words ``(seed >> 32, seed & 0xFFFFFFFF)``; JAX's
  default (32-bit) mode takes seeds in int32, whose high word is 0;
* ``fold_in(key, d)``: the hash of the counters ``(0, d)``;
* ``random_bits(key, shape)``: the hash of the counter pairs ``(i >> 32,
  i & 0xFFFFFFFF)`` for ``i`` the row-major index, the two output words
  XORed;
* ``uniform``: the 23 high bits of each word as the mantissa of a float32
  in [1, 2), minus 1, scaled into ``[minval, maxval)`` in float32 and
  clamped below at ``minval``.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` (uint32
    arrays of one shape) under the key ``(k1, k2)``; uint32 arithmetic
    wraps."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s key words, uint32 ``[2]``."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside int32, the seeds JAX's default mode takes")
    return np.asarray([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for ``0 <= data < 2**32``."""
    y0, y1 = threefry2x32(k[0], k[1], np.zeros(1, np.uint32), np.asarray([data], np.uint32))
    return np.concatenate([y0, y1])


def random_bits(k: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape``, uint32."""
    i = np.arange(math.prod(shape), dtype=np.uint64)
    b1, b2 = threefry2x32(k[0], k[1], (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32))
    return (b1 ^ b2).reshape(shape)


def uniform(k: np.ndarray, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, minval=, maxval=)`` in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)
