"""The reference's failure-mask draw, bit for bit, in numpy.

`FaultSweep.sample_masks` of the reference package draws its [S, N]
node-failure masks with `jax.random.bernoulli(jax.random.PRNGKey(seed), p,
(S, N))`. This module computes the same bits without JAX: the default
threefry2x32 key of a seed, JAX's partitionable counter layout
(`jax_threefry_partitionable`, on by default: element i of the flattened
shape hashes the 64-bit counter i, split into its high and low words), and
`bernoulli`'s `uniform(key, shape, dtype(p)) < p`.

The draw depends on one process flag of JAX, `jax_enable_x64`, which the
caller names here (`x64`):

  * without it the seed is taken as an int32 (a Python int wraps to its low
    32 bits, and the key's high word is 0) and a Python float `p` is a
    float32, so each element is a float32 uniform from the 32-bit word
    bits1 ^ bits2;
  * with it the seed is an int64 (the key is its high and low words) and a
    Python float `p` is a float64, so each element is a float64 uniform
    from the 64-bit word bits1 << 32 | bits2. A numpy float32 `p` keeps the
    float32 draw.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words (x1, x2) under the
    key (k1, k2), all uint32: JAX's `threefry2x32_p`."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int, *, x64: bool = False) -> tuple[np.uint32, np.uint32]:
    """`jax.random.PRNGKey(seed)` of the default implementation: the key
    words (high, low) of the seed as an int64 (`x64`) or an int32."""
    s = int(seed)
    if not x64:
        s = (s + (1 << 31)) % (1 << 32) - (1 << 31)  # np.int64 -> int32 wraps
        return np.uint32(0), np.uint32(s & 0xFFFFFFFF)
    if not -(1 << 63) <= s < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit an int64")
    u = s & 0xFFFFFFFFFFFFFFFF
    return np.uint32(u >> 32), np.uint32(u & 0xFFFFFFFF)


def random_bits(key, shape: tuple, width: int) -> np.ndarray:
    """`jax.random.bits` of `width` (32 or 64) under the partitionable
    counter layout."""
    n = int(np.prod(shape, dtype=np.int64))
    counts = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(key[0], key[1], (counts >> np.uint64(32)).astype(np.uint32),
                          counts.astype(np.uint32))
    if width == 32:
        return (b1 ^ b2).reshape(shape)
    if width == 64:
        return ((b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)).reshape(shape)
    raise ValueError(f"width must be 32 or 64, got {width}")


def uniform(key, shape: tuple, dtype) -> np.ndarray:
    """`jax.random.uniform(key, shape, dtype)` on [0, 1): the mantissa bits
    of a float in [1, 2), less 1."""
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        bits = random_bits(key, shape, 32)
        return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    if dtype == np.float64:
        bits = random_bits(key, shape, 64)
        return ((bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
    raise ValueError(f"dtype must be float32 or float64, got {dtype}")


def bernoulli(seed: int, p, shape: tuple, *, x64: bool = False) -> np.ndarray:
    """`jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape)` as a bool
    array, for a JAX process with (`x64`) or without `jax_enable_x64`."""
    kind = np.result_type(p)
    if not np.issubdtype(kind, np.floating):
        raise TypeError(f"bernoulli probability `p` must have a floating dtype, got {kind}.")
    dtype = np.float64 if x64 and kind == np.float64 else np.float32
    return uniform(prng_key(seed, x64=x64), tuple(shape), dtype) < dtype(p)
