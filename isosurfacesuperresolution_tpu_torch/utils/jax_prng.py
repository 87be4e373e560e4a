"""A numpy copy of the JAX package's random draws: threefry2x32 keys.

The JAX package draws its AO sample tables with ``jax.random``
(``PRNGKey``, ``split``, ``uniform``), so any other generator renders other
AO.  This module reproduces those draws bit for bit without JAX: the
threefry2x32 block cipher (Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", 2011; 20 rounds, JAX's rotation constants and key schedule)
and JAX's "partitionable" counter layout, the default since JAX 0.5
(``jax_threefry_partitionable=True``): an array of shape ``s`` draws its
elements from the counters (hi, lo) of the 64-bit row-major index of each
element, and a 32-bit draw is ``bits1 ^ bits2``.

`sinf` and `cosf` are the C library's single-precision functions, which
XLA's CPU backend calls for ``jnp.sin`` / ``jnp.cos`` on float32: a
correctly rounded sine differs from them in about 1% of the arguments.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block of (x0, x1) under ``key`` (two uint32)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
    return (0, int(seed) & 0xFFFFFFFF)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo) words of the 64-bit indices 0 .. n-1."""
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(key: Tuple[int, int], num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of keys."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return [(int(a), int(b)) for a, b in zip(b0, b1)]


def random_bits(key: Tuple[int, int], shape: Tuple[int, ...]) -> np.ndarray:
    """32-bit draws of ``shape``, as ``jax.random.bits``."""
    b0, b1 = threefry2x32(key, *_counters(int(np.prod(shape, dtype=int))))
    return (b0 ^ b1).reshape(shape)


def uniform(key: Tuple[int, int], shape: Tuple[int, ...]) -> np.ndarray:
    """float32 draws in [0, 1) of ``shape``, as ``jax.random.uniform``:
    the 23 high bits of a draw as the mantissa of a float in [1, 2),
    minus 1."""
    bits = random_bits(key, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), f - np.float32(1.0))


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
    return lib


def _map_f32(name: str, x: np.ndarray) -> np.ndarray:
    fn = getattr(_libm(), name)
    x = np.asarray(x, np.float32)
    return np.array([fn(float(v)) for v in x.reshape(-1)],
                    np.float32).reshape(x.shape)


def sinf(x: np.ndarray) -> np.ndarray:
    """Elementwise float32 sine by the C library's ``sinf``."""
    return _map_f32("sinf", x)


def cosf(x: np.ndarray) -> np.ndarray:
    """Elementwise float32 cosine by the C library's ``cosf``."""
    return _map_f32("cosf", x)
