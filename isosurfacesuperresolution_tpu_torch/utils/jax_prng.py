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

`normal` is ``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)``
of a uniform draw ``u`` on (-1, 1), with ``erf_inv`` XLA's float32
polynomial (M. Giles, "Approximating the erfinv function", 2010) in
float32 numpy.  XLA takes ``log1p`` from its own approximation and numpy
from the C library, so a draw may differ from JAX's in its last bits
(a few ulps; `tests/test_torch_port_texenc.py` states the bound).
`randint` is ``jax.random.randint`` for int32: two 32-bit draws from a
split key, combined modulo the span, bit for bit.
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


def uniform(key: Tuple[int, int], shape: Tuple[int, ...],
            minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """float32 draws in [minval, maxval) of ``shape``, as
    ``jax.random.uniform``: the 23 high bits of a draw as the mantissa of
    a float in [1, 2), minus 1, scaled and shifted in float32."""
    bits = random_bits(key, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, (f - np.float32(1.0)) * (hi - lo) + lo)


# XLA's float32 erf_inv: Giles' polynomials in w = -log1p(-x^2), one for
# w < 5 (in w - 2.5) and one beyond (in sqrt(w) - 3)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """The inverse error function in float32, by XLA's polynomial;
    +-inf at +-1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(x * -x)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(small, np.float32(_ERFINV_SMALL[0]),
                     np.float32(_ERFINV_LARGE[0])).astype(np.float32)
        for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            p = np.where(small, np.float32(a), np.float32(b)) + p * w
        out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


def normal(key: Tuple[int, int], shape: Tuple[int, ...]) -> np.ndarray:
    """Standard normal float32 draws of ``shape``, as
    ``jax.random.normal``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)


def randint(key: Tuple[int, int], shape: Tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """int32 draws in [minval, maxval) of ``shape``, as
    ``jax.random.randint``: 32 high and 32 low bits from the two halves
    of ``split(key)``, reduced modulo the span in uint32."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(1 if maxval <= minval else (maxval - minval) % 2 ** 32)
    with np.errstate(over="ignore"):
        multiplier = _U32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = (higher % span) * multiplier + lower % span
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


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
