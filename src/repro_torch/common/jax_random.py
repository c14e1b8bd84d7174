"""The draws of JAX's ``jax.random`` that a model function makes inside its
forward, computed without JAX.

MIND's routing logits start from ``jax.random.normal(PRNGKey(0), (1, L, K))``
(``models/recsys.py::mind_interests``): a fixed part of the function, not a
parameter. This module computes that draw in integer numpy arithmetic:
threefry2x32 (20 rounds) over JAX's partitionable counter layout (element i
is the counter (i >> 32, i & 0xffffffff), its 32-bit word ``bits1 ^ bits2``),
the uniform built from the word's top 23 bits as JAX builds it (the same bits
as JAX), and ``sqrt(2) * erfinv(u)`` through XLA's float32 polynomial for
``erf_inv``, each Horner step rounded once as a fused multiply-add would be.
The normals then equal JAX's on most elements (all 200 of MIND's (1, 50, 4))
and differ from the others by at most 2 ulp of max(|x|, 1): 2.4e-7 below 2,
4.8e-7 below 4 (XLA's own ``log1p`` is not reproduced).
``PRNGKey(seed)`` for a small non-negative seed is the key (0, seed).
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's ErfInv32 coefficients (Giles), for w < 5 and w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counters (x0, x1) under ``key``."""
    ks = (_U32(key[0]), _U32(key[1]), _U32(key[0]) ^ _U32(key[1]) ^ _U32(0x1BD11BDA))
    a, b = x0.astype(_U32) + ks[0], x1.astype(_U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = (b << _U32(r)) | (b >> _U32(32 - r))
            b = a ^ b
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def random_bits(seed: int, shape: tuple) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape)`` as uint32, partitionable layout."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    b1, b2 = threefry2x32((0, seed), (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (b1 ^ b2).reshape(shape)


def uniform(seed: int, shape: tuple, minval: float, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(seed), shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = ((random_bits(seed, shape) >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(lo, f * (hi - lo) + lo)


def _erfinv(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(c_lt), np.float32(c_ge))
        p = (c.astype(np.float64) + p.astype(np.float64) * w.astype(np.float64)).astype(np.float32)
    return np.where(np.abs(x) == 1, np.copysign(np.float32(np.inf), x), p * x).astype(np.float32)


def normal(seed: int, shape: tuple) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), shape)`` in float32."""
    u = uniform(seed, shape, float(np.nextafter(np.float32(-1.0), np.float32(0.0))))
    return (np.float32(np.sqrt(2)) * _erfinv(u)).astype(np.float32)
