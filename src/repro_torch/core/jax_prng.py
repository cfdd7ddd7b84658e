"""JAX's default PRNG draws, replayed in NumPy (no ``jax`` import).

The JAX package draws some fixed starting points from ``jax.random`` — the
ATOMO power method starts every leaf from
``jax.random.normal(jax.random.PRNGKey(0), (n, r), float32)``. The port
replays those draws here so that its iterates are the reference's:

* :func:`threefry2x32`: the Threefry-2x32 block cipher, 20 rounds (JAX's
  ``threefry2x32_p``);
* :func:`prng_key`: ``jax.random.PRNGKey(seed)`` under JAX's default
  32-bit mode (``jax_enable_x64`` off), where the seed is cast to 32 bits
  first: ``[0, seed mod 2^32]`` as uint32;
* :func:`random_bits`: JAX's 32-bit ``random_bits`` in the partitionable
  mode (``jax_threefry_partitionable``, JAX's default since 0.5): element
  ``i`` of the row-major flattened shape is ``x0 ^ x1`` of
  ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* :func:`uniform`: 23 random mantissa bits under the exponent of 1.0,
  minus 1, scaled to ``[minval, maxval)`` (JAX's ``_uniform``);
* :func:`normal`: ``sqrt(2) * erfinv(u)`` with u uniform on
  ``[nextafter(-1, 0), 1)`` (JAX's ``_normal_real``). ``erfinv`` is M.
  Giles' single-precision polynomial, the one XLA lowers ``erf_inv`` to,
  evaluated in float32 with NumPy's ``log1p``; it agrees with JAX within
  a few float32 ulps (XLA's own ``log1p`` and its fused multiply-adds may
  round differently).
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds: ``key`` a pair of uint32, ``x0, x1``
    uint32 counter arrays of one shape. Returns the two output words."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32).copy()
    x1 = np.asarray(x1, np.uint32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s raw threefry key (2 uint32), x64 off."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """JAX's 32-bit ``random_bits(key, 32, shape)`` (partitionable mode)."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


# M. Giles, "Approximating the erfinv function" (single precision), the
# coefficients of XLA's ErfInv32, highest degree first
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function by XLA's polynomial."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_W_LT_5[0]), np.float32(_W_GE_5[0]))
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv(u)).astype(np.float32)
