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
* :func:`fold_in`: ``jax.random.fold_in(key, data)``, the two words of
  ``threefry2x32(key, (0, data))``;
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

The same draws run on device tensors too (:func:`random_bits_rows`,
:func:`uniform_rows`, :func:`normal_rows`): a batch of keys, one per row,
each row ``jax.random.uniform(key_c, (n,))`` or
``jax.random.normal(key_c, (n,))``. The uint32
words are carried in int64 tensors and masked to 32 bits after every add
and shift, so the bits are the NumPy path's on any device; the Byzantine
attacks draw their noise there, and the stochastic wire codecs their
rounding uniforms, on the card rather than on the host.
"""
from __future__ import annotations

import numpy as np
import torch

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


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``'s raw key (2 uint32)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], dtype=np.uint32)


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


# ------------------------------------------------------ on device tensors

_M32 = 0xFFFFFFFF
#: elements of one (rows x slice) piece of :func:`uniform_rows` and
#: :func:`normal_rows`: bounds the
#: int64 temporaries (8 bytes each, a handful live) whatever the leaf size
_PIECE = 1 << 22


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32_t(k0, k1, x0, x1):
    """:func:`threefry2x32` on int64 tensors holding uint32 words; the
    keys broadcast against the counters."""
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key_t(seed: torch.Tensor):
    """``jax.random.PRNGKey`` of each seed in ``seed`` (C,): the key words
    ``(0, seed mod 2^32)`` as two (C,) int64 tensors."""
    s = seed.to(torch.int64) & _M32
    return torch.zeros_like(s), s


def fold_in_t(key, data: int):
    """:func:`fold_in` of a batch of keys (two (C,) int64 tensors)."""
    k0, k1 = key
    zero = torch.zeros_like(k0)
    return threefry2x32_t(k0, k1, zero, zero + (int(data) & _M32))


def _erfinv_t(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _W_LT_5[0], _W_GE_5[0])
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def random_bits_rows(key, start: int, stop: int) -> torch.Tensor:
    """Elements ``[start, stop)`` of each row's ``random_bits(key_c,
    (n,))`` (any n >= stop): (C, stop - start) int64 holding uint32."""
    k0, k1 = (k[:, None] for k in key)
    i = torch.arange(start, stop, dtype=torch.int64, device=k0.device)[None]
    b0, b1 = threefry2x32_t(k0, k1, i >> 32, i & _M32)
    return b0 ^ b1


_ONE_BITS = int(np.array(1.0, np.float32).view(np.uint32))


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """:func:`uniform`'s float step on int64 lanes of uint32 bits: 23
    mantissa bits under the exponent of 1.0, minus 1 -> [0, 1) fp32."""
    return ((bits >> 9) | _ONE_BITS).to(torch.int32).view(
        torch.float32) - 1.0


def _pieces(rows: int, n: int):
    step = max(1, _PIECE // max(rows, 1))
    for s0 in range(0, n, step):
        yield s0, min(n, s0 + step)


def uniform_rows(key, n: int, start: int = 0) -> torch.Tensor:
    """Row c is ``jax.random.uniform(key_c, (N,), float32)[start:start +
    n]`` (minval 0, maxval 1) for any N >= start + n: (C, n) fp32 on the
    keys' device, bit for bit, drawn in pieces of at most ``_PIECE``
    elements."""
    rows = key[0].shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=key[0].device)
    for s0, s1 in _pieces(rows, n):
        # JAX's floats * (maxval - minval) + minval is exact at [0, 1), and
        # the clamp at minval keeps -0.0 out
        out[:, s0:s1] = torch.clamp(_unit_floats(
            random_bits_rows(key, start + s0, start + s1)), min=0.0)
    return out


def normal_rows(key, n: int) -> torch.Tensor:
    """Row c is ``jax.random.normal(key_c, (n,), float32)``: (C, n) fp32 on
    the keys' device, drawn in pieces of at most ``_PIECE`` elements."""
    rows = key[0].shape[0]
    # the float32 constants of :func:`uniform` and :func:`normal`, as
    # Python floats holding float32 values
    lo32 = np.nextafter(np.float32(-1.0), np.float32(0.0))
    lo, span = float(lo32), float(np.float32(1.0) - lo32)
    sqrt2 = float(np.float32(np.sqrt(2)))
    out = torch.empty((rows, n), dtype=torch.float32, device=key[0].device)
    for s0, s1 in _pieces(rows, n):
        u = _unit_floats(random_bits_rows(key, s0, s1))
        u = torch.clamp(u * span + lo, min=lo)
        out[:, s0:s1] = sqrt2 * _erfinv_t(u)
    return out
