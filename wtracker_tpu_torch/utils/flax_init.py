"""Flax's default parameter initialisation, reproduced in numpy.

A fresh model of the JAX package draws its weights with
``model.init(jax.random.PRNGKey(seed), ...)``.  This module computes the same
numbers without JAX, so that a fresh port model made from the same seed holds
the same weights:

- JAX's threefry2x32 hash and the key operations built on it, ``key``,
  ``fold_in``, ``split`` and ``random_bits``, in the partitionable layout
  (``jax_threefry_partitionable=True``, the default since JAX 0.5);
- Flax's key of a parameter: the root key folded once with the first four
  bytes of the SHA-1 of the scope path's names and the scope's ``params``
  counter (``flax/core/scope.py``: ``Scope.push``, ``Scope.make_rng``,
  ``_fold_in_static``, without the ``\\x00`` separator that
  ``flax_fix_rng_separator`` adds and that is off by default);
- ``jax.random.truncated_normal`` and ``variance_scaling(1, "fan_in",
  "truncated_normal")``, which is ``lecun_normal``, the kernel init of
  ``nn.Dense`` and ``nn.Conv``.

Everything is float32 as in JAX.  XLA's CPU code contracts a product and a
sum into one fused multiply-add, so those steps are taken here in float64
and rounded once, which gives the same float32.  ``erfinv`` is XLA's float32
polynomial (Giles), but its ``log1p`` is numpy's: about 1 % of the draws
differ from JAX's by one or two ulps, so the weights agree to about 2e-7,
not bit for bit.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x0, x1)``
    under the two-word ``key`` (JAX's ``threefry2x32_p``)."""
    k0, k1 = (_U32(k) for k in key)
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


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the high and low 32 bits of the seed."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``."""
    y0, y1 = threefry2x32(k, np.zeros(1, _U32), np.array([data & 0xFFFFFFFF], _U32))
    return np.array([y0[0], y1[0]], _U32)


def _iota_2x32(n: int) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) keys, the hashes of the counters 0..num-1."""
    y0, y1 = threefry2x32(k, *_iota_2x32(num))
    return np.stack([y0, y1], axis=1)


def random_bits(k: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element: the two words of each counter's hash, xored."""
    y0, y1 = threefry2x32(k, *_iota_2x32(math.prod(shape)))
    return (y0 ^ y1).reshape(shape)


def uniform(k: np.ndarray, shape: tuple[int, ...], minval: np.float32, maxval: np.float32) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits in [1, 2),
    shifted to [0, 1), then scaled to [minval, maxval)."""
    bits = (random_bits(k, shape) >> _U32(9)) | np.array(1.0, np.float32).view(_U32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(minval, _fma(floats, maxval - minval, minval))


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` with one rounding, as a fused multiply-add."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


# erfinv's float32 polynomial in w = -log(1 - x²) (Giles), as XLA computes it:
# one set of coefficients for w < 5, one for the tails
_ERFINV_CENTRE = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_TAIL = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682], np.float32)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` for |x| < 1."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-_fma(x, x, np.float32(0))).astype(np.float32)
    centre = w < np.float32(5)
    w = np.where(centre, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float32)
    p = np.where(centre, _ERFINV_CENTRE[0], _ERFINV_TAIL[0])
    for c_centre, c_tail in zip(_ERFINV_CENTRE[1:], _ERFINV_TAIL[1:]):
        p = _fma(p, w, np.where(centre, c_centre, c_tail))
    return p * x


def truncated_normal(k: np.ndarray, lower: float, upper: float, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32: ``√2·erfinv(u)`` for ``u``
    uniform between ``erf(lower/√2)`` and ``erf(upper/√2)``, clipped to the
    open interval."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lo / sqrt2)))
    b = np.float32(math.erf(float(hi / sqrt2)))
    u = uniform(k, shape, a, b)
    out = sqrt2 * erfinv(u)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)), np.nextafter(hi, np.float32(-np.inf)))


def lecun_normal(k: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``variance_scaling(1.0, "fan_in", "truncated_normal")`` of a kernel
    whose last axis is the output: a (fan_in, fan_out) Dense kernel or a
    (kh, kw, Cin, Cout) Conv kernel, fan-in the product of the other axes.
    The truncated normal times ``√(1/fan_in) / 0.8796…``, the standard
    deviation of a unit normal cut at ±2."""
    variance = np.float32(1.0 / math.prod(shape[:-1]))
    stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
    return truncated_normal(k, -2.0, 2.0, shape) * stddev


def param_key(root: np.ndarray, path: tuple[str, ...], counter: int) -> np.ndarray:
    """The key of the ``counter``-th ``make_rng("params")`` call (1 for a
    module's first parameter, 2 for its second) in the scope at ``path``: the
    root key folded with the SHA-1 of the names and the counter."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def dense_kernel(root: np.ndarray, path: tuple[str, ...], fan_in: int, fan_out: int) -> np.ndarray:
    """The (fan_in, fan_out) kernel that ``nn.Dense`` at ``path`` draws at
    init: its first parameter, ``lecun_normal``."""
    return lecun_normal(param_key(root, path, 1), (fan_in, fan_out))
