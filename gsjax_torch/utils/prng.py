"""gsjax's random keys: the port's counterpart of the ``jax.random``
functions gsjax calls, draw for draw.

gsjax sets no PRNG flag, so it runs JAX's defaults: the ``threefry2x32``
implementation with ``jax_threefry_partitionable`` on (the default since
JAX 0.5). This module reproduces exactly that:

- a key is two uint32 words, held on the host as a numpy ``uint32`` pair
  (``PRNGKey(seed)`` is ``(0, seed mod 2**32)``);
- ``split(key, n)[i]`` and ``fold_in(key, i)`` are both the Threefry-2x32
  hash of the counter pair ``(0, i)`` under ``key`` (JAX's foldlike split);
  they run on the host in Python integers;
- ``bits(key, shape)`` hashes each element's row-major index, as a 64-bit
  counter split into two words, and xors the two output words;
- ``uniform`` puts the top 23 bits in a float's mantissa with exponent 0,
  subtracts 1, scales to [minval, maxval) and clamps below at minval;
- ``normal`` is ``sqrt(2) * erf_inv(u)`` for ``u`` uniform in
  (-1, 1), and ``erf_inv`` is XLA's float32 ErfInv (Giles' polynomial in
  ``-log1p(-u * u)``) as XLA's CPU code computes it: its log1p and log are
  Cephes' approximations, and its multiply-adds are fused (rounded once).
  ``torch.erfinv`` and ``torch.log1p`` round otherwise on many inputs.

The bits, uniforms and normals of a draw are made on the device the
caller names, from IEEE-exact torch ops only (int64 ops on values masked to
32 bits, as torch's ``uint32`` lacks the arithmetic; float32 adds, products
and quotients; a fused multiply-add and a square root taken in float64 and
rounded once), so a draw is the same bits on every device and equal to
``jax.random``'s on the CPU. They add no host sync. Every draw takes an
explicit device.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

Key = np.ndarray  # (2,) uint32

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA



def _f32(*values) -> tuple:
    """Python floats holding the float32 roundings of ``values``."""
    return tuple(float(np.float32(v)) for v in values)


# XLA's ErfInv32 coefficients, highest degree first, for w < 5 and w >= 5
_ERFINV_LT5 = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = _f32(-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                   0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
(_SQRT2,) = _f32(math.sqrt(2.0))
# Cephes' logf, as XLA's CPU code emits it
_LOG_P = _f32(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
              1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
              3.3333331174e-1)
_LOG_Q1, _LOG_Q2, _LOG_SQRTHF = _f32(-2.12194440e-4, 0.693359375, 0.707106781186547524)
_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)
# XLA's log1p: Cephes' rational approximation below sqrt(2) - 1
_LOG1P_NUM = _f32(4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                  6.5787325942061044846969e0, 2.9911919328553073277375e1,
                  6.0949667980987787057556e1, 5.7112963590585538103336e1,
                  2.0039553499201281259648e1)
_LOG1P_DEN = _f32(1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
                  2.2176239823732856465394e2, 3.0909872225312059774938e2,
                  2.1642788614495947685003e2, 6.0118660497603843919306e1)
(_LOG1P_SMALL,) = _f32(0.41421356237309504880)


def _threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` under
    the key ``(k1, k2)``. The counters are Python ints or int64 tensors
    holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & _M, (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def _words(key) -> tuple:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {k.shape}")
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for an integer seed (32-bit keys: the
    seed's low 32 bits, the high word 0)."""
    return np.array([0, int(seed) & _M], dtype=np.uint32)


def fold_in(key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``, ``data`` in [0, 2**32)."""
    data = int(data)
    if not 0 <= data <= _M:
        raise ValueError(f"fold_in data {data} is not a uint32")
    return np.array(_threefry2x32(*_words(key), 0, data), dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32, row ``i`` the
    hash of the counter ``i``."""
    k1, k2 = _words(key)
    return np.array([_threefry2x32(k1, k2, 0, i) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def bits(key, shape: Union[int, Sequence[int]], device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in
    [0, 2**32), made on ``device``."""
    shape = _shape(shape)
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(*_words(key), count >> 32, count & _M)
    return (y0 ^ y1).reshape(shape)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU code fuses it.
    ``a * b`` is exact in float64; the sum is rounded to odd there (its
    last bit set when inexact), which then rounds to float32 as the exact
    sum would."""
    a, b, c = (v.to(torch.float64) if isinstance(v, torch.Tensor) else float(v)
               for v in (a, b, c))
    p = a * b
    s = p + c
    pb = s - p
    err = (p - (s - pb)) + (c - pb)  # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def uniform(key, shape: Union[int, Sequence[int]], device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    mantissa = (bits(key, shape, device) >> 9) | 0x3F800000  # [1, 2) as bits
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(_fma(floats, hi - lo, lo), float(lo))


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    """``sum c_i x^i``, the highest degree first, one fused multiply-add a
    coefficient (XLA's ``EvaluatePolynomial``)."""
    p = torch.full_like(x, float(np.float32(coefs[0])))
    for c in coefs[1:]:
        p = _fma(p, x, np.float32(c))
    return p


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log: Cephes' ``logf``, its multiply-adds fused."""
    xi = torch.clamp_min(x, _F32_MIN_NORMAL).view(torch.int32)
    e = ((xi >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((xi & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    small = m < _LOG_SQRTHF
    e = e - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, 0.0)
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, t3, y1), t3, y2)
    y = _fma(y, t3, _LOG_Q1 * e)
    out = ((t - 0.5 * t2) + y) + _LOG_Q2 * e
    out = torch.where(x < 0.0, math.nan, out)  # and NaN stays NaN
    # subnormal inputs count as 0, as XLA's CPU code flushes them
    out = torch.where((x >= 0.0) & (x < _F32_MIN_NORMAL), -math.inf, out)
    return torch.where(x == math.inf, math.inf, out)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: Cephes' rational approximation for
    |x| < sqrt(2) - 1, ``log(x + 1)`` beyond."""
    x2 = x * x
    r = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + ((x * x2) * r - 0.5 * x2)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (``lax.erf_inv``): Giles' polynomial in
    ``w = -log1p(-x * x)``, in ``w - 2.5`` below 5 and ``sqrt(w) - 3``
    above; +-inf at +-1."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    # float32 sqrt rounded once (torch's vectorised CPU sqrt misrounds)
    root = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    t = torch.where(lt, w - 2.5, root - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, t, torch.where(lt, a, b))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape: Union[int, Sequence[int]], device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _SQRT2 * erf_inv(uniform(key, shape, device, lo, 1.0))
