"""tpuwave's standard normals, reproduced in torch integer and float ops.

tpuwave draws the power iteration's start vector of
``solve/chebyshev.py::estimate_lambda_max`` with
``jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)``. jax 0.9's
default generator is threefry2x32 in its partitionable form
(``jax_threefry_partitionable=True``), and ``jax.random.normal`` maps its
bits to a uniform and then through ``erf_inv``; every step is fixed
arithmetic, so :func:`threefry_normal` gives the same numbers:

* the key is ``(seed >> 32, seed & 0xffffffff)``; element i is hashed with
  the counter ``(i >> 32, i & 0xffffffff)`` (20 rounds, 5 key injections);
* float64 takes the top 52 bits of ``hi << 32 | lo``, float32 the top 23
  bits of ``hi ^ lo``, as the mantissa of a number in [1, 2); minus 1,
  scaled to [nextafter(-1, 0), 1);
* ``sqrt(2) * erfinv(u)`` with XLA's erfinv: Giles' polynomial
  approximations (single precision: degree 8 in two branches; double
  precision: three branches), the form jax's own lowering spells out.

The 32-bit words live in int64 tensors masked to 32 bits, on the device
the caller names, in chunks, so a vector of tens of millions of entries
costs a few hundred elementwise launches and no host loop.
"""

from __future__ import annotations

import math

import torch

__all__ = ["threefry_normal", "threefry_bits"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 22

# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011):
# the coefficients XLA's erf_inv lowering uses, highest power first
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k1: int, k2: int, x0, x1):
    """The threefry2x32 hash of the counter words (x0, x1) under the key
    (k1, k2); int64 tensors holding 32-bit words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_bits(seed: int, start: int, stop: int, device):
    """The two 32-bit output words of threefry2x32 for the counters
    ``start .. stop - 1`` under ``PRNGKey(seed)``, as int64 tensors."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    return _threefry2x32(seed >> 32, seed & _M32, idx >> 32, idx & _M32)


def _poly(coeffs, w):
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = c + p * w
    return p


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv in the dtype of ``x`` (float32 or float64)."""
    w = -torch.log1p(x * -x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt, _poly(_ERFINV32_LT5, w),
                        _poly(_ERFINV32_GE5, w))
    else:
        lt625, lt16 = w < 6.25, w < 16.0
        w = torch.where(lt625, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))
        p = torch.where(lt625, _poly(_ERFINV64_LT625, w),
                        torch.where(lt16, _poly(_ERFINV64_LT16, w),
                                    _poly(_ERFINV64_GE16, w)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def threefry_normal(seed: int, n: int, dtype: torch.dtype = torch.float64,
                    device="cpu") -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)`` for
    jax's default threefry2x32 (partitionable), as a tensor of ``dtype``
    (float32 or float64) on ``device``."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"threefry_normal: dtype {dtype} (float32 | float64)")
    out = torch.empty(int(n), dtype=dtype, device=device)
    lo = math.nextafter(-1.0, 0.0) if dtype == torch.float64 else float(
        torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                        torch.tensor(0.0, dtype=dtype)))
    for start in range(0, int(n), _CHUNK):
        stop = min(start + _CHUNK, int(n))
        hi, lo32 = threefry_bits(seed, start, stop, device)
        if dtype == torch.float64:
            mant = (hi << 20) | (lo32 >> 12)         # top 52 of hi:lo
            scale = 2.0 ** -52
        else:
            mant = (hi ^ lo32) >> 9                  # top 23 of hi ^ lo
            scale = 2.0 ** -23
        # [1, 2) with this mantissa, minus 1: exact in ``dtype``
        floats = mant.to(dtype) * scale
        # (maxval - minval) rounds to 2 in both dtypes
        u = torch.clamp_min(floats * 2.0 + lo, lo)
        out[start:stop] = math.sqrt(2.0) * _erfinv(u)
    return out
