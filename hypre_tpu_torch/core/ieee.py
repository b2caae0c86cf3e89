"""A correctly rounded f64 square root from integer operations.

``torch.sqrt`` of float64 is not correctly rounded on every build: the
CPU build parts from the IEEE result (numpy's ``np.sqrt``) by one ulp on
a fraction of a percent of inputs; ``sqrt_probe.py`` counts the parts of
each side, the card's and the CPU's.  The device setup's Chebyshev
``ds = 1/sqrt(|diag|)`` must come out the same on the card and on the
CPU, and the same as the host setup's numpy one, so it takes its square
root from ``sqrt_rn``: the digit-by-digit integer square root of the
mantissa, rounded to nearest, which every device computes alike.
Division is correctly rounded on both.
"""
from __future__ import annotations

import torch

_MANT = (1 << 52) - 1


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) rounded to nearest, bit for bit the IEEE 754 result, for
    float64 x > 0 normal; zeros, infinities, NaNs and subnormals, and
    every other dtype, get ``torch.sqrt``."""
    if x.dtype != torch.float64:
        return torch.sqrt(x)
    bits = x.view(torch.int64)
    e = (bits >> 52) & 0x7FF
    normal = (e > 0) & (e < 0x7FF) & (bits > 0)
    # x = m 2^E with m < 2^54 and E even; sqrt(x) = sqrt(m 2^54) 2^(E/2-27)
    m = (bits & _MANT) | (1 << 52)
    odd = (e - 1075) & 1
    m = m << odd
    half_e = (e - 1075 - odd) >> 1
    # root = floor(sqrt(m 2^54)), a 54-bit integer, two radicand bits a
    # step: 27 pairs from m, then 27 zero pairs; rem < 2^56 throughout
    rem = torch.zeros_like(m)
    root = torch.zeros_like(m)
    for i in range(54):
        rem = rem << 2
        if i < 27:
            rem = rem | ((m >> (2 * (26 - i))) & 3)
        t = (root << 2) | 1
        ge = rem >= t
        rem = torch.where(ge, rem - t, rem)
        root = (root << 1) | ge.to(torch.int64)
    # 53 bits and a guard bit; the rest is exact iff rem == 0 (a tie
    # cannot occur: the square of a 54-bit odd integer has more bits than
    # m 2^54 holds, but round it to even all the same)
    mant = root >> 1
    up = (root & 1).bool() & ((rem != 0) | (mant & 1).bool())
    mant = mant + up.to(torch.int64)
    # mant <= 2^53 is exact in f64, and so is the product with a power
    # of two built from its bits (2^-563 .. 2^460: always normal)
    scale = ((half_e - 26 + 1023) << 52).view(torch.float64)
    y = mant.to(torch.float64) * scale
    return torch.where(normal, y, torch.sqrt(x))
