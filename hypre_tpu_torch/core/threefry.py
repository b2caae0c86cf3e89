"""The default uniform draw of JAX, bit for bit, without JAX.

The reference's device Chebyshev setup seeds its power iteration with
``jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype)``
(hypre_tpu/solvers/amg.py:738-739).  A different start vector moves
the 20-step estimate of lambda_max, and with it the Chebyshev interval,
by far more than rounding, so the port draws the same numbers: the
Threefry-2x32 block cipher (Salmon et al., SC'11; 20 rounds) over the
counter of each element, as JAX does with ``jax_threefry_partitionable``
on (its default since jax 0.5), followed by JAX's bits-to-float step.

* key: ``PRNGKey(seed)`` is the pair (seed >> 32, seed & 0xFFFFFFFF);
* counter of element i: the 64-bit i split into (hi, lo) words;
* 32-bit draws (f32) take ``y0 ^ y1`` of the cipher's output pair,
  64-bit draws (f64) take ``(y0 << 32) | y1``;
* the float is the draw's top mantissa bits under the exponent of 1.0,
  minus 1.0, so it lies in [0, 1).

numpy uint32 arithmetic wraps as the cipher needs; the draw is made on
the host and moved to the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, on uint32 counter words (x0, x1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for block in range(5):
            for r in _ROTATIONS[block % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(block + 1) % 3]
            x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def uniform(seed: int, n: int, dtype: torch.dtype = torch.float64,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype)``,
    for dtype float32 or float64, as a torch tensor on ``device``."""
    key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    if dtype == torch.float64:
        bits = (y0.astype(np.uint64) << np.uint64(32)) | y1
        one = np.array(1.0, np.float64).view(np.uint64)
        f = ((bits >> np.uint64(64 - 52)) | one).view(np.float64) - 1.0
    elif dtype == torch.float32:
        bits = y0 ^ y1
        one = np.array(1.0, np.float32).view(np.uint32)
        f = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) \
            - np.float32(1.0)
    else:
        raise TypeError(f"uniform: dtype {dtype} is not float32/float64")
    return torch.as_tensor(f, device=device)
