"""Floating-point sums in the order in which the reference's compiler
adds them, so that the device setup reproduces hypre_tpu's hierarchy
bit for bit.

The reference (hypre_tpu/setup/device_amg.py) runs on XLA.  The order
matched here is that of XLA's CPU compiler in jax/jaxlib 0.9.0, found by
experiment: a sum over an axis longer than 32 becomes sums of 32-long
windows (the axis padded with zeros, half before and half after) and
then a sum of the window sums; a cumulative sum longer than 16 becomes
16-long blocks plus a scan of the block totals.  Another XLA version may
order them otherwise; the port's tests against the reference then fail
on the 27-pt hierarchy first.

Why the order matters: ext+i truncation keeps the largest entries of a
row, and a 27-pt stencil's rows hold many entries that are equal in
exact arithmetic, so a last-bit difference anywhere upstream (the
interpolation sums, the RAP's run sums, the truncation's rescaling)
changes which entries are kept, and with them every coarser level.
The strength threshold of the next level is the other test that a
last-bit difference can flip.  So every sum whose value reaches a later
level's structure goes through this module; the l1 norms (which reach
only the smoother) and the diagonal (one entry a row) do not.

The sums are built from cumulative sums along an outer axis, which
torch computes sequentially on the CPU and on the card alike (its
torch.sum and inner-axis scans associate differently, and a 1-D scan on
the card is parallel: hence the extra column when m == 1).  The width
of each coarse A is rounded up to the reference's bucket
(device_amg.dell_pad_width) for the same reason: the padded width sets
the windows.
"""
from __future__ import annotations

import torch

SUM_WINDOW = 32
SCAN_BLOCK = 16


def _seq_scan(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sequential inclusive sum along `dim` (not the last axis)."""
    if x.shape[-1] == 1:
        return torch.cat([x, torch.zeros_like(x)], -1).cumsum(dim)[..., :1]
    return x.cumsum(dim)


def _pad_same(x: torch.Tensor, dim: int, width: int):
    """Pad `dim` with zeros up to a multiple of `width`, half of the
    padding before (rounded down), the rest after."""
    d = x.shape[dim]
    nb = -(-d // width)
    pad = nb * width - d
    lo = pad // 2
    shape = list(x.shape)
    shape[dim] = lo
    parts = [x.new_zeros(shape), x]
    shape[dim] = pad - lo
    parts.append(x.new_zeros(shape))
    return torch.cat(parts, dim), nb


def sum0(x: torch.Tensor, length: int | None = None) -> torch.Tensor:
    """Sum over the leading (slot) axis of (k, ...).

    length: sum as the reference sums a list of that many slots whose
    slots past k are empty (zero), without storing them."""
    k = x.shape[0]
    L = k if length is None else length
    W = SUM_WINDOW
    if L <= W:
        return _seq_scan(x, 0)[-1]
    nb = -(-L // W)
    lo = (nb * W - L) // 2
    nbd = -(-(lo + k) // W)                 # windows that hold entries
    rest = x.shape[1:]
    xp = torch.cat([x.new_zeros((lo, *rest)), x,
                    x.new_zeros((nbd * W - lo - k, *rest))])
    sums = _seq_scan(xp.reshape(nbd, W, *rest), 1)[:, -1]
    if nbd < nb:
        sums = torch.cat([sums, sums.new_zeros((nb - nbd, *rest))])
    return sum0(sums)


def sum01(x: torch.Tensor) -> torch.Tensor:
    """Sum over the two leading axes of (w0, w1, m) (windows of 32 x 32,
    each summed in row-major order)."""
    w0, w1, m = x.shape
    W = SUM_WINDOW
    if w0 <= W and w1 <= W:
        return _seq_scan(x.reshape(w0 * w1, m), 0)[-1]
    xp, n0 = _pad_same(x, 0, W)
    xp, n1 = _pad_same(xp, 1, W)
    blocks = xp.reshape(n0, W, n1, W, m).permute(0, 2, 1, 3, 4) \
        .reshape(n0, n1, W * W, m)
    return sum01(_seq_scan(blocks, 2)[:, :, -1])


def cumsum0(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the leading axis of (k, m).  The
    value at a position depends only on the entries before it, not on
    k."""
    k, m = x.shape
    B = SCAN_BLOCK
    if k <= B:
        return _seq_scan(x, 0)
    nb = -(-k // B)
    xp = torch.cat([x, x.new_zeros((nb * B - k, m))])
    inner = _seq_scan(xp.reshape(nb, B, m), 1)
    outer = cumsum0(inner[:, -1])
    outer_ex = torch.cat([outer.new_zeros((1, m)), outer[:-1]])
    return (outer_ex[:, None] + inner).reshape(nb * B, m)[:k]
