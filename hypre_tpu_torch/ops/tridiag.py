"""Batched tridiagonal solves via cyclic reduction.

Port of hypre_tpu/ops/tridiag.py (``tridiag_solve`` :23), the analog of
hypre's cyclic reduction solver (ref: src/struct_ls/cyclic_reduction.c:
50-88) and the workhorse of SMG's line relaxation (ref:
src/struct_ls/smg_relax.c).  Each of the log2(n) steps eliminates the
odd unknowns of every line of the batch at once, step for step as the
reference does: an identity row appended when n is even, the 2x2 (or
1x1) system solved directly, then the odd unknowns recovered from
their even neighbours on the way back.

Systems: a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i], batched over
leading dimensions; the line axis is the LAST axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_last(x, k, value=0.0):
    return F.pad(x, (0, k), value=value)


def _shift_in(x, front: bool):
    """x with a zero prepended (front) or appended along the last axis."""
    z = torch.zeros_like(x[..., :1])
    return torch.cat([z, x] if front else [x, z], dim=-1)


def tridiag_solve(a, b, c, d):
    """Solve batched tridiagonal systems by cyclic reduction.

    a, b, c, d: tensors (..., n); a[..., 0] and c[..., n-1] are ignored.
    """
    a = a.clone()
    c = c.clone()
    a[..., 0] = 0.0
    c[..., -1] = 0.0
    orig_n = d.shape[-1]

    stack = []
    while d.shape[-1] > 2:
        n = d.shape[-1]
        if n % 2 == 0:
            # append an identity row so the last index is even (kept)
            a = _pad_last(a, 1)
            b = _pad_last(b, 1, 1.0)
            c = _pad_last(c, 1)
            d = _pad_last(d, 1)
            n += 1
        stack.append((a, b, c, d, n))

        ae, be, ce, de = a[..., 0::2], b[..., 0::2], c[..., 0::2], d[..., 0::2]
        ao, bo, co, do_ = (a[..., 1::2], b[..., 1::2], c[..., 1::2],
                           d[..., 1::2])
        # even index k couples odd neighbors 2k-1 (left) and 2k+1 (right)
        alpha = ae[..., 1:] / bo            # a_{2k} / b_{2k-1},  k >= 1
        beta = ce[..., :-1] / bo            # c_{2k} / b_{2k+1},  k <= m-1

        a_new = _shift_in(-alpha * ao, front=True)
        c_new = _shift_in(-beta * co, front=False)
        b_new = (be - _shift_in(alpha * co, front=True)
                 - _shift_in(beta * ao, front=False))
        d_new = (de - _shift_in(alpha * do_, front=True)
                 - _shift_in(beta * do_, front=False))
        a, b, c, d = a_new, b_new, c_new, d_new

    # tiny direct solve
    if d.shape[-1] == 1:
        x = d / b
    else:
        det = b[..., 0] * b[..., 1] - c[..., 0] * a[..., 1]
        x0 = (d[..., 0] * b[..., 1] - c[..., 0] * d[..., 1]) / det
        x1 = (b[..., 0] * d[..., 1] - a[..., 1] * d[..., 0]) / det
        x = torch.stack([x0, x1], dim=-1)

    # back substitution: odd unknowns from even neighbors
    for a_l, b_l, c_l, d_l, n_l in reversed(stack):
        xe = x[..., :(n_l + 1) // 2]  # deeper level may be padded
        xo = (d_l[..., 1::2]
              - a_l[..., 1::2] * xe[..., :-1]
              - c_l[..., 1::2] * xe[..., 1:]) / b_l[..., 1::2]
        out = torch.empty(d_l.shape, dtype=d_l.dtype, device=d_l.device)
        out[..., 0::2] = xe
        out[..., 1::2] = xo
        x = out
    return x[..., :orig_n]
