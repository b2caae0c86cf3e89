"""Multi-source gather: the neighbour reads of the device AMG setup.

Counterpart of hypre_tpu/ops/btake.py.  The device setup
(setup/device_amg.py) reads along its operators' structure with
gathers ``y[s, i] = x[idx[s, i]]`` and row expansions
``Y[k, s, i] = X[k, idx[s, i]]``: PMIS marker reads, interpolation
neighbour reads, the SpGEMM row expansion.  Kernel K4 in
``csrc/btake.cu`` computes them.

What is not carried over: the reference's gather plan (``BtakePlan``,
``btake_plan``, ``plan_slice``, window bases, int16 lane offsets, band
buckets; btake.py:58-259) exists because a TPU gather runs at scalar
speed (btake.py:9-11) and VMEM is small.  A GPU gathers through L1/L2,
so the port takes the index set as it is, with no plan.

One departure on purpose: where ``idx < 0`` the reference leaves junk
and its callers mask; here the output holds ``fill`` there, so the
result is deterministic and a caller need not mask.

``btake_rows`` launches the kernel for CUDA tensors and runs the plain
version ``btake_rows_plain`` for CPU tensors; there is no fallback
between the two.  ``btake_rows.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hypre_tpu_torch.core.errors import HypreTpuError
from hypre_tpu_torch.csrc.build import stream_ptr

_ENTRY = {1: "btake_1", 4: "btake_4", 8: "btake_8"}


def btake_rows_plain(idx: torch.Tensor, X: torch.Tensor,
                     fill=0) -> torch.Tensor:
    """Plain PyTorch version of K4: a masked ``index_select``."""
    K = X.shape[0]
    S, n = idx.shape
    safe = idx.clamp_min(0).reshape(-1).to(torch.int64)
    Y = X.index_select(1, safe).reshape(K, S, n)
    fillv = torch.tensor(fill, dtype=X.dtype, device=X.device)
    return torch.where((idx >= 0)[None], Y, fillv)


def _fill_bits(fill, dtype: torch.dtype) -> int:
    """The bit pattern of `fill` as `dtype`, as an unsigned 64-bit int."""
    a = torch.tensor([fill], dtype=dtype).numpy().view(
        {1: np.uint8, 4: np.uint32, 8: np.uint64}[dtype.itemsize])
    return int(a[0])


@functools.cache
def _kernel(itemsize: int):
    """The C entry of K4 for `itemsize`-byte elements, built and loaded
    on first use."""
    from hypre_tpu_torch.csrc.build import load_cuda

    fn = getattr(load_cuda("btake.cu"), _ENTRY[itemsize])
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [i64, i64, i64, p, i64, p, i64, ctypes.c_uint64, p, p]
    fn.restype = ctypes.c_int
    return fn


def btake_rows(idx: torch.Tensor, X: torch.Tensor, fill=0) -> torch.Tensor:
    """Y[k, s, i] = X[k, idx[s, i]], and `fill` where idx[s, i] < 0.

    idx: int32 (S, n); X: (K, n_src) of any 1-, 4- or 8-byte dtype
    (bool, uint8, int32, float32, int64, float64).  Either may be a row
    window of a larger array (unit stride along its last dimension).
    Returns a contiguous (K, S, n) tensor of X's dtype."""
    if idx.device.type == "cpu" and X.device.type == "cpu":
        return btake_rows_plain(idx, X, fill)
    if not (idx.is_cuda and X.is_cuda and idx.device == X.device):
        raise HypreTpuError(f"btake_rows: idx on {idx.device}, X on "
                            f"{X.device}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or X.dim() != 2:
        raise HypreTpuError(
            f"btake_rows: idx must be int32 (S, n) and X (K, n_src); got "
            f"{idx.dtype} {tuple(idx.shape)} and {tuple(X.shape)}")
    if X.element_size() not in _ENTRY or X.is_complex():
        raise HypreTpuError(f"btake_rows: unsupported dtype {X.dtype}")
    if (idx.shape[1] > 1 and idx.stride(1) != 1) \
            or (X.shape[1] > 1 and X.stride(1) != 1):
        raise HypreTpuError("btake_rows: idx and X need unit stride along "
                            "their last dimension")
    K = X.shape[0]
    S, n = idx.shape
    Y = torch.empty((K, S, n), dtype=X.dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    err = _kernel(X.element_size())(
        K, S, n, idx.data_ptr(), idx.stride(0), X.data_ptr(), X.stride(0),
        _fill_bits(fill, X.dtype), Y.data_ptr(),
        stream_ptr(X.device))
    if err != 0:
        raise HypreTpuError(f"btake kernel launch failed: CUDA error {err}")
    btake_rows.launches += 1
    return Y


btake_rows.launches = 0


def btake(idx: torch.Tensor, x: torch.Tensor, fill=0) -> torch.Tensor:
    """y[s, i] = x[idx[s, i]], and `fill` where idx[s, i] < 0 (one K4
    launch on the card).  x: (n_src,)."""
    return btake_rows(idx, x[None, :], fill)[0]
