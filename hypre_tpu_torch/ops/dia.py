"""Diagonal-storage (DIA) operators and their matvec, kernel K3.

Counterpart of hypre_tpu/ops/formats.py ``DiaMatrix`` (:69-91),
``dia_matvec`` (:163-169) and ``dia_from_scipy`` (:281-303), and of the
TPU kernel hypre_tpu/ops/dia_pallas.py ``dia_matvec_pallas``.  A
stencil-like matrix (the same few offsets on every row, e.g. a
generated Laplacian wrapped by the ij driver) is stored as one value
array per diagonal, ``vals[d, i] = A[i, i + offsets[d]]``, so its
matvec reads no column indices.

``dia_matvec`` launches kernel K3 (``csrc/dia_matvec.cu``) for a CUDA
tensor and runs the plain version ``dia_matvec_plain`` for a CPU tensor;
there is no fallback between the two.  K3 has two instances: up to
``MAX_DIAGS`` diagonals the offsets travel in the kernel's by-value
argument ("param"); past that they are read from a device array
("wide").
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing

import numpy as np
import torch

from hypre_tpu_torch.core.errors import HypreTpuError
from hypre_tpu_torch.csrc.build import stream_ptr

_NP_REAL = {torch.float64: np.float64, torch.float32: np.float32}
MAX_DIAGS = 40     # kMaxDiags of csrc/dia_matvec.cu


class K3Args(typing.NamedTuple):
    """instance: "param" or "wide"; packed: int64 {min offset, max
    offset, offsets...}, which the "param" entry copies into the
    kernel's by-value argument, and its address, for ctypes."""

    instance: str
    packed: np.ndarray
    packed_ptr: int


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """vals: real[n_diags, n_rows], vals[d, i] = A[i, i + offsets[d]]
    (zero where the entry is absent or out of range); offsets: sorted
    tuple of ints; n_cols: the number of columns."""

    vals: torch.Tensor
    offsets: tuple
    n_cols: int

    @property
    def n_rows(self) -> int:
        return int(self.vals.shape[1])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @functools.cached_property
    def offsets_dev(self) -> torch.Tensor:
        """The offsets as int64 on vals' device (K3's "wide" instance
        reads them there)."""
        return torch.tensor(self.offsets, dtype=torch.int64,
                            device=self.vals.device)

    @functools.cached_property
    def launch_args(self) -> K3Args:
        """K3's argument, packed once per matrix."""
        offs = list(self.offsets)
        ends = [min(offs), max(offs)] if offs else [0, 0]
        packed = np.array(ends + offs, dtype=np.int64)
        return K3Args("param" if len(offs) <= MAX_DIAGS else "wide",
                      packed, packed.ctypes.data)


def dia_from_scipy(A, dtype: torch.dtype, device,
                   max_diags: int = 40) -> DiaMatrix | None:
    """A as a DiaMatrix if it has at most max_diags distinct offsets,
    else None: the reference's offsets and values bit for bit, including
    its early reject on a sample of the entries."""
    A = A.tocsr()
    n_rows, n_cols = A.shape
    row = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(A.indptr))
    offs = A.indices.astype(np.int64) - row
    # cheap reject before the full unique: a sample of entries already
    # exceeding max_diags distinct offsets proves the full set does too
    if len(offs) > 1 << 20:
        if len(np.unique(offs[:: len(offs) // (1 << 16)])) > max_diags:
            return None
    uniq = np.unique(offs)
    if len(uniq) > max_diags:
        return None
    vals = np.zeros((len(uniq), n_rows), dtype=_NP_REAL[dtype])
    vals[np.searchsorted(uniq, offs), row] = A.data
    return DiaMatrix(vals=torch.as_tensor(vals, device=device),
                     offsets=tuple(int(d) for d in uniq), n_cols=int(n_cols))


def dia_matvec_plain(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: the diagonals summed in offset order,
    one shifted multiply-add each (the order of formats.dia_matvec)."""
    x = x.to(A.dtype)
    n = A.n_rows
    y = torch.zeros(n, dtype=A.dtype, device=A.vals.device)
    for k, d in enumerate(A.offsets):
        lo, hi = max(0, -d), min(n, A.n_cols - d)
        if hi > lo:
            y[lo:hi] += A.vals[k, lo:hi] * x[lo + d:hi + d]
    return y


_KERNELS = {torch.float64: "f64", torch.float32: "f32"}


@functools.cache
def _kernel(dtype: torch.dtype, instance: str):
    """The C entry of K3's `instance` for `dtype`, built and loaded on
    first use."""
    from hypre_tpu_torch.csrc.build import load_cuda

    if dtype not in _KERNELS:
        raise HypreTpuError(f"dia_matvec: unsupported {dtype}")
    name = ("dia_matvec_" if instance == "param" else "dia_matvec_wide_") \
        + _KERNELS[dtype]
    fn = getattr(load_cuda("dia_matvec.cu"), name)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [i64, i64, ctypes.c_int, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def dia_matvec(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x: kernel K3 for a CUDA tensor, the plain version for a CPU
    tensor.  ``dia_matvec.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return dia_matvec_plain(A, x)
    if not x.is_cuda or x.device != A.vals.device:
        raise HypreTpuError(f"dia_matvec: x on {x.device}, A on "
                            f"{A.vals.device}")
    if x.dtype != A.dtype or x.shape != (A.n_cols,) \
            or not x.is_contiguous():
        raise HypreTpuError(
            f"dia_matvec: x must be contiguous {A.dtype} of shape "
            f"({A.n_cols},), got {x.dtype} {tuple(x.shape)}")
    if not A.vals.is_contiguous():
        raise HypreTpuError("dia_matvec: vals must be contiguous")
    args = A.launch_args
    fn = _kernel(A.dtype, args.instance)
    offsets = args.packed_ptr if args.instance == "param" \
        else A.offsets_dev.data_ptr()
    y = torch.empty(A.n_rows, dtype=A.dtype, device=x.device)
    err = fn(A.n_rows, A.n_cols, len(A.offsets), offsets,
             A.vals.data_ptr(), x.data_ptr(), y.data_ptr(),
             stream_ptr(x.device))
    if err != 0:
        raise HypreTpuError(f"dia_matvec kernel launch failed: "
                            f"CUDA error {err}")
    dia_matvec.launches += 1
    return y


dia_matvec.launches = 0
