"""CSR sparse matvec: the one stored sparse format of the solve phase.

Counterpart of hypre_tpu/ops/gstell.py.  On the TPU, GST-ELL packed
every stored operator into lane-shuffle slots because a TPU gather runs
at scalar speed (gstell.py:3-8).  A GPU gathers through its caches, so
the port keeps CSR as hypre's own device SpMV does
(src/seq_mv/csr_spmv_device.c:381) and serves A on levels 1-4 and every
P and R that is not dense with it.  Kernel K2 in ``csrc/csr_spmv.cu``
gives each row a fixed group of threads sized by the mean row nnz, as
hypre does (csr_spmv_device.c:300-306), each thread with four nonzeros
in flight.

``csr_spmm`` is K2-NV, the same product over a row-major block of
vectors (Y = A X, X of shape (n_cols, nv)): LOBPCG's block product,
the counterpart of the Pallas SpMV that hypre_tpu/ops/formats.py
``matmat`` (:238) vmaps over columns.  A thread works one 16-byte
piece of a row of Y (2 columns in f64, 4 in f32) and sums in K2's
order, so that column k of Y is K2's result on column k bit for bit.
One launch covers up to 16 columns in f64 and 32 in f32; a wider block
runs as panels of that width (``nv_panels``).

``csr_spmv`` and ``csr_spmm`` launch their kernel for a CUDA tensor and
run the plain version (``csr_spmv_plain``, ``csr_spmm_plain``) for a
CPU tensor; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from hypre_tpu_torch.core.errors import HypreTpuError
from hypre_tpu_torch.csrc.build import stream_ptr


def group_size(n_rows: int, nnz: int) -> int:
    """Threads per row for K2: the power of two in [2, 32] nearest to
    half the mean row nnz (on a log scale), so that a group's pass of
    four nonzeros a thread covers about two mean rows."""
    half = nnz / max(n_rows, 1) / 2
    g = 2
    while g < 32 and half >= g * math.sqrt(2):
        g *= 2
    return g


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """indptr int64[n_rows+1], indices int32[nnz], values real[nnz]
    (columns sorted within each row), on one device."""

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    n_rows: int
    n_cols: int
    group: int

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def to(self, dtype: torch.dtype) -> "CsrMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))


def csr_from_scipy(A, dtype: torch.dtype, device) -> CsrMatrix:
    A = A.tocsr()
    A.sort_indices()
    n_rows, n_cols = A.shape
    return CsrMatrix(
        indptr=torch.as_tensor(np.asarray(A.indptr, dtype=np.int64),
                               device=device),
        indices=torch.as_tensor(np.asarray(A.indices, dtype=np.int32),
                                device=device),
        values=torch.as_tensor(np.asarray(A.data), dtype=dtype,
                               device=device),
        n_rows=int(n_rows), n_cols=int(n_cols),
        group=group_size(n_rows, A.nnz))


def csr_spmv_plain(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: gather x by column, scale by the
    values, sum per row with index_add_."""
    counts = A.indptr[1:] - A.indptr[:-1]
    rows = torch.repeat_interleave(
        torch.arange(A.n_rows, device=A.values.device), counts)
    prod = torch.index_select(x.to(A.dtype), 0, A.indices) * A.values
    y = torch.zeros(A.n_rows, dtype=A.dtype, device=A.values.device)
    return y.index_add_(0, rows, prod)


_KERNELS = {torch.float64: "csr_spmv_f64", torch.float32: "csr_spmv_f32"}


@functools.cache
def _kernel(dtype: torch.dtype):
    """The C entry of K2 for `dtype`, built and loaded on first use."""
    from hypre_tpu_torch.csrc.build import load_cuda

    if dtype not in _KERNELS:
        raise HypreTpuError(f"csr_spmv: unsupported {dtype}")
    fn = getattr(load_cuda("csr_spmv.cu"), _KERNELS[dtype])
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def csr_spmv(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x: kernel K2 for a CUDA tensor, the plain version for a CPU
    tensor.  ``csr_spmv.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return csr_spmv_plain(A, x)
    if not x.is_cuda or x.device != A.values.device:
        raise HypreTpuError(f"csr_spmv: x on {x.device}, A on "
                            f"{A.values.device}")
    if x.dtype != A.dtype or x.shape != (A.n_cols,) \
            or not x.is_contiguous():
        raise HypreTpuError(
            f"csr_spmv: x must be contiguous {A.dtype} of shape "
            f"({A.n_cols},), got {x.dtype} {tuple(x.shape)}")
    fn = _kernel(A.dtype)
    y = torch.empty(A.n_rows, dtype=A.dtype, device=x.device)
    if A.n_rows == 0:
        return y
    err = fn(A.n_rows, A.group, A.indptr.data_ptr(), A.indices.data_ptr(),
             A.values.data_ptr(), x.data_ptr(), y.data_ptr(),
             stream_ptr(x.device))
    if err != 0:
        raise HypreTpuError(f"csr_spmv kernel launch failed: "
                            f"CUDA error {err}")
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0


def csr_spmm_plain(A: CsrMatrix, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2-NV: K2's plain version on each
    column."""
    return torch.stack([csr_spmv_plain(A, X[:, k])
                        for k in range(X.shape[1])], dim=1)


_MM_KERNELS = {torch.float64: "csr_spmm_f64", torch.float32: "csr_spmm_f32"}
# the 16-byte pieces of a row one K2-NV launch covers (csr_spmv.cu
# kMaxPieces): 16 columns in f64, 32 in f32
MAX_PIECES = 8


@functools.cache
def _mm_kernel(dtype: torch.dtype):
    """The C entry of K2-NV for `dtype`, built and loaded on first use."""
    from hypre_tpu_torch.csrc.build import load_cuda

    if dtype not in _MM_KERNELS:
        raise HypreTpuError(f"csr_spmm: unsupported {dtype}")
    fn = getattr(load_cuda("csr_spmv.cu"), _MM_KERNELS[dtype])
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    fn.argtypes = [i64, ctypes.c_int, ctypes.c_int, p, p, p, p, i64, p,
                   i64, p]
    fn.restype = ctypes.c_int
    return fn


def nv_panels(nv: int, item: int) -> list[tuple[int, int]]:
    """(first column, width) of each K2-NV launch over a block of nv
    columns of `item`-byte values: panels of MAX_PIECES 16-byte pieces,
    the last one narrower."""
    width = MAX_PIECES * 16 // item
    return [(k, min(width, nv - k)) for k in range(0, nv, width)]


def csr_spmm(A: CsrMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for a block X of shape (n_cols, nv) whose rows lie
    X.stride(0) apart with unit column stride (a contiguous block, or a
    column slice of a wider one): kernel K2-NV for a CUDA tensor, the
    plain version for a CPU tensor.  Y is contiguous.
    ``csr_spmm.launches`` counts kernel launches, one a panel of
    ``nv_panels``."""
    if X.device.type == "cpu":
        return csr_spmm_plain(A, X)
    if not X.is_cuda or X.device != A.values.device:
        raise HypreTpuError(f"csr_spmm: X on {X.device}, A on "
                            f"{A.values.device}")
    if X.dtype != A.dtype or X.dim() != 2 or X.shape[0] != A.n_cols \
            or (X.shape[1] > 1 and X.stride(1) != 1):
        raise HypreTpuError(
            f"csr_spmm: X must be a {A.dtype} block of shape "
            f"({A.n_cols}, nv) with unit column stride, got {X.dtype} "
            f"{tuple(X.shape)} strides {X.stride()}")
    fn = _mm_kernel(A.dtype)
    nv = X.shape[1]
    Y = torch.empty((A.n_rows, nv), dtype=A.dtype, device=X.device)
    if A.n_rows == 0 or nv == 0:
        return Y
    item = X.element_size()
    ldx = X.stride(0) if X.shape[0] > 1 else nv
    for col, width in nv_panels(nv, item):
        err = fn(A.n_rows, A.group, width, A.indptr.data_ptr(),
                 A.indices.data_ptr(), A.values.data_ptr(),
                 X.data_ptr() + col * item, ldx, Y.data_ptr() + col * item,
                 nv, stream_ptr(X.device))
        if err != 0:
            raise HypreTpuError(
                f"csr_spmm kernel launch failed on columns {col}:"
                f"{col + width} of {nv} ({A.dtype}, group {A.group}): "
                f"CUDA error {err}")
        csr_spmm.launches += 1
    return Y


csr_spmm.launches = 0
