"""Solve-phase operator formats and the matvec dispatch.

Counterpart of hypre_tpu/ops/formats.py, cut to what the port's solve
phase stores:

* ``StencilOp`` (ops/stencil.py) — level 0 of a generated stencil
  problem, applied analytically by kernel K1;
* ``DiaMatrix`` (ops/dia.py) — stencil-like operators of at most 32
  diagonals, applied by kernel K3;
* ``CsrMatrix`` (ops/spmv.py) — every other stored sparse operator,
  applied by kernel K2;
* ``DenseMatrix`` — operators of at most 2048 rows and columns, applied
  with one ``torch.mv`` (the reference computes these with ``jnp.dot``
  outside any Pallas kernel, formats.py:124-127).

The reference's ELL and GST-ELL formats are not carried over: CSR takes
their place on the card.

``sparse_op_from_dell`` packs an operator of the device setup (a
``setup/device_amg.DEll`` on the card) straight into these formats with
no host round trip: the counterpart of hypre_tpu/ops/gstell_device.py
``sparse_op_from_dell`` / ``dense_from_dell`` (:367-389).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.ops.dia import DiaMatrix, dia_from_scipy, dia_matvec
from hypre_tpu_torch.ops.spmv import (
    CsrMatrix, csr_from_scipy, csr_spmm, csr_spmv, group_size,
)
from hypre_tpu_torch.ops.stencil import StencilOp, stencil_matvec

DENSE_MAX = 2048   # dense at this many rows and columns or fewer
# DIA only while x fits this many bytes in f32: the TPU kernel's VMEM
# operand limit (formats.py:316), kept so that the port picks the format
# the reference picks (ROADMAP Queue 3)
DIA_MAX_X_BYTES = 5 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense storage for small coarse-grid operators."""

    vals: torch.Tensor       # (n_rows, n_cols)

    @property
    def n_rows(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.vals.shape[1])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)


SparseOp = StencilOp | DiaMatrix | CsrMatrix | DenseMatrix


def dense_from_scipy(A, dtype: torch.dtype, device) -> DenseMatrix:
    return DenseMatrix(vals=torch.as_tensor(
        np.asarray(A.toarray()), dtype=dtype, device=device))


def matvec(A: SparseOp, x: torch.Tensor) -> torch.Tensor:
    if isinstance(A, StencilOp):
        return stencil_matvec(A, x)
    if isinstance(A, DiaMatrix):
        return dia_matvec(A, x)
    if isinstance(A, CsrMatrix):
        return csr_spmv(A, x)
    if isinstance(A, DenseMatrix):
        return torch.mv(A.vals, x)
    raise TypeError(f"matvec: unsupported operator {type(A).__name__}")


def matmat(A: SparseOp, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for a block X of shape (n, nv), the counterpart of the
    reference's matmat (formats.py:205): CSR on K2-NV (where the
    reference vmaps its Pallas SpMV over the columns, :238), dense as
    one torch.matmul (the reference's jnp.dot, :216-220), DIA and
    stencil operators by their own kernel (K3, K1) column by column
    (the reference shifts X in jnp for DIA, :221-234)."""
    if X.dim() == 1:
        return matvec(A, X)
    if isinstance(A, CsrMatrix):
        return csr_spmm(A, X.contiguous())
    if isinstance(A, DenseMatrix):
        return torch.matmul(A.vals, X)
    return torch.stack([matvec(A, X[:, k].contiguous())
                        for k in range(X.shape[1])], dim=1)


def sparse_op_from_scipy(A, dtype: torch.dtype | None = None,
                         device=None, prefer_dia: bool = True) -> SparseOp:
    """The reference's format choice (formats.py:306-334), step by step:
    dense at 2048 rows and columns or fewer; then, when prefer_dia and
    the f32 x fits DIA_MAX_X_BYTES, DIA if the matrix has at most 32
    offsets and fills at least half of those diagonals; CSR otherwise,
    in place of the reference's GST-ELL and ELL.  The reference's second
    DIA try (:330-333) runs only when GST-ELL refuses a matrix, which
    CSR never does, so it is not carried over.  dtype and device
    default to the configured ones."""
    from hypre_tpu_torch.core.config import get_config, get_device

    dtype = dtype or get_config().real_dtype
    device = device if device is not None else get_device()
    if max(A.shape) <= DENSE_MAX and min(A.shape) > 0:
        return dense_from_scipy(A, dtype, device)
    if prefer_dia and A.shape[1] * 4 <= DIA_MAX_X_BYTES:
        D = dia_from_scipy(A, dtype, device, max_diags=32)
        if D is not None and A.nnz >= 0.5 * len(D.offsets) * A.shape[0]:
            return D
    return csr_from_scipy(A, dtype, device)


def dense_from_dell(M, dtype: torch.dtype | None = None) -> DenseMatrix:
    """A device-setup operator (slot-major cols/vals) as a DenseMatrix on
    its own device (small coarse levels)."""
    from hypre_tpu_torch.core.config import get_config

    dtype = dtype or get_config().real_dtype
    w, n = M.cols.shape
    valid = M.cols >= 0
    rows = torch.arange(n, device=M.cols.device)[None, :].expand(w, n)
    flat = (rows * M.n_cols + M.cols)[valid]
    dense = torch.zeros(n * M.n_cols, dtype=dtype, device=M.cols.device)
    dense.index_add_(0, flat, M.vals[valid].to(dtype))
    return DenseMatrix(vals=dense.reshape(n, M.n_cols))


def csr_from_dell(M, dtype: torch.dtype | None = None) -> CsrMatrix:
    """A device-setup operator as a CsrMatrix on its own device: each
    row's valid slots, in slot order (ascending columns)."""
    from hypre_tpu_torch.core.config import get_config

    dtype = dtype or get_config().real_dtype
    cols_t = M.cols.t()                                  # (n, w) view
    valid = cols_t >= 0
    counts = valid.sum(1)
    indptr = torch.zeros(M.n_rows + 1, dtype=torch.int64,
                         device=M.cols.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    nnz = int(indptr[-1])
    return CsrMatrix(
        indptr=indptr, indices=cols_t[valid].to(torch.int32),
        values=M.vals.t()[valid].to(dtype), n_rows=M.n_rows,
        n_cols=M.n_cols, group=group_size(M.n_rows, nnz))


def sparse_op_from_dell(M, dtype: torch.dtype | None = None) -> SparseOp:
    """Format dispatch for device-built operators, the twin of
    sparse_op_from_scipy: dense at 2048 rows and columns or fewer, CSR
    otherwise."""
    if max(M.shape) <= DENSE_MAX and min(M.shape) > 0:
        return dense_from_dell(M, dtype)
    return csr_from_dell(M, dtype)
