"""Block-ELL: dense nf x nf blocks per nonzero, hypre's block ParCSR
(ref: src/parcsr_block_mv/csr_block_matrix.h:32, csr_block_matrix.c
block matvec/matmat) for systems problems.

Counterpart of hypre_tpu/ops/block_ell.py, in plain torch: the block
axis pair rides as trailing dims of a slot-major ELL and the matvec
contracts them with einsum.  The reference reaches no Pallas kernel
here, so the port has no CUDA kernel for it either; nothing on the
solve path of BoomerAMG calls it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BlockEllMatrix:
    """cols: int32[w, n_nodes]        block-column ids (-1 padding)
    vals: real [w, n_nodes, nf, nf]   dense blocks (0 padding)
    n_cols: number of block columns
    """

    cols: torch.Tensor
    vals: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return int(self.cols.shape[1])

    @property
    def block_size(self) -> int:
        return int(self.vals.shape[-1])

    @property
    def shape(self):
        nf = self.block_size
        return (self.n_rows * nf, self.n_cols * nf)


def block_ell_from_scipy(A, num_functions: int, dtype=None,
                         device=None) -> BlockEllMatrix:
    """Interleaved scalar CSR -> block-ELL (dof i = node i//nf,
    function i%nf, hypre's interleaved ordering).  dtype and device
    default to the configured ones."""
    from hypre_tpu_torch.core.config import get_config, get_device

    dtype = dtype or get_config().real_dtype
    device = device if device is not None else get_device()
    A = A.tocsr()
    n, m = A.shape
    nf = num_functions
    if n % nf or m % nf:
        raise ValueError("shape not divisible by block size")
    nr, nc = n // nf, m // nf
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    node_r = rows // nf
    node_c = A.indices // nf
    fr = rows % nf
    fc = A.indices % nf
    # distinct block columns per block row
    key = node_r.astype(np.int64) * nc + node_c
    uk = np.unique(key)
    ur = (uk // nc).astype(np.int64)
    counts = np.bincount(ur, minlength=nr)
    w = max(int(counts.max(initial=0)), 1)
    slot_of_uk = np.arange(len(uk)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    cols = np.full((w, nr), -1, np.int32)
    cols[slot_of_uk, ur] = (uk % nc).astype(np.int32)
    vals = np.zeros((w, nr, nf, nf), dtype=np.float64)
    slot = slot_of_uk[np.searchsorted(uk, key)]
    vals[slot, node_r, fr, fc] = A.data
    return BlockEllMatrix(cols=torch.as_tensor(cols, device=device),
                          vals=torch.as_tensor(vals, dtype=dtype,
                                               device=device),
                          n_cols=int(nc))


def _gather_blocks(A: BlockEllMatrix, xb: torch.Tensor) -> torch.Tensor:
    """xb[cols] per slot, zero where the slot is padding."""
    valid = A.cols >= 0
    g = xb[torch.where(valid, A.cols, 0).long()]
    shape = valid.shape + (1,) * (g.dim() - 2)
    return torch.where(valid.reshape(shape), g, 0.0)


def block_matvec(A: BlockEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x with x of length n_cols*nf (interleaved): whole
    nf-vectors gathered per block column, then one batched einsum."""
    g = _gather_blocks(A, x.reshape(A.n_cols, A.block_size))  # (w, n, nf)
    return torch.einsum("wnij,wnj->ni", A.vals, g).reshape(-1)


def block_matmat(A: BlockEllMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for a multivector X (n_cols*nf, k)."""
    k = X.shape[1]
    g = _gather_blocks(A, X.reshape(A.n_cols, A.block_size, k))
    return torch.einsum("wnij,wnjk->nik", A.vals, g).reshape(-1, k)


def block_diag_inv(A: BlockEllMatrix) -> torch.Tensor:
    """(n, nf, nf) inverse of each diagonal block: the block-Jacobi
    smoother operand (csr_block_matrix.c BlockInvMult analog)."""
    row = torch.arange(A.n_rows, dtype=A.cols.dtype,
                       device=A.cols.device)[None, :]
    is_diag = (A.cols == row).to(A.vals.dtype)
    D = torch.einsum("wn,wnij->nij", is_diag, A.vals)
    return torch.linalg.inv(D)


def block_jacobi(A: BlockEllMatrix, dinv_blocks, b, u=None,
                 weight: float = 1.0, sweeps: int = 1):
    """Block-Jacobi relaxation u += w * D_block^-1 (b - A u)."""
    nf = A.block_size
    for _ in range(sweeps):
        r = b if u is None else b - block_matvec(A, u)
        z = torch.einsum("nij,nj->ni", dinv_blocks,
                         r.reshape(-1, nf)).reshape(-1) * weight
        u = z if u is None else u + z
    return u
