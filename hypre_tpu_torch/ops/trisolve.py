"""Wavefront-scheduled sparse triangular solve (exact l1-Gauss-Seidel).

Counterpart of hypre_tpu/ops/trisolve.py.  An exact (l1-)GS sweep
needs z = (D + T)^{-1} r with T the strict lower (forward) or upper
(backward) part of A.  Rows are grouped into wavefronts by the longest
chain of triangular couplings that ends at them (the level scheduling a
vendor sparse triangular solve performs for hypre's device hybrid GS,
relax 3/4/6/8/13/14, ref: src/parcsr_ls/par_relax.c:24); every row of a
wavefront depends only on earlier ones.  Rows are permuted into
wavefront order at setup, so each wavefront is one gather of the
solved entries, a multiply-add over its (w, m) slot block and an update
of one contiguous slice.  A 3D grid has O(nx + ny + nz) wavefronts.

Plain PyTorch: this was no Pallas kernel in the reference, so it has no
CUDA counterpart; on the card each wavefront is a few torch launches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass(frozen=True)
class WavefrontTriSolve:
    """perm: permuted position -> original row; inv_perm: the inverse;
    dinv_p: 1 / diagonal in permuted order;
    cols[k]: int64[w_k, m_k] columns, in permuted positions, of the
             strict-triangular entries of wavefront k's rows (pad 0);
             None when the wavefront has none;
    vals[k]: real[w_k, m_k] their values (pad 0);
    block_bounds: ((start, size), ...) of each wavefront."""

    perm: torch.Tensor
    inv_perm: torch.Tensor
    dinv_p: torch.Tensor
    cols: tuple
    vals: tuple
    block_bounds: tuple

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        r_p = r[self.perm]
        z_p = torch.zeros_like(r_p)
        for (s, m), cols, vals in zip(self.block_bounds, self.cols,
                                      self.vals):
            rhs = r_p[s:s + m]
            if cols is not None:
                rhs = rhs - (vals * z_p[cols]).sum(0)
            z_p[s:s + m] = rhs * self.dinv_p[s:s + m]
        return z_p[self.inv_perm]


def build_trisolve(A_scipy, d: np.ndarray, backward: bool = False, *,
                   dtype: torch.dtype, device) -> WavefrontTriSolve:
    """The wavefront structure of (D + tril/triu(A))^{-1} with diagonal
    d (the l1 norms for relax 13/14/8, the matrix diagonal for 3/4/6)."""
    from hypre_tpu_torch.setup.utils import native_enabled

    A = A_scipy.tocsr()
    n = A.shape[0]
    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        depth = native.gs_wavefronts(A, backward=backward)
    else:
        depth = _wavefronts_numpy(A, backward)

    order = np.argsort(depth, kind="stable")
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)

    T = sp.tril(A, k=-1).tocsr() if not backward else \
        sp.triu(A, k=1).tocsr()

    counts = np.bincount(depth, minlength=int(depth.max(initial=1)) + 1)
    bounds = []
    start = 0
    for k in range(1, len(counts)):
        if counts[k] == 0:
            continue
        bounds.append((start, int(counts[k])))
        start += int(counts[k])

    def put(a):
        return torch.as_tensor(a, device=device)

    cols_blocks, vals_blocks = [], []
    t_rnnz = np.diff(T.indptr)
    for s, m in bounds:
        rows = order[s:s + m]
        cnts = t_rnnz[rows]
        w = int(cnts.max(initial=0))
        if w == 0:
            cols_blocks.append(None)
            vals_blocks.append(None)
            continue
        cols = np.zeros((w, m), dtype=np.int64)
        vals = np.zeros((w, m), dtype=np.float64)
        rep = np.repeat(np.arange(m), cnts)
        within = (np.arange(int(cnts.sum()))
                  - np.repeat(np.cumsum(cnts) - cnts, cnts))
        src = np.repeat(T.indptr[rows], cnts) + within
        cols[within, rep] = inv[T.indices[src]]
        vals[within, rep] = T.data[src]
        cols_blocks.append(put(cols))
        vals_blocks.append(put(vals).to(dtype))

    return WavefrontTriSolve(
        perm=put(order.astype(np.int64)), inv_perm=put(inv),
        dinv_p=put(1.0 / d[order]).to(dtype),
        cols=tuple(cols_blocks), vals=tuple(vals_blocks),
        block_bounds=tuple(bounds))


def _wavefronts_numpy(A, backward: bool) -> np.ndarray:
    """Pure-Python twin of the native gs_wavefronts (slow; testing)."""
    n = A.shape[0]
    depth = np.zeros(n, dtype=np.int32)
    indptr, indices = A.indptr, A.indices
    rng = range(n) if not backward else range(n - 1, -1, -1)
    for i in rng:
        d = 0
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if (j < i) if not backward else (j > i):
                if depth[j] > d:
                    d = depth[j]
        depth[i] = d + 1
    return depth
