"""Schwarz: overlapping block (domain) smoother and preconditioner.

Port of hypre_tpu/solvers/schwarz.py (:34), the analog of hypre's
Schwarz smoothers (ref: src/parcsr_ls/schwarz.c; variants in
HYPRE_parcsr_ls.h).  Domains are contiguous row blocks with symmetric
overlap; each subdomain solve is a dense inverse, all of them taken at
setup by one numpy ``inv`` over (n_blocks, k, k), as in the reference,
so the block inverses are the reference's bit for bit.  The apply is a
gather of the blocks' residuals, one batched ``torch.bmm`` and a
scatter-add (the reference's jnp einsum and ``.at[].add``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass
class SchwarzConfig:
    block_size: int = 32
    overlap: int = 4
    weight: float = 1.0
    # hypre Schwarz variants (schwarz.c, HYPRE_parcsr_ls.h SetVariant):
    # "additive" (variant 2); "multiplicative", block Gauss-Seidel over
    # a 2-coloring of the overlapping chain (variant 0's sweep in
    # data-parallel form); "sym-multiplicative" (variant 3) sweeps the
    # colors forward then back, keeping the operator symmetric for PCG
    variant: str = "additive"


class Schwarz:
    def __init__(self, config: SchwarzConfig | None = None):
        self.config = config or SchwarzConfig()
        self.block_inv = None    # (n_blocks, k, k)
        self.starts = None
        self.n = 0

    def setup(self, A: sp.csr_matrix) -> "Schwarz":
        cfg = self.config
        A = A.tocsr()
        n = A.shape[0]
        bs, ov = cfg.block_size, cfg.overlap
        k = bs + 2 * ov
        starts = np.arange(0, n, bs) - ov
        n_blocks = len(starts)

        # the dense blocks A[s:s+k, s:s+k], clipped, identity-padded
        blocks = np.zeros((n_blocks, k, k))
        eye = np.eye(k)
        for bi, s in enumerate(starts):
            lo, hi = max(s, 0), min(s + k, n)
            o0 = lo - s
            blocks[bi] = eye
            blocks[bi, o0:o0 + (hi - lo), o0:o0 + (hi - lo)] = \
                A[lo:hi, lo:hi].toarray()

        self._set_blocks(np.linalg.inv(blocks), starts, n)
        if cfg.variant != "additive":
            if 2 * ov > bs:
                raise ValueError(
                    "multiplicative variants need 2*overlap <= "
                    "block_size (2-colorable overlap chain)")
            from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

            self._Aop = sparse_op_from_scipy(A, prefer_dia=False)
        return self

    def _set_blocks(self, block_inv: np.ndarray, starts: np.ndarray,
                    n: int) -> None:
        """The block inverses on the device, each block's (padded) row
        positions, and the scalar damping."""
        from hypre_tpu_torch.core.config import get_config, get_device

        dtype, device = get_config().real_dtype, get_device()
        k = block_inv.shape[1]
        self.n, self.k, self.starts = int(n), k, starts
        self.block_inv = torch.as_tensor(block_inv, dtype=dtype,
                                         device=device)
        # r is padded by k a side: block b reads rows starts[b] + [0, k)
        self._idx = torch.as_tensor(
            starts[:, None] + np.arange(k)[None, :] + k, device=device)
        # scalar damping keeps the operator symmetric (needed for PCG);
        # per-row overlap weights would break symmetry
        count = np.zeros(n)
        for s in starts:
            count[max(s, 0):min(s + k, n)] += 1.0
        self._damp = float(self.config.weight / count.max())

    def _solve_blocks(self, r, inv, idx):
        """sum over the blocks b of R_b^T inv_b R_b r (blocks `idx`)."""
        k, n = self.k, self.n
        pad = torch.nn.functional.pad(r, (k, k))
        xw = torch.bmm(inv, pad[idx].unsqueeze(2)).squeeze(2)
        out = torch.zeros(n + 2 * k, dtype=r.dtype, device=r.device)
        out.index_add_(0, idx.reshape(-1), xw.reshape(-1))
        return out[k:k + n]

    def precondition(self, r):
        """additive: x = W^-1 sum_b R_b^T A_b^-1 R_b r; multiplicative:
        block GS over the 2-coloring; sym-multiplicative adds the
        reverse color sweep."""
        from hypre_tpu_torch.ops.formats import matvec

        cfg = self.config
        if cfg.variant == "additive":
            return self._solve_blocks(r, self.block_inv, self._idx) \
                * self._damp
        order = [0, 1] if cfg.variant == "multiplicative" else [0, 1, 0]
        x = self._solve_blocks(r, self.block_inv[order[0]::2],
                               self._idx[order[0]::2])
        for color in order[1:]:
            r_cur = r - matvec(self._Aop, x)
            x = x + self._solve_blocks(r_cur, self.block_inv[color::2],
                                       self._idx[color::2])
        return x
