"""ParaSails: pruned-pattern least-squares sparse approximate inverse.

Port of hypre_tpu/solvers/parasails.py (:45; its solve :91), the
analog of hypre's ParaSails (ref: src/distributed_ls/ParaSails/
ParaSails.c:1626 ParaSailsSetupValues, :1681 the per-row least squares;
Chow, SISC 2000).  Two modes, as in the reference:

  * nonsymmetric (sym=False): one sparse M with M A ~ I; row i of M
    minimizes || e_i^T - m_i^T Atil ||_2 over the pruned pattern J_i,
    Atil the thresholded matrix, by the normal equations
    (Atil Atil^T)[J, J] m = Atil[J, i];
  * symmetric (sym=True): the factored G A G^T ~ I, delegated to FSAI's
    static pattern, as the reference does.

The little systems are solved on the host in f64 by
``setup/lapack.batched_solve``, the calls of the reference's
``jnp.linalg.solve`` (:91) on the CPU, in row chunks: M is the
reference's bit for bit.  The apply is one matvec (K2 on a CSR M).  The reference's
departures from hypre (the pattern exponent, the least squares against
the thresholded Atil) carry over unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.lapack import batched_solve
from hypre_tpu_torch.solvers.fsai import (
    CHUNK_ROWS, _little_systems, _Lookup, _pack_pattern,
)


@dataclasses.dataclass
class ParaSailsConfig:
    thresh: float = 0.1      # prune |a_ij| < thresh*sqrt(|a_ii a_jj|)
    nlevels: int = 1         # pattern = pattern(Atil^(nlevels))
    filter: float = 0.05     # post-drop |m_ij| < filter * max_j |m_ij|
    sym: bool = False        # True: factored SPD mode (FSAI)
    max_row_nnz: int = 24    # cap per-row pattern (padded batch width)


class ParaSails:
    def __init__(self, config: ParaSailsConfig | None = None):
        self.config = config or ParaSailsConfig()
        self.M = None          # SparseOp (nonsymmetric): apply M @ r
        self._fsai = None      # symmetric delegate

    def setup(self, A: sp.csr_matrix) -> "ParaSails":
        from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

        cfg = self.config
        if cfg.sym:
            from hypre_tpu_torch.solvers.fsai import FSAI, FsaiConfig

            self._fsai = FSAI(FsaiConfig(
                algo_type="static", num_levels=cfg.nlevels,
                threshold=cfg.thresh,
                max_row_nnz=cfg.max_row_nnz)).setup(A)
            return self
        A = sp.csr_matrix(A)
        A.sort_indices()
        n = A.shape[0]
        At = self._prune(A)
        pat = self._pattern(At)
        # normal equations against the pruned operator:
        #   (At At^T)[J,J] m_J = At[J, i]
        B = (At @ At.T).tocsr()
        B.sort_indices()
        gram = _Lookup(B)
        aval = _Lookup(At)
        k = pat.shape[1]
        m = np.zeros((n, k))
        for s in range(0, n, CHUNK_ROWS):
            e = min(s + CHUNK_ROWS, n)
            mats, rhs, valid, _, eye = _little_systems(
                gram, aval, pat[s:e], np.arange(s, e))
            # a tiny Tikhonov term keeps rows whose pruned gram went
            # singular solvable (the reference falls back to a pivoted
            # least squares there)
            mats = mats + 1e-12 * eye * np.abs(mats).max((1, 2))[:, None,
                                                                None]
            mc = batched_solve(mats, rhs)
            m[s:e] = np.where(valid, mc, 0.0)
        valid = pat >= 0
        # post-filter (ParaSails.c FilterValues): drop small |m_ij|
        # relative to the row max, always keeping the diagonal slot
        if cfg.filter > 0:
            rmax = np.abs(m).max(axis=1, keepdims=True)
            keep = np.abs(m) >= cfg.filter * np.maximum(rmax, 1e-300)
            keep |= pat == np.arange(n)[:, None]
            m = np.where(keep, m, 0.0)
            valid = valid & keep
        rows = np.repeat(np.arange(n), k)[valid.ravel()]
        M = sp.coo_matrix((m[valid], (rows, pat[valid])),
                          shape=(n, n)).tocsr()
        self.M = sparse_op_from_scipy(M, prefer_dia=False)
        self._M_scipy = M
        return self

    def _prune(self, A: sp.csr_matrix) -> sp.csr_matrix:
        """ParaSails.c prune: keep the diagonal and |a_ij| >= thresh *
        sqrt(|a_ii a_jj|)."""
        cfg = self.config
        d = np.sqrt(np.abs(A.diagonal()))
        coo = A.tocoo()
        keep = (coo.row == coo.col) | (
            np.abs(coo.data) >= cfg.thresh * d[coo.row] * d[coo.col])
        return sp.csr_matrix(
            (coo.data[keep], (coo.row[keep], coo.col[keep])),
            shape=A.shape)

    def _pattern(self, At: sp.csr_matrix) -> np.ndarray:
        cfg = self.config
        n = At.shape[0]
        S = At.copy()
        S.data = np.ones_like(S.data)
        P = S
        for _ in range(cfg.nlevels - 1):
            P = (P @ S).tocsr()
            P.data = np.ones_like(P.data)
        coo = P.tocoo()
        # rank candidates by |Atil^nlevels| so the cap keeps the
        # strongest couplings; the diagonal always in
        mag = np.abs(_Lookup(At)(coo.row, coo.col)) \
            if cfg.nlevels == 1 else np.ones(len(coo.row))
        mag = np.where(coo.row == coo.col, np.inf, mag)
        order = np.lexsort((-mag, coo.row))
        rows, cols = coo.row[order], coo.col[order]
        rank = np.arange(len(rows)) - np.searchsorted(rows, rows,
                                                      "left")
        sel = rank < cfg.max_row_nnz
        return _pack_pattern(n, rows[sel], cols[sel], cfg.max_row_nnz)

    def precondition(self, r):
        if self._fsai is not None:
            return self._fsai.precondition(r)
        from hypre_tpu_torch.ops.formats import matvec

        return matvec(self.M, r)
