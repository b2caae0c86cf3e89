"""FSAI: factorized sparse approximate inverse preconditioner.

Port of hypre_tpu/solvers/fsai.py (:52-246), the analog of hypre's FSAI
(ref: src/parcsr_ls/par_fsai.c:16, setup par_fsai_setup.c:406).  For
SPD A it builds a sparse lower-triangular G with G A G^T ~ I (G ~ L^-1
for A = L L^T); M^-1 r = G^T (G r) is two sparse matvecs (K2 on a CSR G
and G^T, torch.mv when they are dense).

Per row i with lower pattern J_i = {j < i : (i, j) in the pattern}:
    solve  A[J_i, J_i] g_i = -A[J_i, i],  G[i, J_i] = g_i,  G[i, i] = 1,
    and scale row i by 1/sqrt((G A G^T)_ii).
The little systems are solved on the host in f64 by
``setup/lapack.batched_solve``, the LAPACK and BLAS calls that the
reference's ``jnp.linalg.solve`` (:89) makes on the CPU, in row chunks
that bound the setup's memory: G is the reference's bit for bit, and so
is the adaptive pattern, which ranks magnitudes that tie exactly on a
Laplacian.

Two pattern modes (hypre algo_type): "static", the lower triangle of
pattern(A^num_levels), threshold filtered; "adaptive" (hypre's
default), grown by the Kaporin gradient kg(i, j) = 2 (G_cur A)_ij for
j < i outside the current pattern, the max_step_size largest |kg| a row
a step, until psi = (G A G^T)_ii stalls (kap_tolerance).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.lapack import batched_solve

# rows of little systems solved at once: bounds the (rows, k, k)
# temporaries of _batched_g
CHUNK_ROWS = 1 << 16


@dataclasses.dataclass
class FsaiConfig:
    algo_type: str = "adaptive"    # hypre default; or "static"
    # static-pattern knobs
    num_levels: int = 1        # pattern = tril(pattern(A^num_levels))
    threshold: float = 0.01    # drop |a_ij| < threshold * sqrt(aii*ajj)
    max_row_nnz: int = 8       # cap on pattern row size (k)
    # adaptive knobs (par_fsai.c defaults: max_steps 3, step_size 5,
    # kap_tolerance 1e-3)
    max_steps: int = 3
    max_step_size: int = 5
    kap_tolerance: float = 1e-3


class _Lookup:
    """Vectorized (i, j) -> a_ij of a canonical CSR matrix: the native
    ``csr_lookup`` (a binary search a query, OpenMP) or, with the native
    setup off, a search on sorted flat keys; the same values."""

    def __init__(self, A: sp.csr_matrix):
        from hypre_tpu_torch.setup.utils import native_enabled

        n = A.shape[0]
        self.n = n
        if native_enabled():
            self.A = A if A.has_sorted_indices else A.sorted_indices()
            return
        self.A = None
        keys = (np.repeat(np.arange(n), np.diff(A.indptr))
                .astype(np.int64) * n + A.indices)
        order = np.argsort(keys)
        self.keys = keys[order]
        self.vals = A.data[order]

    def __call__(self, i_arr, j_arr):
        if self.A is not None:
            from hypre_tpu_torch.csrc import build as native

            return native.csr_lookup(self.A, i_arr, j_arr)
        keys = i_arr.astype(np.int64) * self.n + j_arr
        p = np.searchsorted(self.keys, keys)
        p = np.minimum(p, len(self.keys) - 1)
        hit = self.keys[p] == keys
        return np.where(hit, self.vals[p], 0.0)


def _little_systems(lookup: _Lookup, rhs_lookup: _Lookup, pat, rows):
    """The padded little systems of the pattern rows `pat` (rows, k):
    mats[r] = M[J, J] (identity on padding) and rhs[r] = R[J, row]."""
    m, k = pat.shape
    pat_safe = np.where(pat >= 0, pat, 0)
    mats = lookup(
        pat_safe[:, :, None].repeat(k, 2).ravel(),
        pat_safe[:, None, :].repeat(k, 1).ravel()).reshape(m, k, k)
    rhs = rhs_lookup(pat_safe.ravel(), np.repeat(rows, k)).reshape(m, k)
    valid = pat >= 0
    vmask = valid[:, :, None] & valid[:, None, :]
    eye = np.arange(k)[None, :, None] == np.arange(k)[None, None, :]
    mats = np.where(vmask, mats, 0.0) + np.where(
        ~valid[:, :, None] & eye, 1.0, 0.0)
    return mats, np.where(valid, rhs, 0.0), valid, vmask, eye


def _batched_g(lookup: _Lookup, diag, pat):
    """Solve the per-row little systems of a padded pattern (n, k):
    returns (g, psi, valid) with psi = (G A G^T)_ii before scaling."""
    n, k = pat.shape
    g = np.zeros((n, k))
    psi = np.zeros(n)
    for s in range(0, n, CHUNK_ROWS):
        e = min(s + CHUNK_ROWS, n)
        mats, rhs, valid, vmask, _ = _little_systems(
            lookup, lookup, pat[s:e], np.arange(s, e))
        gc = batched_solve(mats, -rhs)
        gc = np.where(valid, gc, 0.0)
        # psi = a_ii + 2 g.A[J,i] + g.A[J,J].g  (== a_ii + g.A[J,i] at
        # the exact solve; the general form holds for singular blocks)
        quad = np.einsum("nk,nkl,nl->n", gc, mats * vmask, gc)
        lin = np.einsum("nk,nk->n", gc, rhs)
        psi[s:e] = diag[s:e] + 2 * lin + quad
        g[s:e] = gc
    return g, psi, pat >= 0


class FSAI:
    def __init__(self, config: FsaiConfig | None = None):
        self.config = config or FsaiConfig()
        self.G = None          # SparseOp, lower triangular
        self.Gt = None         # SparseOp, G^T

    def setup(self, A: sp.csr_matrix) -> "FSAI":
        cfg = self.config
        A = A.tocsr()
        A.sort_indices()
        if cfg.algo_type == "adaptive":
            pat = self._adaptive_pattern(A)
        else:
            pat = self._static_pattern(A)
        return self._assemble(A, pat)

    # -- patterns -----------------------------------------------------

    def _static_pattern(self, A) -> np.ndarray:
        cfg = self.config
        n = A.shape[0]
        diag = A.diagonal()
        Pat = A.copy()
        Pat.data = np.ones_like(Pat.data)
        Pw = Pat
        for _ in range(cfg.num_levels - 1):
            Pw = (Pw @ Pat).tocsr()
            Pw.data = np.ones_like(Pw.data)
        Pw = sp.tril(Pw, k=-1).tocsr()

        scale = np.sqrt(np.abs(diag))
        coo = Pw.tocoo()
        aval = np.asarray(A[coo.row, coo.col]).ravel() \
            if cfg.num_levels == 1 else None
        if aval is not None:
            keep = np.abs(aval) >= cfg.threshold * scale[coo.row] \
                * scale[coo.col]
        else:
            keep = np.ones(len(coo.row), dtype=bool)
        rows, cols = coo.row[keep], coo.col[keep]
        mag = np.abs(aval[keep]) if aval is not None \
            else np.ones(len(rows))
        order = np.lexsort((-mag, rows))
        rows, cols = rows[order], cols[order]
        rank = np.arange(len(rows)) - np.searchsorted(rows, rows,
                                                      side="left")
        sel = rank < cfg.max_row_nnz
        rows, cols = rows[sel], cols[sel]
        return _pack_pattern(n, rows, cols, cfg.max_row_nnz)

    def _adaptive_pattern(self, A) -> np.ndarray:
        """Kaporin-gradient pattern growth (par_fsai_setup.c:406)."""
        cfg = self.config
        n = A.shape[0]
        diag = A.diagonal()
        lookup = _Lookup(A)
        cap = cfg.max_steps * cfg.max_step_size
        pat = np.full((n, cap), -1, dtype=np.int64)
        cnt = np.zeros(n, dtype=np.int64)
        psi = diag.copy()
        active = np.ones(n, dtype=bool)
        active[0] = False              # row 0 has no lower entries
        g = np.zeros((n, cap))

        for _ in range(cfg.max_steps):
            if not active.any():
                break
            # G_cur with unit diagonal and current g on the pattern
            vr = pat >= 0
            Gc = sp.coo_matrix(
                (np.concatenate([g[vr], np.ones(n)]),
                 (np.concatenate([np.repeat(np.arange(n), cap)[
                     vr.ravel()], np.arange(n)]),
                  np.concatenate([pat[vr], np.arange(n)]))),
                shape=(n, n)).tocsr()
            KG = sp.tril(Gc @ A, k=-1).tocoo()
            # drop entries already in the pattern and frozen rows
            in_pat = np.zeros(len(KG.row), dtype=bool)
            if vr.any():
                pk = pat[vr] + np.repeat(np.arange(n),
                                         cap)[vr.ravel()] * n
                kk = KG.col + KG.row.astype(np.int64) * n
                in_pat = np.isin(kk, pk)
            keep = (~in_pat) & active[KG.row] & (KG.data != 0)
            rows, cols = KG.row[keep], KG.col[keep]
            mag = np.abs(KG.data[keep])
            # per-row top max_step_size by |kaporin gradient|
            order = np.lexsort((-mag, rows))
            rows, cols = rows[order], cols[order]
            rank = np.arange(len(rows)) - np.searchsorted(rows, rows,
                                                          "left")
            sel = rank < cfg.max_step_size
            rows, cols = rows[sel], cols[sel]
            if len(rows) == 0:
                break
            # append to the patterns
            slot = cnt[rows] + (np.arange(len(rows))
                                - np.searchsorted(rows, rows, "left"))
            ok = slot < cap
            pat[rows[ok], slot[ok]] = cols[ok]
            np.maximum.at(cnt, rows[ok], slot[ok] + 1)
            # re-solve, then the psi test
            g, psi_new, _ = _batched_g(lookup, diag, pat)
            stall = np.abs(psi_new - psi) < cfg.kap_tolerance \
                * np.abs(psi)
            active = active & ~stall
            psi = psi_new
        return pat

    # -- assembly -----------------------------------------------------

    def _assemble(self, A, pat) -> "FSAI":
        from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

        n = A.shape[0]
        diag = A.diagonal()
        lookup = _Lookup(A)
        g, psi, valid = _batched_g(lookup, diag, pat)
        d = np.where(psi > 0, psi, np.abs(diag) + 1e-30)
        s = 1.0 / np.sqrt(d)
        k = pat.shape[1]
        g_rows = np.repeat(np.arange(n), k)[valid.ravel()]
        g_cols = pat[valid]
        g_vals = (g * s[:, None])[valid]
        G = sp.coo_matrix(
            (np.concatenate([g_vals, s]),
             (np.concatenate([g_rows, np.arange(n)]),
              np.concatenate([g_cols, np.arange(n)]))),
            shape=(n, n)).tocsr()
        self.G = sparse_op_from_scipy(G, prefer_dia=False)
        self.Gt = sparse_op_from_scipy(G.T.tocsr(), prefer_dia=False)
        self._G_scipy = G
        return self

    def precondition(self, r):
        from hypre_tpu_torch.ops.formats import matvec

        return matvec(self.Gt, matvec(self.G, r))


def _pack_pattern(n, rows, cols, k) -> np.ndarray:
    pat = np.full((n, k), -1, dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    r_s, c_s = rows[order], cols[order]
    pos = np.arange(len(r_s)) - np.searchsorted(r_s, r_s)
    ok = pos < k
    pat[r_s[ok], pos[ok]] = c_s[ok]
    return pat
