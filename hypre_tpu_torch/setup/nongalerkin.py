"""Non-Galerkin coarse-operator sparsification.

Re-implements the semantics of hypre's
hypre_BoomerAMGBuildNonGalerkinCoarseOperator (ref:
src/parcsr_ls/par_nongalerkin.c:1245, pattern builder :956, lumping
loop :1740-1990; the Falgout–Schroder "Non-Galerkin coarse grids"
algorithm) as vectorized sparse-matrix algebra instead of the
reference's per-row merge loops — the whole lumping step becomes two
sampled sparse products, which is also the form a future device port
wants.

Given the Galerkin product RAP (and the intermediate AP = A·P), build
a sparser coarse operator:

1. Pattern = diagonal
           ∪ rows of (A·P) at C points (the "minimal" R_inj·A·P stencil)
           ∪ RAP entries with |a_ij| > droptol · max_{k≠i}|a_ik|
           ∪ transpose closure (sym_collapse=1, the setup default,
             ref: par_amg_setup.c:2805)
2. Strength S of RAP (classical θ-strength, with values).
3. Entries of RAP outside Pattern are LUMPED: a dropped a_ij is
   distributed over k ∈ Pattern(i) ∩ strong-neighbors(j) weighted by
   |s_jk| / Σ|s_jk|; a lump_percent fraction lands on a_ik, the rest
   on the diagonal a_ii (row-sum preserving); symmetric collapsing
   mirrors each lump onto a_ki and subtracts it from a_kk.  Dropped
   entries with an empty intersection are kept (halved + mirrored when
   symmetric), exactly as the reference does.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.coarsen import C_PT
from hypre_tpu_torch.setup.strength import strength_matrix


def nongalerkin_coarse_operator(RAP: sp.csr_matrix,
                                AP: sp.csr_matrix,
                                cf: np.ndarray,
                                droptol: float,
                                strong_threshold: float = 0.25,
                                max_row_sum: float = 0.9,
                                lump_percent: float = 0.5,
                                sym_collapse: bool = True
                                ) -> sp.csr_matrix:
    """Sparsify the Galerkin operator RAP by drop + lump.

    AP: the intermediate product A·P on the FINE grid (n_fine × n_c);
    its C-point rows give the minimal coarse stencil.  cf: fine-grid
    CF marker (C_PT at coarse points).  droptol <= 0 returns RAP
    unchanged (hypre: nongalerk_tol_l > 0 gate,
    par_amg_setup.c:2797)."""
    if droptol <= 0.0:
        return RAP
    RAP = RAP.tocsr()
    RAP.sort_indices()
    n = RAP.shape[0]

    # --- 1. sparsity pattern -------------------------------------------
    # minimal stencil: (A·P) restricted to C rows == R_inj · A · P
    c_rows = np.flatnonzero(cf == C_PT)
    RiAP = AP.tocsr()[c_rows]          # (n_c, n_c)
    pat_min = _pattern(RiAP)

    # drop-tolerance entries of RAP: |a_ij| > droptol * max_{k!=i}|a_ik|
    absA = abs(RAP)
    off = absA - sp.diags(absA.diagonal())
    off.eliminate_zeros()
    rowmax = np.zeros(n)
    if off.nnz:
        rowmax_m = off.max(axis=1)
        rowmax = np.asarray(rowmax_m.todense()).ravel()
    thresh = droptol * rowmax
    keep_coo = RAP.tocoo()
    big = np.abs(keep_coo.data) > thresh[keep_coo.row]
    pat_big = sp.csr_matrix(
        (np.ones(big.sum()), (keep_coo.row[big], keep_coo.col[big])),
        shape=RAP.shape)

    pattern = _pattern(pat_min + pat_big) + sp.eye(n, format="csr")
    if sym_collapse:
        pattern = pattern + pattern.T
    pattern = _pattern(pattern)
    pattern.sort_indices()

    # --- 2. strength of RAP (with values, the MyCreateS analog) --------
    _, strong_mask = strength_matrix(RAP, strong_threshold, max_row_sum,
                                     return_mask=True)
    Sdat = RAP.copy()
    Sdat.data = Sdat.data * strong_mask
    Sdat = Sdat - sp.diags(Sdat.diagonal())
    Sdat.eliminate_zeros()
    Wabs = abs(Sdat).tocsr()

    # --- 3. split RAP into kept / dropped ------------------------------
    kept = RAP.multiply(pattern).tocsr()
    dropped = (RAP - kept).tocsr()
    dropped.eliminate_zeros()
    dropped = dropped.tocoo()
    if dropped.nnz == 0:
        kept.sort_indices()
        return kept

    # pattern rows WITHOUT the diagonal (no lumping onto the diagonal
    # through the intersection; the reference skips it explicitly)
    pat_nodiag = (pattern - sp.eye(n, format="csr")).tocsr()
    pat_nodiag.eliminate_zeros()

    # denominators at dropped positions: denom_ij = sum_k pat(i,k)|s_jk|
    #   = (pat_nodiag @ Wabs^T)[i, j], sampled where `dropped` lives
    denom_full = (pat_nodiag @ Wabs.T).tocsr()
    dpat = sp.csr_matrix(
        (np.ones(dropped.nnz), (dropped.row, dropped.col)),
        shape=RAP.shape)
    denom_at = denom_full.multiply(dpat).tocsr()
    denom = np.asarray(
        denom_at[dropped.row, dropped.col]).ravel()

    has_isect = denom > 0.0
    # dropped entries with NO strong intersection: keep them
    ki, kj = dropped.row[~has_isect], dropped.col[~has_isect]
    kv = dropped.data[~has_isect]
    extra = []
    if len(ki):
        if sym_collapse:
            extra.append(sp.csr_matrix((0.5 * kv, (ki, kj)),
                                       shape=RAP.shape))
            extra.append(sp.csr_matrix((0.5 * kv, (kj, ki)),
                                       shape=RAP.shape))
        else:
            extra.append(sp.csr_matrix((kv, (ki, kj)), shape=RAP.shape))

    # lumped part: Lraw[i,k] = sum_j (v_ij/denom_ij) |s_jk|, k in pat(i)
    li, lj = dropped.row[has_isect], dropped.col[has_isect]
    lv = dropped.data[has_isect] / denom[has_isect]
    Dn = sp.csr_matrix((lv, (li, lj)), shape=RAP.shape)
    Lraw = (Dn @ Wabs).multiply(pat_nodiag).tocsr()
    rowsum = np.asarray(Lraw.sum(axis=1)).ravel()

    A_ng = kept + lump_percent * Lraw \
        + sp.diags((1.0 - lump_percent) * rowsum)
    if sym_collapse:
        colsum = np.asarray(Lraw.sum(axis=0)).ravel()
        A_ng = A_ng + lump_percent * Lraw.T \
            - sp.diags(lump_percent * colsum)
    for e in extra:
        A_ng = A_ng + e
    A_ng = A_ng.tocsr()
    A_ng.eliminate_zeros()
    A_ng.sort_indices()
    return A_ng


def _pattern(M) -> sp.csr_matrix:
    """Boolean (0/1-valued) csr pattern of M."""
    M = M.tocsr().copy()
    M.data = np.ones_like(M.data)
    M.sum_duplicates()
    M.data = np.ones_like(M.data)
    return M
