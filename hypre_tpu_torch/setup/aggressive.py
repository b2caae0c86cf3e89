"""Aggressive coarsening + multipass interpolation.

Analog of hypre's aggressive coarsening (ref: src/parcsr_ls/
par_amg_setup.c:1295-1345 — a second coarsening pass over the
distance-2 strength graph S2 restricted to first-pass C points) and
multipass interpolation (ref: src/parcsr_ls/par_multi_interp.c,
par_mod_multi_interp.c — assign every F point a pass number by strong
distance to the coarse set, then build P pass by pass, each pass a
sparse row-combination of the previous passes' rows).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.coarsen import C_PT, F_PT, SF_PT, pmis
from hypre_tpu_torch.setup.utils import expand_rows


def aggressive_coarsen(S: sp.csr_matrix, cf1: np.ndarray,
                       num_paths: int = 1, seed: int = 2747) -> np.ndarray:
    """Second-stage coarsening: PMIS over the distance-2 graph among
    first-pass C points.  Returns the combined CF marker (C only where
    both passes kept the point)."""
    n = S.shape[0]
    c1 = np.flatnonzero(cf1 == C_PT)
    if len(c1) == 0:
        return cf1
    # restriction of S to C1 via distance <= 2 paths: S2 = S + S·S
    # (float data: S may carry a uint8 pattern, which the product
    # would overflow)
    Sb = S.tocsr().astype(np.float64)
    S2 = (Sb + Sb @ Sb).tocsr()
    S2.data[:] = 1.0
    sub = S2[c1][:, c1].tocsr()
    sub.setdiag(0)
    sub.eliminate_zeros()
    cf2_sub = pmis(sub, seed=seed, global_ids=c1.astype(np.int64))
    cf = cf1.copy()
    cf[c1[cf2_sub != C_PT]] = F_PT
    return cf


def multipass_interp(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray,
                     strong_mask: np.ndarray | None = None,
                     trunc_factor: float = 0.0,
                     max_elmts: int = 4,
                     max_passes: int = 10) -> sp.csr_matrix:
    """Multipass interpolation (interp/agg_interp type 4).

    pass(C) = 0.  pass(F) = 1 + min pass over strong neighbors.
    Pass-1 F points use the direct-interpolation formula restricted to
    strong C neighbors; pass-k points distribute their strong
    connections through pass<k neighbors' P rows, rescaled so each row
    sums like the direct formula (ref: par_multi_interp.c weight
    normalization)."""
    from hypre_tpu_torch.setup.interp import direct_interp, truncate_interp

    A = A.tocsr()
    n = A.shape[0]
    is_c = cf == C_PT
    cmap = np.cumsum(is_c) - 1
    n_coarse = int(is_c.sum())
    rows = expand_rows(A.indptr)
    if strong_mask is None:
        from hypre_tpu_torch.setup.interp import _entries_in_pattern

        strong_mask = _entries_in_pattern(A, S)

    # --- pass numbers ----------------------------------------------
    passes = np.full(n, -1, dtype=np.int64)
    passes[is_c] = 0
    passes[cf == SF_PT] = 0   # SF rows stay empty
    sm_rows = rows[strong_mask]
    sm_cols = A.indices[strong_mask]
    for p in range(1, max_passes + 1):
        unset = passes[sm_rows] < 0
        ready = passes[sm_cols] >= 0
        cand = np.unique(sm_rows[unset & ready])
        cand = cand[passes[cand] < 0]
        if len(cand) == 0:
            break
        passes[cand] = p
    passes[passes < 0] = 0     # disconnected leftovers: empty rows

    # --- pass 1: direct interpolation on those rows ------------------
    P = direct_interp(A, S, cf, trunc_factor=0.0, max_elmts=0,
                      strong_mask=strong_mask).tolil(copy=False).tocsr()
    P = P.tocsr()

    # zero out rows with pass >= 2 (they get built below)
    later = passes >= 2
    if later.any():
        keep_entry = ~later[expand_rows(P.indptr)]
        P = sp.csr_matrix(
            (P.data[keep_entry],
             P.indices[keep_entry],
             np.concatenate([[0], np.cumsum(np.bincount(
                 expand_rows(P.indptr)[keep_entry], minlength=n))])),
            shape=P.shape)

    # --- passes >= 2: distribute through earlier rows ----------------
    diag = A.diagonal()
    for p in range(2, int(passes.max()) + 1):
        rows_p = passes == p
        if not rows_p.any():
            break
        # select strong entries from pass-p rows into pass<p columns
        sel = strong_mask & rows_p[rows] & (passes[A.indices] < p) \
            & (~is_c[A.indices] | (passes[A.indices] == 0))
        sel &= (passes[A.indices] < p)
        W = sp.csr_matrix((A.data[sel], (rows[sel], A.indices[sel])),
                          shape=(n, n))
        # row scaling: -(sum of ALL offd a_ij) / (sum of used a_ij) / a_ii
        offd = A.indices != rows
        sum_all = np.bincount(rows[offd], A.data[offd], minlength=n)
        sum_used = np.asarray(W.sum(axis=1)).ravel()
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.where(sum_used != 0,
                             -sum_all / (sum_used * diag), 0.0)
        W = sp.diags(np.where(rows_p, scale, 0.0)) @ W
        # multiply by -diag... scale already includes -1/a_ii
        P = P + (W @ P).tocsr()
        # W@P only contributes on pass-p rows (others have zero scale)

    P.sum_duplicates()
    P.sort_indices()
    if trunc_factor > 0.0 or max_elmts > 0:
        P = truncate_interp(P, trunc_factor, max_elmts)
    return P
