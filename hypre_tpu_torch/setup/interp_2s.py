"""True two-stage aggressive-coarsening interpolation (agg_interp 5/7).

Replaces the multipass substitute for hypre's 2-stage path
(ref: src/parcsr_ls/par_amg_setup.c:1739-1900):

  stage 1  P1 = ModExt / ModExtPE interp onto the FIRST-pass C points
           (ref: par_mod_lr_interp.c:16 hypre_BoomerAMGBuildModExtInterp,
            :1255 hypre_BoomerAMGBuildModExtPEInterp)
  mark     second-pass PMIS over the distance-2 graph of C1; C1 points
           not selected become NEW F, marked -2
           (ref: par_strength.c:3085 hypre_BoomerAMGCorrectCFMarker2)
  stage 2  P2 = ModPartialExt / ModPartialExtPE interp: rows are the
           OLD C1 points, columns the final C2 points; -2 rows get the
           modified-extended formula over the CURRENT F space
           (ref: par_2s_interp.c:110 BuildModPartialExtInterp,
            :786 BuildModPartialExtPEInterp; the strong FF/FC split is
            gen_fffc.c:531 GenerateFFFC3 / :1400 GenerateFFFCD3)
  compose  P = truncate(P1 @ P2)

Formulas (M-matrix notation, single function space; every fallback
mirrors the reference's zero guards):

  ModExt:    P[i,c] = -[a_ic + sum_k a_ik a_kc / q_k] / w_i
             q_k = sum of strong-C entries of row k,
             w_i = a_ii + sum of weak entries of row i
  ModExtPE:  P[i,c] = -[a_ic + sum_k a_ik a_kc / (q_k+l_k)]
                       / (w_i + sum_k a_ik l_k/(q_k+l_k))
             l_k = MEAN of strong-F entries of row k

k ranges over the strong F neighbors of i.  The partial variants use
the same formulas with rows restricted to the -2 points and F/C taken
from the SECOND-stage marking.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.coarsen import C_PT, F_PT, SF_PT, pmis
from hypre_tpu_torch.setup.utils import expand_rows

NEW_F = -2   # demoted first-stage C point (CorrectCFMarker2 marker)


def _strong_split(A: sp.csr_matrix, strong_mask: np.ndarray,
                  is_c: np.ndarray):
    """Strong F/C entry masks + per-row sums for the mod-ext family.

    Returns (ff, fc, D_q, D_lambda, sum_ff, row_sum) over A's entries
    / rows, where C is defined by `is_c`.  D_q = strong-C row sums,
    D_lambda = MEAN of strong-F entries, row_sum over ALL entries
    (row_sum - sum_ff - D_q = a_ii + weak couplings, the modified
    lumping)."""
    n = A.shape[0]
    rows = expand_rows(A.indptr)
    cols = A.indices
    offd = cols != rows
    ff = strong_mask & offd & ~is_c[cols]
    fc = strong_mask & offd & is_c[cols]
    D_q = np.bincount(rows[fc], A.data[fc], minlength=n)
    cnt_ff = np.bincount(rows[ff], minlength=n)
    sum_ff = np.bincount(rows[ff], A.data[ff], minlength=n)
    with np.errstate(invalid="ignore"):
        D_lambda = np.where(cnt_ff > 0, sum_ff / np.maximum(cnt_ff, 1),
                            0.0)
    row_sum = np.bincount(rows, A.data, minlength=n)
    return ff, fc, D_q, D_lambda, sum_ff, row_sum


def mod_ext_interp(A: sp.csr_matrix, S, cf: np.ndarray,
                   strong_mask: np.ndarray,
                   variant: str = "ext",
                   trunc_factor: float = 0.0,
                   max_elmts: int = 0) -> sp.csr_matrix:
    """Full ModExt (variant='ext', agg_interp 5 stage 1) / ModExtPE
    (variant='extpe', agg_interp 7 stage 1) interpolation.
    Ref: par_mod_lr_interp.c:16 / :1255."""
    from hypre_tpu_torch.setup.interp import truncate_interp

    A = A.tocsr()
    n = A.shape[0]
    rows = expand_rows(A.indptr)
    cols = A.indices
    is_c = cf == C_PT
    ff, fc, D_q, D_lam, sum_ff, row_sum = _strong_split(
        A, strong_mask, is_c)
    weak = row_sum - sum_ff - D_q          # a_ii + weak couplings

    if variant == "ext":
        # beta_i = 1/w_i (1 if w=0); gamma_k = -1/q_k (+1 if q=0)
        with np.errstate(divide="ignore"):
            beta = np.where(weak != 0, 1.0 / np.where(weak != 0, weak,
                                                      1.0), 1.0)
            gamma = np.where(D_q != 0, -1.0 / np.where(D_q != 0, D_q,
                                                       1.0), 1.0)
        self_coef = D_q * gamma            # -1 where q!=0, 0 where q=0
        scale = beta
    else:  # extpe
        theta = D_q + D_lam
        with np.errstate(divide="ignore"):
            gamma = np.where(theta != 0,
                             1.0 / np.where(theta != 0, theta, 1.0),
                             0.0)
        # D_tau_i = sum_k a_ik l_k/(q_k+l_k)
        d_tmp = D_lam * gamma
        D_tau = np.bincount(rows[ff], A.data[ff] * d_tmp[cols[ff]],
                            minlength=n)
        denom = weak + D_tau
        with np.errstate(divide="ignore"):
            scale = np.where(denom != 0,
                             -1.0 / np.where(denom != 0, denom, 1.0),
                             0.0)
        self_coef = theta * gamma          # 1 where theta!=0 else 0

    # FC entries scaled per SOURCE row by gamma; the self (distance-1)
    # term rides on self_coef, which already folds the diag-slot value
    # times the row's own gamma (see module docstring derivation)
    FCg = sp.csr_matrix((A.data[fc] * gamma[rows[fc]],
                         (rows[fc], cols[fc])), shape=(n, n))
    FCraw = sp.csr_matrix((A.data[fc], (rows[fc], cols[fc])),
                          shape=(n, n))
    FF = sp.csr_matrix((A.data[ff], (rows[ff], cols[ff])), shape=(n, n))
    W = (sp.diags(scale) @ (sp.diags(self_coef) @ FCraw + FF @ FCg)) \
        .tocsr()

    # assemble P: C rows identity, F rows = W (cols -> coarse ids)
    cmap = np.cumsum(is_c) - 1
    n_coarse = int(is_c.sum())
    f_rows = ~is_c & (cf != SF_PT)
    Wcoo = W.tocoo()
    keep = f_rows[Wcoo.row] & is_c[Wcoo.col]
    pr = np.concatenate([Wcoo.row[keep], np.flatnonzero(is_c)])
    pc = np.concatenate([cmap[Wcoo.col[keep]],
                         cmap[np.flatnonzero(is_c)]])
    pv = np.concatenate([Wcoo.data[keep],
                         np.ones(n_coarse, A.data.dtype)])
    P = sp.csr_matrix((pv, (pr, pc)), shape=(n, n_coarse))
    P.sum_duplicates()
    P.sort_indices()
    if trunc_factor > 0.0 or max_elmts > 0:
        P = truncate_interp(P, trunc_factor, max_elmts)
    return P


def correct_cf_marked(S: sp.csr_matrix, cf1: np.ndarray,
                      num_paths: int = 1,
                      seed: int = 2747) -> np.ndarray:
    """Second-stage coarsening over the distance-2 graph among the
    first-pass C points; demoted C1 points get the -2 marker
    (CorrectCFMarker2 semantics, ref: par_strength.c:3085; second-S
    construction par_strength.c hypre_BoomerAMGCreate2ndS)."""
    n = S.shape[0]
    c1 = np.flatnonzero(cf1 == C_PT)
    cf = cf1.copy()
    if len(c1) == 0:
        return cf
    Sb = S.tocsr().astype(np.float64)
    S2 = (Sb + Sb @ Sb).tocsr()
    S2.data[:] = 1.0
    sub = S2[c1][:, c1].tocsr()
    sub.setdiag(0)
    sub.eliminate_zeros()
    cf2_sub = pmis(sub, seed=seed, global_ids=c1.astype(np.int64))
    cf[c1[cf2_sub != C_PT]] = NEW_F
    return cf


def mod_partial_ext_interp(A: sp.csr_matrix, cf_m: np.ndarray,
                           strong_mask: np.ndarray,
                           variant: str = "ext",
                           trunc_factor: float = 0.0,
                           max_elmts: int = 0) -> sp.csr_matrix:
    """Partial ModExt/ModExtPE: rows = OLD C1 points (C2 identity, -2
    rows interpolated), columns = final C2 points.
    Ref: par_2s_interp.c:110 / :786."""
    from hypre_tpu_torch.setup.interp import truncate_interp

    A = A.tocsr()
    n = A.shape[0]
    rows = expand_rows(A.indptr)
    cols = A.indices
    is_c = cf_m == C_PT                    # final C2
    is_newf = cf_m == NEW_F
    old_c = is_c | is_newf                 # C1 = rows of P2
    ff, fc, D_q, D_lam, sum_ff, row_sum = _strong_split(
        A, strong_mask, is_c)

    diagA = A.diagonal()
    if variant == "ext":
        with np.errstate(divide="ignore"):
            gamma = np.where(D_q != 0,
                             -1.0 / np.where(D_q != 0, D_q, 1.0), 0.0)
        # D_w subtracts only FF neighbors whose gamma is live (the
        # partial variant's D_q[k] != 0 guard)
        live = (gamma != 0.0)
        sum_ff_live = np.bincount(rows[ff],
                                  A.data[ff] * live[cols[ff]],
                                  minlength=n)
        D_w = row_sum - sum_ff_live - D_q
        with np.errstate(divide="ignore"):
            scale = np.where(D_w != 0,
                             1.0 / np.where(D_w != 0, D_w, 1.0), 1.0)
        # D_w == 0: the reference leaves the row UNSCALED, so the
        # diag slot keeps a_ii
        self_coef = np.where(D_w != 0, D_q, diagA) * gamma
    else:  # extpe
        theta = D_q + D_lam
        with np.errstate(divide="ignore"):
            gamma = np.where(theta != 0,
                             1.0 / np.where(theta != 0, theta, 1.0),
                             0.0)
        d_tmp = D_lam * gamma
        D_tau = np.bincount(rows[ff], A.data[ff] * d_tmp[cols[ff]],
                            minlength=n)
        live = (gamma != 0.0)
        sum_ff_live = np.bincount(rows[ff],
                                  A.data[ff] * live[cols[ff]],
                                  minlength=n)
        D_w = row_sum - sum_ff_live + D_tau - D_q
        with np.errstate(divide="ignore"):
            scale = np.where(D_w != 0,
                             -1.0 / np.where(D_w != 0, D_w, 1.0), 1.0)
        self_coef = np.where(D_w != 0, theta, diagA) * gamma

    FCg = sp.csr_matrix((A.data[fc] * gamma[rows[fc]],
                         (rows[fc], cols[fc])), shape=(n, n))
    FCraw = sp.csr_matrix((A.data[fc], (rows[fc], cols[fc])),
                          shape=(n, n))
    FF = sp.csr_matrix((A.data[ff], (rows[ff], cols[ff])), shape=(n, n))
    W = (sp.diags(scale) @ (sp.diags(self_coef) @ FCraw
                            + FF @ FCg)).tocsr()

    # rows in C1 numbering, columns in C2 numbering
    cmap1 = np.cumsum(old_c) - 1
    cmap2 = np.cumsum(is_c) - 1
    n_c1 = int(old_c.sum())
    n_c2 = int(is_c.sum())
    Wcoo = W.tocoo()
    keep = is_newf[Wcoo.row] & is_c[Wcoo.col]
    pr = np.concatenate([cmap1[Wcoo.row[keep]],
                         cmap1[np.flatnonzero(is_c)]])
    pc = np.concatenate([cmap2[Wcoo.col[keep]],
                         cmap2[np.flatnonzero(is_c)]])
    pv = np.concatenate([Wcoo.data[keep],
                         np.ones(n_c2, A.data.dtype)])
    P2 = sp.csr_matrix((pv, (pr, pc)), shape=(n_c1, n_c2))
    P2.sum_duplicates()
    P2.sort_indices()
    if trunc_factor > 0.0 or max_elmts > 0:
        P2 = truncate_interp(P2, trunc_factor, max_elmts)
    return P2


def two_stage_interp(A: sp.csr_matrix, S, cf1: np.ndarray,
                     strong_mask: np.ndarray,
                     agg_interp_type: int = 5,
                     num_paths: int = 1, seed: int = 2747,
                     p12_trunc: float = 0.0, p12_max_elmts: int = 0,
                     trunc_factor: float = 0.0, max_elmts: int = 0):
    """The full 2-stage flow (par_amg_setup.c:1739-1900 for types 5/7):
    returns (P, cf) where cf is the FINAL marking (-2 folded to F)."""
    variant = "ext" if agg_interp_type == 5 else "extpe"
    P1 = mod_ext_interp(A, S, cf1, strong_mask, variant=variant,
                        trunc_factor=p12_trunc, max_elmts=p12_max_elmts)
    cf_m = correct_cf_marked(S, cf1, num_paths=num_paths, seed=seed)
    P2 = mod_partial_ext_interp(A, cf_m, strong_mask, variant=variant,
                                trunc_factor=p12_trunc,
                                max_elmts=p12_max_elmts)
    P = (P1 @ P2).tocsr()
    P.sum_duplicates()
    P.sort_indices()
    if trunc_factor > 0.0 or max_elmts > 0:
        from hypre_tpu_torch.setup.interp import truncate_interp
        P = truncate_interp(P, trunc_factor, max_elmts)
    cf = cf_m.copy()
    cf[cf == NEW_F] = F_PT
    return P, cf
