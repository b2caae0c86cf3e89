"""Interpolation operators.

direct_interp: direct interpolation (type 3), semantics of
hypre_BoomerAMGBuildDirInterp (ref: src/parcsr_ls/par_interp.c:
1948-2500):

  For an F-point i with diagonal d = a_ii:
    columns = strong C neighbors (j in S_i with CF[j] = C)
    sum_N_neg/pos = sums of negative/positive off-diagonal a_ik over
                    ALL neighbors k
    sum_P_neg/pos = the same sums restricted to strong C neighbors
    alfa = sum_N_neg / (sum_P_neg * d);  beta = sum_N_pos / (sum_P_pos * d)
    P_ij = -alfa * a_ij  (a_ij < 0)        (par_interp.c:2434-2461)
          = -beta * a_ij  (a_ij > 0)
  C-points interpolate to themselves with weight 1.
  SF points get empty rows.

truncate_interp: semantics of hypre_BoomerAMGInterpTruncation →
hypre_ParCSRMatrixTruncate (ref: src/parcsr_mv/par_csr_matrix.c:2874):
drop entries below trunc_factor * row-inf-norm, keep the max_elmts
largest by magnitude, rescale survivors to preserve the row sum.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.coarsen import C_PT
from hypre_tpu_torch.setup.utils import expand_rows


def direct_interp(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray,
                  trunc_factor: float = 0.0,
                  max_elmts: int = 4,
                  strong_mask: np.ndarray | None = None) -> sp.csr_matrix:
    """Build P (n_fine x n_coarse) by direct interpolation."""
    A = A.tocsr()
    n = A.shape[0]
    is_c = cf == C_PT
    cmap = np.cumsum(is_c) - 1  # coarse index of each C point
    n_coarse = int(is_c.sum())

    from hypre_tpu_torch.setup.utils import native_enabled

    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        strong = strong_mask if strong_mask is not None \
            else _entries_in_pattern(A, S)
        P = native.direct_interp(A, strong, cf,
                                 cmap.astype(np.int32))
        if trunc_factor > 0.0 or max_elmts > 0:
            P = native.truncate_interp(P, trunc_factor, max_elmts)
        return P

    diag = A.diagonal()

    rows = expand_rows(A.indptr)
    offd = A.indices != rows

    # strong pattern as a boolean per A entry: entry (i,j) strong iff
    # j in S_i — supplied by strength_matrix(return_mask=True) or
    # reconstructed here.
    strong = strong_mask if strong_mask is not None \
        else _entries_in_pattern(A, S)

    pos = A.data > 0
    neg = A.data < 0
    strong_c = strong & is_c[A.indices]

    sum_n_neg = np.bincount(rows[offd & neg], A.data[offd & neg], minlength=n)
    sum_n_pos = np.bincount(rows[offd & pos], A.data[offd & pos], minlength=n)
    sum_p_neg = np.bincount(rows[strong_c & neg], A.data[strong_c & neg],
                            minlength=n)
    sum_p_pos = np.bincount(rows[strong_c & pos], A.data[strong_c & pos],
                            minlength=n)

    with np.errstate(divide="ignore", invalid="ignore"):
        alfa = np.where(sum_p_neg != 0, sum_n_neg / (sum_p_neg * diag), 1.0)
        beta = np.where(sum_p_pos != 0, sum_n_pos / (sum_p_pos * diag), 1.0)

    f_rows = ~is_c & (cf != 0)  # F and SF (SF rows have no strong C)
    sel = strong_c & f_rows[rows]
    p_rows = rows[sel]
    p_cols = cmap[A.indices[sel]]
    a_vals = A.data[sel]
    p_vals = np.where(a_vals < 0, -alfa[p_rows] * a_vals,
                      -beta[p_rows] * a_vals)

    # C-point identity rows
    c_idx = np.flatnonzero(is_c)
    p_rows = np.concatenate([p_rows, c_idx])
    p_cols = np.concatenate([p_cols, cmap[c_idx]])
    p_vals = np.concatenate([p_vals, np.ones(len(c_idx), dtype=A.data.dtype)])

    P = sp.csr_matrix((p_vals, (p_rows, p_cols)), shape=(n, n_coarse))
    P.sort_indices()
    if trunc_factor > 0.0 or max_elmts > 0:
        P = truncate_interp(P, trunc_factor, max_elmts)
    return P


def _entries_in_pattern(A: sp.csr_matrix, S: sp.csr_matrix) -> np.ndarray:
    """Boolean mask over A.data marking entries whose (row, col) is
    present in the pattern of S."""
    n = A.shape[0]
    # pattern matrix with 1.0 where S has an entry
    Sb = sp.csr_matrix(
        (np.ones(len(S.indices)), S.indices.copy(), S.indptr.copy()),
        shape=S.shape)
    rows_a = expand_rows(A.indptr)
    keys_a = rows_a.astype(np.int64) * n + A.indices
    rows_s = expand_rows(Sb.indptr)
    keys_s = rows_s.astype(np.int64) * n + Sb.indices
    return np.isin(keys_a, keys_s)


def truncate_interp(P: sp.csr_matrix, trunc_factor: float,
                    max_elmts: int) -> sp.csr_matrix:
    """Drop small entries / cap per-row count, preserving row sums."""
    P = P.tocsr()

    from hypre_tpu_torch.setup.utils import native_enabled

    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        return native.truncate_interp(P, trunc_factor, max_elmts)

    n = P.shape[0]
    rows = expand_rows(P.indptr)
    absdata = np.abs(P.data)
    keep = np.ones(len(P.data), dtype=bool)

    if trunc_factor > 0.0:
        from hypre_tpu_torch.setup.utils import row_reduce

        row_nrm = row_reduce(absdata, P.indptr, "max", 0.0)
        keep &= absdata >= trunc_factor * row_nrm[rows]

    if max_elmts > 0:
        # rank of each entry within its row by descending magnitude
        order = np.lexsort((-absdata, rows))
        rank = np.empty(len(P.data), dtype=np.int64)
        row_start_in_order = np.searchsorted(rows[order], np.arange(n))
        rank[order] = np.arange(len(P.data)) - row_start_in_order[rows[order]]
        keep &= rank < max_elmts

    if keep.all():
        return P

    row_sum = np.bincount(rows, P.data, minlength=n)
    kept_sum = np.bincount(rows[keep], P.data[keep], minlength=n)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(kept_sum != 0, row_sum / kept_sum, 1.0)

    newdata = P.data[keep] * scale[rows[keep]]
    Pt = sp.csr_matrix((newdata, (rows[keep], P.indices[keep])), shape=P.shape)
    Pt.sort_indices()
    return Pt
