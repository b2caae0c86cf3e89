"""Classical strength-of-connection matrix.

Semantics of hypre_BoomerAMGCreateS (ref: src/parcsr_ls/
par_strength.c:531; host core around :230-420):

For row i with diagonal d = a_ii:
  row_scale = max_{j != i} a_ij   if d < 0
            = min_{j != i} a_ij   if d >= 0
  row_sum   = sum_j a_ij (including diagonal)
  If |row_sum| > |d| * max_row_sum and max_row_sum < 1:
      all connections weak (empty S row).
  Else j is strong iff
      a_ij > theta * row_scale    (d < 0)
      a_ij < theta * row_scale    (d >= 0)
  The diagonal is never in S.

Defaults theta = 0.25, max_row_sum = 0.9
(ref: src/parcsr_ls/par_amg.c:168,172).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.utils import expand_rows, row_reduce


def strength_matrix(A: sp.csr_matrix, theta: float = 0.25,
                    max_row_sum: float = 0.9, return_mask: bool = False,
                    abs_soc: bool = False, dof_func=None):
    """Return the boolean strength pattern S (csr, data all ones).

    With return_mask=True also returns the boolean mask over the
    (sorted CSR) entries of A marking strong connections — interp
    builders consume it directly instead of re-deriving membership.

    dof_func (systems AMG, num_functions > 1): couplings between
    DIFFERENT functions are excluded from the scale/row-sum and are
    never strong (the unknown-based approach, ref: par_strength.c
    dof_func guards)."""
    A = A.tocsr()
    n = A.shape[0]

    from hypre_tpu_torch.setup.utils import native_enabled

    if dof_func is not None:
        # unknown-based: strength computed on the same-function
        # submatrix (scales, row sums and the mask all exclude
        # cross-function couplings, ref: par_strength.c dof_func
        # guards), then the entry mask maps back to A's positions
        rows = expand_rows(A.indptr)
        same = dof_func[rows] == dof_func[A.indices]
        indptr2 = np.concatenate(
            [[0], np.cumsum(np.bincount(rows[same], minlength=n))])
        A2 = sp.csr_matrix((A.data[same], A.indices[same],
                            indptr2.astype(A.indptr.dtype)),
                           shape=A.shape)
        out = strength_matrix(A2, theta, max_row_sum,
                              return_mask=return_mask, abs_soc=abs_soc)
        if not return_mask:
            return out
        S, mask2 = out
        mask = np.zeros(len(A.data), dtype=bool)
        mask[np.flatnonzero(same)] = mask2
        return S, mask

    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        strong = native.strength_mask(A, theta, max_row_sum, abs_soc)
        S = native.mask_to_csr(A, strong)
        if return_mask:
            return S, strong
        return S

    diag = A.diagonal()
    rows = expand_rows(A.indptr)
    offdiag_mask = A.indices != rows

    # row_scale over off-diagonal entries only
    neg_inf = np.float64(-np.inf)
    pos_inf = np.float64(np.inf)
    d_neg = diag < 0
    scale_max = _masked_row_reduce(A, offdiag_mask, "max", neg_inf)
    scale_min = _masked_row_reduce(A, offdiag_mask, "min", pos_inf)
    row_scale = np.where(d_neg, scale_max, scale_min)

    row_sum = row_reduce(A.data, A.indptr, "sum", 0.0)

    weak_all = np.zeros(n, dtype=bool)
    if max_row_sum < 1.0 and not abs_soc:
        weak_all = np.abs(row_sum) > np.abs(diag) * max_row_sum

    if abs_soc:
        # absolute-value strength (hypre_BoomerAMGCreateSabs,
        # ref: par_strength.c:1360+): |a_ij| >= theta * max_k |a_ik|;
        # the weak-row rule uses the ABS row sum:
        # weak iff sum_k |a_ik| < |diag| * (2 - max_row_sum)
        abs_scale = _masked_row_reduce_abs(A, offdiag_mask)
        strong = np.abs(A.data) >= theta * abs_scale[rows]
        if max_row_sum < 1.0:
            abs_row_sum = row_reduce(np.abs(A.data), A.indptr,
                                     "sum", 0.0)
            weak_all = abs_row_sum < np.abs(diag) * (2.0 - max_row_sum)
    else:
        thresh = theta * row_scale
        strong = np.where(
            d_neg[rows], A.data > thresh[rows], A.data < thresh[rows]
        )
    strong &= offdiag_mask
    strong &= ~weak_all[rows]

    S = sp.csr_matrix(
        (np.ones(int(strong.sum())),
         (rows[strong], A.indices[strong])), shape=A.shape)
    S.sort_indices()
    if return_mask:
        return S, strong
    return S


def _masked_row_reduce(A, mask, op, empty):
    """Row-reduce over only the entries where mask is true."""
    data = A.data[mask]
    # rebuild indptr for the filtered entries
    rows = expand_rows(A.indptr)[mask]
    counts = np.bincount(rows, minlength=A.shape[0])
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return row_reduce(data, indptr, op, empty)


def _masked_row_reduce_abs(A, mask):
    data = np.abs(A.data[mask])
    rows = expand_rows(A.indptr)[mask]
    counts = np.bincount(rows, minlength=A.shape[0])
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return row_reduce(data, indptr, "max", 0.0)
