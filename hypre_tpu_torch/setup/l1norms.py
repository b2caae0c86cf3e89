"""Smoother l1 row norms.

Semantics of hypre_ParCSRComputeL1Norms (ref: src/parcsr_ls/ams.c:
628-760; dispatch by relax type at src/parcsr_ls/par_amg_setup.c:
3300-3390):

option 1 (l1-Jacobi, relax 18):  d_i = sum_j |a_ij| over the full row
option 4 (l1-GS, relax 13/14/8): d_i = |a_ii| + 0.5 * offd-row-l1;
    truncated to |a_ii| when <= 4/3 |a_ii| ("Remark 6.2")
option 5 (Jacobi, relax 0/7):    d_i = a_ii, zeros replaced by 1
Negative-definite rows flip sign so d matches the diagonal's sign.

On a single shard there is no diag/offd split; option 4's "offd" means
off-process couplings, which here are supplied via an optional mask of
local columns (used by the parallel layer).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.utils import expand_rows


def l1_norms(A: sp.csr_matrix, option: int = 1,
             offproc_mask: np.ndarray | None = None) -> np.ndarray:
    A = A.tocsr()
    n = A.shape[0]

    from hypre_tpu_torch.setup.utils import native_enabled

    if native_enabled() and option in (1, 4, 5):
        from hypre_tpu_torch.csrc import build as native

        return native.l1_norms(A, option, offproc_mask)

    diag = A.diagonal()
    rows = expand_rows(A.indptr)

    if option == 5:
        d = diag.copy()
        d[d == 0.0] = 1.0
        return d

    if option == 1:
        d = np.bincount(rows, np.abs(A.data), minlength=n)
    elif option == 4:
        if offproc_mask is None:
            offp = np.zeros(len(A.data), dtype=bool)
        else:
            offp = offproc_mask
        d = np.abs(diag) + 0.5 * np.bincount(rows[offp], np.abs(A.data[offp]),
                                             minlength=n)
        trunc = d <= (4.0 / 3.0) * np.abs(diag)
        d[trunc] = np.abs(diag)[trunc]
    else:
        raise ValueError(f"unsupported l1-norm option {option}")

    # negative-definite handling: match the diagonal's sign
    d = np.where(diag < 0, -d, d)
    d[d == 0.0] = 1.0
    return d
