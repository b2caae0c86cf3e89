"""Classical / extended / standard interpolation (types 0, 14, 8, 9).

Single-rank semantics of hypre's host builders:
  classical (0):  hypre_BoomerAMGBuildInterp, ref:
      src/parcsr_ls/par_interp.c:15-900.  Distance-1 pattern; strong-F
      couplings distributed over the common strong-C set with the sign
      filter sgn(a_jj) * a_jl < 0; zero-denominator folds into the
      diagonal ("modified" classical).
  extended (14):  hypre_BoomerAMGBuildExtInterp, ref:
      src/parcsr_ls/par_lr_interp.c:4777-5520.  Same distribution over
      the distance-2 pattern (strong C of i plus strong C of strong-F
      neighbors of i) — ext+i (type 6) minus the "+i" term.
  standard (8/9): hypre_BoomerAMGBuildStdInterp, ref:
      src/parcsr_ls/par_lr_interp.c:22-1010.  Eliminates each strong-F
      row j through a_jj into an extended row "ahat", then scales so
      the P row reproduces the full row sum; 9 = sep_weight (positive
      and negative parts scaled separately).

The native OpenMP kernel (csrc/setup_kernels.cpp:lr_interp) is the
production path; the per-row python below is its exact twin for tests
and the no-native fallback.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.coarsen import C_PT, F_PT, SF_PT
from hypre_tpu_torch.setup.interp import _entries_in_pattern, truncate_interp


def lr_interp(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray,
              variant: int, trunc_factor: float = 0.0,
              max_elmts: int = 0, strong_mask=None) -> sp.csr_matrix:
    """Build P for interp type `variant` in {0, 14, 8, 9}."""
    A = A.tocsr()
    A.sort_indices()
    if strong_mask is None:
        strong_mask = _entries_in_pattern(A, S)
    cmap = np.cumsum(cf == C_PT) - 1

    from hypre_tpu_torch.setup.utils import native_enabled

    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        P = native.lr_interp(A, strong_mask, cf, cmap, variant)
    else:
        P = _lr_interp_py(A, strong_mask, cf, cmap, variant)
    if trunc_factor > 0.0 or max_elmts > 0:
        P = truncate_interp(P, trunc_factor, max_elmts)
    return P


def _lr_interp_py(A, strong, cf, cmap, variant):
    dist2 = variant != 0
    standard = variant in (8, 9)
    sep = variant == 9
    n = A.shape[0]
    indptr, indices, data = A.indptr, A.indices, A.data
    diag = A.diagonal()
    rows_out, cols_out, vals_out = [], [], []

    for i in range(n):
        if cf[i] == C_PT:
            rows_out.append(i)
            cols_out.append(cmap[i])
            vals_out.append(1.0)
            continue
        if cf[i] != F_PT:
            continue
        b, e = indptr[i], indptr[i + 1]
        patt: dict[int, float] = {}
        for p in range(b, e):
            if not strong[p]:
                continue
            j = indices[p]
            if cf[j] == C_PT:
                patt[j] = 0.0
            elif dist2 and cf[j] == F_PT:
                for q in range(indptr[j], indptr[j + 1]):
                    if strong[q] and cf[indices[q]] == C_PT:
                        patt[indices[q]] = 0.0
        cols_sorted = sorted(patt)
        acc = {j: 0.0 for j in cols_sorted}

        if not standard:
            d = diag[i]
            for p in range(b, e):
                j = indices[p]
                if j == i:
                    continue
                aij = data[p]
                if j in acc:
                    acc[j] += aij
                elif strong[p] and cf[j] == F_PT:
                    sgn = 1.0 if diag[j] > 0 else -1.0
                    denom = 0.0
                    for q in range(indptr[j], indptr[j + 1]):
                        l = indices[q]
                        if l == j or sgn * data[q] >= 0:
                            continue
                        if l in acc:
                            denom += data[q]
                    if denom == 0.0:
                        d += aij
                    else:
                        dist = aij / denom
                        for q in range(indptr[j], indptr[j + 1]):
                            l = indices[q]
                            if l == j or sgn * data[q] >= 0:
                                continue
                            if l in acc:
                                acc[l] += dist * data[q]
                elif cf[j] != SF_PT:
                    d += aij
            inv = -1.0 / d if d != 0.0 else 1.0
            for j in cols_sorted:
                rows_out.append(i)
                cols_out.append(cmap[j])
                vals_out.append(acc[j] * inv)
            continue

        # standard: eliminate strong-F rows into ahat
        fhat = {i: diag[i]}

        def add_at(k, v, from_elim):
            if k in acc:
                acc[k] += v
            elif from_elim or cf[k] != SF_PT:
                fhat[k] = fhat.get(k, 0.0) + v

        for p in range(b, e):
            j = indices[p]
            if j == i:
                continue
            aij = data[p]
            if strong[p] and cf[j] == F_PT:
                if diag[j] != 0.0:
                    dist = aij / diag[j]
                    for q in range(indptr[j], indptr[j + 1]):
                        k = indices[q]
                        if k != j:
                            add_at(k, -data[q] * dist, True)
            else:
                add_at(j, aij, False)
        d = fhat.pop(i)
        cvals = list(acc.values())
        fvals = list(fhat.values())
        sum_c = sum(cvals)
        pos_c = sum(v for v in cvals if v > 0)
        neg_c = sum(v for v in cvals if v <= 0)
        sum_all = sum_c + sum(fvals)
        pos = pos_c + sum(v for v in fvals if v > 0)
        neg = neg_c + sum(v for v in fvals if v <= 0)
        alfa = beta = 1.0
        if sep:
            if neg_c * d != 0.0:
                alfa = neg / neg_c / d
            if pos_c * d != 0.0:
                beta = pos / pos_c / d
        else:
            if sum_c * d != 0.0:
                alfa = beta = sum_all / sum_c / d
        for j in cols_sorted:
            rows_out.append(i)
            cols_out.append(cmap[j])
            v = acc[j]
            vals_out.append(-beta * v if v > 0 else -alfa * v)

    n_coarse = int((cf == C_PT).sum())
    P = sp.csr_matrix(
        (np.array(vals_out), (np.array(rows_out, dtype=np.int64),
                              np.array(cols_out, dtype=np.int64))),
        shape=(n, n_coarse))
    P.sort_indices()
    return P
