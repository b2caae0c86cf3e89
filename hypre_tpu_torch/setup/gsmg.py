"""GSMG — geometrically smooth multigrid (smooth-vector strength +
least-squares interpolation).

Analog of hypre's GSMG (ref: src/parcsr_ls/par_gsmg.c:10; enabled by
HYPRE_BoomerAMGSetGSMG(4) + SetNumSamples).  Instead of measuring
strength on matrix coefficients, GSMG relaxes a few random vectors
(the "smooth directions") and calls i, j strongly connected when the
smooth vectors agree along the edge:

  S_ij = 1 / sum_k |v_k(i) - v_k(j)|      (par_gsmg.c:57 FillSmooth,
                                           samples pre-normalized)
  keep S_ij >= thresh * minimax           (:256 ChooseThresh — the
                                           min over rows of the row
                                           max — and :298 Threshold)

Interpolation is a per-F-row least-squares fit of the smooth vectors
from the strong C neighbors (ref: par_gsmg.c:733
hypre_BoomerAMGBuildInterpLS): min_w sum_k (v_k(i) - sum_c w_c
v_k(c))^2 — a batched (n_f, m, m) normal-equation solve, on the host
in f64.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.coarsen import C_PT, SF_PT
from hypre_tpu_torch.setup.utils import expand_rows


def smooth_vectors(A: sp.csr_matrix, nsamples: int = 5,
                   sweeps: int = 5, weight: float = 2.0 / 3.0,
                   seed: int = 43) -> np.ndarray:
    """(n, nsamples) damped-Jacobi-relaxed random vectors, zero rhs
    (par_gsmg.c:418 CreateSmoothVecs with the level smoother)."""
    n = A.shape[0]
    rng = np.random.RandomState(seed)
    V = rng.rand(n, nsamples) - 0.5
    d = A.diagonal()
    dinv = 1.0 / np.where(d != 0, d, 1.0)
    for _ in range(sweeps):
        V = V - weight * (dinv[:, None] * (A @ V))
    return V


def smooth_dirs(A: sp.csr_matrix, V: np.ndarray, thresh: float = 0.1,
                dof_func: np.ndarray | None = None):
    """Smooth-vector strength: returns (S, strong_mask over A's
    entries).  FillSmooth + ChooseThresh + Threshold semantics."""
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    rows = expand_rows(A.indptr)
    cols = A.indices
    # normalize samples like the reference (unit norm / nsamples)
    k = V.shape[1]
    Vn = V / (np.linalg.norm(V, axis=0, keepdims=True) + 1e-300) / k
    diff = np.zeros(len(rows))
    for s in range(k):
        diff += np.abs(Vn[rows, s] - Vn[cols, s])
    offd = cols != rows
    ok = offd & (A.data != 0) & (diff != 0)
    if dof_func is not None:
        ok &= dof_func[rows] == dof_func[cols]
    sval = np.where(ok, 1.0 / np.where(diff != 0, diff, 1.0), 0.0)
    # minimax: min over rows (with any entry) of the row max
    rmax = np.zeros(n)
    np.maximum.at(rmax, rows, sval)
    nz = rmax > 0
    minimax = rmax[nz].min() if nz.any() else 0.0
    mask = sval >= thresh * minimax
    mask &= ok
    S = sp.csr_matrix(
        (np.ones(int(mask.sum())), (rows[mask], cols[mask])),
        shape=A.shape)
    return S, mask


def interp_ls(A: sp.csr_matrix, V: np.ndarray, cf: np.ndarray,
              strong_mask: np.ndarray, max_elmts: int = 8,
              trunc_factor: float = 0.0) -> sp.csr_matrix:
    """Least-squares interpolation from strong C neighbors
    (par_gsmg.c:733 BuildInterpLS): batched normal equations
    (Vc Vc^T + eps I) w = Vc v_i per F row."""
    from hypre_tpu_torch.setup.interp import truncate_interp

    A = A.tocsr()
    n = A.shape[0]
    is_c = cf == C_PT
    cmap = np.cumsum(is_c) - 1
    n_c = int(is_c.sum())
    rows = expand_rows(A.indptr)

    sel = strong_mask & ~is_c[rows] & is_c[A.indices] \
        & (cf[rows] != SF_PT)
    e_rows, e_cols = rows[sel], A.indices[sel]
    # cap per-row C set by |S| magnitude is unavailable here; keep
    # first max_elmts in column order (the LS fit weighs them anyway)
    order = np.lexsort((e_cols, e_rows))
    e_rows, e_cols = e_rows[order], e_cols[order]
    rank = np.arange(len(e_rows)) - np.searchsorted(e_rows, e_rows)
    keep = rank < max_elmts
    e_rows, e_cols, rank = e_rows[keep], e_cols[keep], rank[keep]

    m = max_elmts
    pat = np.full((n, m), -1, dtype=np.int64)
    pat[e_rows, rank] = e_cols
    valid = pat >= 0
    pat_safe = np.where(valid, pat, 0)

    k = V.shape[1]
    Vc = V[pat_safe]                     # (n, m, k)
    Vc = np.where(valid[:, :, None], Vc, 0.0)
    G = np.einsum("nmk,nlk->nml", Vc, Vc)
    rhs = np.einsum("nmk,nk->nm", Vc, V)
    eps = 1e-12 * (np.trace(G, axis1=1, axis2=2)[:, None, None] + 1.0)
    G = G + eps * np.eye(m)[None]
    # f64 LAPACK on the host where the reference calls jnp.linalg.solve:
    # the last bits may differ (ROADMAP Queue 3)
    w = np.linalg.solve(G, rhs[..., None])[..., 0]
    w = np.where(valid, w, 0.0)

    f_rows = ~is_c & (cf != SF_PT)
    keep_e = valid & f_rows[:, None]
    pr = np.concatenate([np.repeat(np.arange(n), m)[keep_e.ravel()],
                         np.flatnonzero(is_c)])
    pc = np.concatenate([cmap[pat[keep_e]],
                         cmap[np.flatnonzero(is_c)]])
    pv = np.concatenate([w[keep_e], np.ones(n_c)])
    P = sp.csr_matrix((pv, (pr, pc)), shape=(n, n_c))
    P.sum_duplicates()
    P.sort_indices()
    if trunc_factor > 0.0:
        P = truncate_interp(P, trunc_factor, max_elmts)
    return P
