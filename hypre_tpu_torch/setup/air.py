"""AIR — approximate ideal restriction (for nonsymmetric problems).

Analog of hypre's AIR (ref: src/parcsr_ls/par_lr_restr.c:42
hypre_BoomerAMGBuildRestrDist2AIR / :2034 Neumann variant; enabled via
restr_par, docs HYPRE_parcsr_ls.h:1265-1275).  The ideal restriction is
R = [-A_cf A_ff^{-1}  I]; lAIR approximates A_ff^{-1} row-locally:

For each C point i with F-neighborhood F_i (distance-1 strong F
neighbors): solve the small transposed system
    z^T A[F_i, F_i] = -A[i, F_i]
and set R[i, F_i] = z, R[i, i] = 1.  All C rows are independent — ONE
batched dense solve over (n_c, k, k), on the host in f64.
Interpolation alongside AIR is one-point injection (P[i, c(i)] = 1 for
the strongest C neighbor), and the coarse operator is the nonsymmetric
triple product R A P.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.coarsen import C_PT, F_PT
from hypre_tpu_torch.setup.utils import expand_rows


def air_restriction(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray,
                    strong_mask: np.ndarray | None = None,
                    max_nbrs: int = 12, dist: int = 1) -> sp.csr_matrix:
    """Build R (n_coarse x n_fine) by distance-1 or distance-2 lAIR
    (ref: par_lr_restr.c:42 hypre_BoomerAMGBuildRestrDist2AIR).
    dist=2 extends each C row's F-neighborhood through one more layer
    of strong F-F edges before the batched local solve."""
    A = A.tocsr()
    n = A.shape[0]
    is_c = cf == C_PT
    is_f = cf == F_PT
    c_idx = np.flatnonzero(is_c)
    n_c = len(c_idx)
    cmap = np.cumsum(is_c) - 1

    rows = expand_rows(A.indptr)
    if strong_mask is None:
        from hypre_tpu_torch.setup.interp import _entries_in_pattern

        strong_mask = _entries_in_pattern(A, S)

    # F-neighborhood of each C row: strong F neighbors, capped
    sel = strong_mask & is_c[rows] & is_f[A.indices]
    e_rows = cmap[rows[sel]]          # coarse row id
    e_cols = A.indices[sel]           # fine F column
    mag = np.abs(A.data[sel])
    hop = np.zeros(len(e_rows), np.int8)      # 0 = distance-1
    if dist >= 2:
        max_nbrs = max(max_nbrs, 24)
        # distance-2: strong F-F edges out of the distance-1 set
        sff = strong_mask & is_f[rows] & is_f[A.indices]
        FF = sp.csr_matrix(
            (np.abs(A.data[sff]), (rows[sff], A.indices[sff])),
            shape=(n, n))
        E1 = sp.csr_matrix((mag, (e_rows, e_cols)), shape=(n_c, n))
        E2 = (E1 @ FF).tocoo()   # weight = path strength product
        e_rows = np.concatenate([e_rows, E2.row])
        e_cols = np.concatenate([e_cols, E2.col])
        mag = np.concatenate([mag, E2.data])
        hop = np.concatenate([hop, np.ones(E2.nnz, np.int8)])
        # dedup: keep the closest hop per (row, col), then the largest
        # magnitude — a lexicographic (distance, |mag|) key, so a huge
        # distance-2 path product can never outrank a distance-1 entry
        key = e_rows.astype(np.int64) * n + e_cols
        order0 = np.lexsort((-mag, hop, key))
        key_s = key[order0]
        first = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        e_rows = e_rows[order0][first]
        e_cols = e_cols[order0][first]
        mag = mag[order0][first]
        hop = hop[order0][first]
    # top-max_nbrs per row by (distance asc, |mag| desc)
    order = np.lexsort((-mag, hop, e_rows))
    e_rows, e_cols = e_rows[order], e_cols[order]
    rank = np.arange(len(e_rows)) - np.searchsorted(e_rows, e_rows)
    keep = rank < max_nbrs
    e_rows, e_cols, rank = e_rows[keep], e_cols[keep], rank[keep]

    k = max_nbrs
    pat = np.full((n_c, k), -1, dtype=np.int64)
    pat[e_rows, rank] = e_cols
    valid = pat >= 0

    # hash lookup of A entries
    a_keys = rows.astype(np.int64) * n + A.indices
    ks = np.argsort(a_keys)
    a_keys_s, a_vals_s = a_keys[ks], A.data[ks]

    def lookup(i_arr, j_arr):
        kk = i_arr.astype(np.int64) * n + j_arr
        p = np.searchsorted(a_keys_s, kk)
        p = np.minimum(p, len(a_keys_s) - 1)
        hit = a_keys_s[p] == kk
        return np.where(hit, a_vals_s[p], 0.0)

    pat_safe = np.where(valid, pat, 0)
    # A[F_i, F_i] blocks and A[i, F_i] rows
    blk = lookup(pat_safe[:, :, None].repeat(k, 2).ravel(),
                 pat_safe[:, None, :].repeat(k, 1).ravel()).reshape(
                     n_c, k, k)
    rhs = lookup(np.repeat(c_idx, k), pat_safe.ravel()).reshape(n_c, k)
    vmask = valid[:, :, None] & valid[:, None, :]
    blk = np.where(vmask, blk, 0.0)
    blk = blk + np.where(
        ~valid[:, :, None] & (np.arange(k)[None, :, None]
                              == np.arange(k)[None, None, :]), 1.0, 0.0)
    rhs = np.where(valid, rhs, 0.0)

    # z^T A_ff = -a_cf  <=>  A_ff^T z = -a_cf^T : batched solve
    # f64 LAPACK on the host where the reference calls jnp.linalg.solve:
    # the last bits may differ (ROADMAP Queue 3)
    z = np.linalg.solve(np.swapaxes(blk, 1, 2), -rhs[..., None])[..., 0]
    z = np.where(valid, z, 0.0)

    r_rows = np.repeat(np.arange(n_c), k)[valid.ravel()]
    r_cols = pat[valid]
    r_vals = z[valid]
    R = sp.coo_matrix(
        (np.concatenate([r_vals, np.ones(n_c)]),
         (np.concatenate([r_rows, np.arange(n_c)]),
          np.concatenate([r_cols, c_idx]))),
        shape=(n_c, n)).tocsr()
    R.sort_indices()
    return R


def neumann_air_restriction(A: sp.csr_matrix, S: sp.csr_matrix,
                            cf: np.ndarray,
                            strong_mask: np.ndarray | None = None,
                            degree: int = 1,
                            filter_threshold: float = 0.0
                            ) -> sp.csr_matrix:
    """Neumann-series AIR (ref: par_lr_restr.c:2034
    hypre_BoomerAMGBuildRestrNeumannAIR):

        A_ff^{-1} ~= (I + N + ... + N^deg) D^{-1},  N = I - D^{-1}A_ff
        R = [ -A_cf (I + N + ... + N^deg) D^{-1},  I ]

    built with sparse products only — no dense local solves.  Entries
    below filter_threshold * row-max are dropped."""
    A = A.tocsr()
    n = A.shape[0]
    is_c = cf == C_PT
    c_idx = np.flatnonzero(is_c)
    f_idx = np.flatnonzero(~is_c)
    n_c = len(c_idx)
    rows = expand_rows(A.indptr)
    if strong_mask is None:
        from hypre_tpu_torch.setup.interp import _entries_in_pattern

        strong_mask = _entries_in_pattern(A, S)
    fmap = -np.ones(n, dtype=np.int64)
    fmap[f_idx] = np.arange(len(f_idx))
    # strong-filtered blocks (the reference builds AFF/ACF from the
    # strength-filtered operator)
    sff = strong_mask & ~is_c[rows] & ~is_c[A.indices]
    scf = strong_mask & is_c[rows] & ~is_c[A.indices]
    dff = A.diagonal()[f_idx]
    dff = np.where(dff != 0, dff, 1.0)
    Aff = sp.csr_matrix(
        (A.data[sff], (fmap[rows[sff]], fmap[A.indices[sff]])),
        shape=(len(f_idx), len(f_idx)))
    Aff.setdiag(0)
    Aff.eliminate_zeros()
    cmap = np.cumsum(is_c) - 1
    Acf = sp.csr_matrix(
        (A.data[scf], (cmap[rows[scf]], fmap[A.indices[scf]])),
        shape=(n_c, len(f_idx)))
    # N = I - D^-1 A_ff  (diagonal removed above -> N = -D^-1 offd)
    N = (sp.diags(-1.0 / dff) @ Aff).tocsr()
    Zsum = sp.identity(len(f_idx), format="csr")
    Npow = sp.identity(len(f_idx), format="csr")
    for _ in range(degree):
        Npow = (Npow @ N).tocsr()
        Zsum = (Zsum + Npow).tocsr()
    Zf = (-(Acf @ Zsum) @ sp.diags(1.0 / dff)).tocoo()
    if filter_threshold > 0.0 and Zf.nnz:
        rmax = np.zeros(n_c)
        np.maximum.at(rmax, Zf.row, np.abs(Zf.data))
        keep = np.abs(Zf.data) >= filter_threshold * rmax[Zf.row]
        Zf = sp.coo_matrix((Zf.data[keep], (Zf.row[keep],
                                            Zf.col[keep])),
                           shape=Zf.shape)
    R = sp.coo_matrix(
        (np.concatenate([Zf.data, np.ones(n_c)]),
         (np.concatenate([Zf.row, np.arange(n_c)]),
          np.concatenate([f_idx[Zf.col], c_idx]))),
        shape=(n_c, n)).tocsr()
    R.sort_indices()
    return R


def one_point_interp(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray,
                     strong_mask: np.ndarray | None = None
                     ) -> sp.csr_matrix:
    """One-point interpolation: every F point injects from its
    strongest C neighbor (the standard AIR companion P)."""
    A = A.tocsr()
    n = A.shape[0]
    is_c = cf == C_PT
    cmap = np.cumsum(is_c) - 1
    n_c = int(is_c.sum())
    rows = expand_rows(A.indptr)
    if strong_mask is None:
        from hypre_tpu_torch.setup.interp import _entries_in_pattern

        strong_mask = _entries_in_pattern(A, S)

    sel = strong_mask & ~is_c[rows] & is_c[A.indices] & (cf[rows] == F_PT)
    mag = np.abs(A.data[sel])
    r_s = rows[sel]
    order = np.lexsort((-mag, r_s))
    r_o = r_s[order]
    first = np.concatenate([[True], r_o[1:] != r_o[:-1]])
    p_rows = r_o[first]
    p_cols = cmap[A.indices[sel][order][first]]

    c_idx = np.flatnonzero(is_c)
    P = sp.coo_matrix(
        (np.ones(len(p_rows) + n_c),
         (np.concatenate([p_rows, c_idx]),
          np.concatenate([p_cols, cmap[c_idx]]))),
        shape=(n, n_c)).tocsr()
    P.sort_indices()
    return P
