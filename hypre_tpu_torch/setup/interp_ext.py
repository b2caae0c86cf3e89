"""Extended+i (ext+i) interpolation — hypre's default interp_type 6.

Vectorized re-implementation of the distance-two interpolation of
hypre_BoomerAMGBuildExtPIInterp (host semantics: src/parcsr_ls/
par_lr_interp.c:1024-1800; the device matrix-form variant
par_lr_interp_device.c:1001 computes the same operator):

For an F-point i with strong C set C_i and strong F set F_i^s:
  pattern  Ĉ_i = C_i ∪ (∪_{k in F_i^s} C_k)          (distance-2 C's)
  d_i  = a_ii
  for every off-diagonal entry a_ij of row i:
    j in Ĉ_i:            P_ij += a_ij
    j in F_i^s:          let s = Σ_{l} a_jl over l in Ĉ_i ∪ {i} with
                         sign(a_jj)·a_jl < 0     (par_lr_interp.c:1652)
        s != 0:          P_il += (a_ij / s)·a_jl for l in Ĉ_i (same
                         sign filter); d_i += (a_ij/s)·a_ji  ("+i")
        s == 0:          d_i += a_ij
    weak j (CF != SF):   d_i += a_ij
  P_i := P_i / (-d_i)
C-points interpolate identity; SF rows are empty.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.coarsen import C_PT, F_PT, SF_PT
from hypre_tpu_torch.setup.interp import truncate_interp, _entries_in_pattern
from hypre_tpu_torch.setup.utils import expand_rows


def extpi_interp(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray,
                 trunc_factor: float = 0.0,
                 max_elmts: int = 4,
                 strong_mask: np.ndarray | None = None) -> sp.csr_matrix:
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    is_c = cf == C_PT
    is_f = cf == F_PT
    cmap = np.cumsum(is_c) - 1
    n_coarse = int(is_c.sum())

    from hypre_tpu_torch.setup.utils import native_enabled

    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        strong = strong_mask if strong_mask is not None \
            else _entries_in_pattern(A, S)
        P = native.extpi_interp(A, strong, cf, cmap.astype(np.int32))
        if trunc_factor > 0.0 or max_elmts > 0:
            P = native.truncate_interp(P, trunc_factor, max_elmts)
        return P

    diag = A.diagonal()

    # --- strength pattern split ------------------------------------
    S = S.tocsr()
    s_rows = expand_rows(S.indptr)
    sc_mask = is_c[S.indices]
    sf_mask = is_f[S.indices]
    Sc = sp.csr_matrix((np.ones(int(sc_mask.sum())),
                        (s_rows[sc_mask], S.indices[sc_mask])), shape=(n, n))
    Sf = sp.csr_matrix((np.ones(int(sf_mask.sum())),
                        (s_rows[sf_mask], S.indices[sf_mask])), shape=(n, n))

    # pattern Ĉ = Sc ∪ Sf·Sc (boolean), F rows only
    Chat = (Sc + Sf @ Sc).tocsr()
    Chat.data[:] = 1.0
    Chat.sort_indices()
    chat_rows = expand_rows(Chat.indptr)
    chat_keys = np.sort(chat_rows.astype(np.int64) * n + Chat.indices)

    def in_chat(i_arr, j_arr):
        keys = i_arr.astype(np.int64) * n + j_arr
        pos = np.searchsorted(chat_keys, keys)
        pos = np.minimum(pos, len(chat_keys) - 1)
        return (chat_keys[pos] == keys) if len(chat_keys) else \
            np.zeros(len(keys), bool)

    a_rows = expand_rows(A.indptr)
    offd = A.indices != a_rows
    f_row_entry = is_f[a_rows]

    # --- direct part: A entries (i, j) with j in Ĉ_i ----------------
    direct_sel = offd & f_row_entry & in_chat(a_rows, A.indices)
    p_i = [a_rows[direct_sel]]
    p_j = [A.indices[direct_sel]]
    p_v = [A.data[direct_sel]]

    d = diag.copy()  # running "diagonal" accumulator per row

    # strong-F membership per A entry: (i, j) with j in S_i and F
    if strong_mask is not None:
        strong_f_entry = strong_mask & is_f[A.indices] & f_row_entry
    else:
        strong_f_entry = offd & f_row_entry & _entries_in_pattern(A, Sf)

    # --- weak part: everything not pattern, not strong-F, not SF ----
    weak_sel = (offd & f_row_entry & ~direct_sel & ~strong_f_entry
                & (cf[A.indices] != SF_PT))
    d += np.bincount(a_rows[weak_sel], A.data[weak_sel], minlength=n)

    # --- distribution over strong F neighbors -----------------------
    # edges e: (i, k) k strong-F neighbor of i (use A entries to get a_ik)
    e_i = a_rows[strong_f_entry]
    e_k = A.indices[strong_f_entry]
    e_aik = A.data[strong_f_entry]
    E = len(e_i)
    if E:
        # expand each edge over row k of A (off-diagonal entries)
        k_start = A.indptr[e_k]
        k_cnt = A.indptr[e_k + 1] - k_start
        tri_e = np.repeat(np.arange(E), k_cnt)
        tri_pos = (np.arange(len(tri_e))
                   - np.repeat(np.cumsum(k_cnt) - k_cnt, k_cnt)
                   + k_start[tri_e])
        t_l = A.indices[tri_pos]        # column l of entry a_kl
        t_a = A.data[tri_pos]
        t_i = e_i[tri_e]
        t_k = e_k[tri_e]
        not_diag = t_l != t_k
        sign_ok = (np.sign(diag[t_k]) * t_a) < 0
        memb = in_chat(t_i, t_l)
        is_self = t_l == t_i
        in_den = not_diag & sign_ok & (memb | is_self)

        denom = np.bincount(tri_e[in_den], t_a[in_den], minlength=E)
        has_den = denom != 0
        with np.errstate(divide="ignore", invalid="ignore"):
            dist = np.where(has_den, e_aik / np.where(has_den, denom, 1.0),
                            0.0)
        # s == 0: a_ik goes to the diagonal
        d += np.bincount(e_i[~has_den], e_aik[~has_den], minlength=n)

        contrib_sel = in_den & memb & has_den[tri_e]
        p_i.append(t_i[contrib_sel])
        p_j.append(t_l[contrib_sel])
        p_v.append(dist[tri_e[contrib_sel]] * t_a[contrib_sel])

        self_sel = in_den & is_self & has_den[tri_e]
        d += np.bincount(t_i[self_sel], dist[tri_e[self_sel]] * t_a[self_sel], minlength=n)

    # --- assemble P -------------------------------------------------
    p_i = np.concatenate(p_i)
    p_j = np.concatenate(p_j)
    p_v = np.concatenate(p_v)
    with np.errstate(divide="ignore", invalid="ignore"):
        p_v = p_v / np.where(d[p_i] != 0, -d[p_i], 1.0)

    c_idx = np.flatnonzero(is_c)
    rows = np.concatenate([p_i, c_idx])
    cols = np.concatenate([cmap[p_j], cmap[c_idx]])
    vals = np.concatenate([p_v, np.ones(len(c_idx), dtype=A.data.dtype)])

    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, n_coarse))
    P.sum_duplicates()
    P.sort_indices()
    if trunc_factor > 0.0 or max_elmts > 0:
        P = truncate_interp(P, trunc_factor, max_elmts)
    return P
