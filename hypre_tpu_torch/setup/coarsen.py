"""PMIS coarsening (C/F splitting).

Vectorized re-implementation of the PMIS algorithm
(ref: src/parcsr_ls/par_coarsen.c:2101 hypre_BoomerAMGCoarsenPMISHost;
device formulation par_coarsen_device.c:30):

  measure[i] = #{j : i in S_j}  (strong transpose couplings)
             + deterministic pseudo-random in [0, 1)
  Rows with an empty S row are SF points (isolated; CF = -3,
  par_coarsen.c:2393-2401).
  Loop until every point is assigned (par_coarsen.c:2466+):
    1. candidates = unassigned with measure > 1
    2. for every strong edge between two candidates, the smaller
       measure loses its candidacy (random part makes ties impossible)
    3. survivors become C; unassigned points with measure < 1 become F;
       unassigned points with a strong C neighbor in their S row
       become F
    4. assigned points leave the graph (measure = 0)

The random part uses a hash of the GLOBAL row id so the splitting is
identical under any sharding (the determinism hypre's debug coarsening
modes 7/9 provide, ref: src/parcsr_ls/HYPRE_parcsr_ls.h:311-314).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.utils import pmis_hash

C_PT = 1
F_PT = -1
SF_PT = -3


def pmis(S: sp.csr_matrix, seed: int = 2747,
         global_ids: np.ndarray | None = None) -> np.ndarray:
    """Return CF marker array: C_PT (1), F_PT (-1) or SF_PT (-3)."""
    n = S.shape[0]
    if global_ids is None:
        global_ids = np.arange(n, dtype=np.int64)

    S = S.tocsr()

    from hypre_tpu_torch.setup.utils import native_enabled

    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        # ST degree = column counts of S; no transpose materialized
        measure = native.pmis_measure(S, global_ids, seed)
        return native.pmis(S, measure)

    ST = S.T.tocsr()

    measure = np.asarray(ST.indptr[1:] - ST.indptr[:-1], dtype=np.float64)
    measure += pmis_hash(global_ids, seed)

    cf = np.zeros(n, dtype=np.int8)
    row_nnz = np.diff(S.indptr)
    isolated = row_nnz == 0
    cf[isolated] = SF_PT
    measure[isolated] = 0.0

    # strong edges (i depends on j); comparisons are made from the row
    # side exactly as the reference does
    edge_i = np.repeat(np.arange(n), row_nnz)
    edge_j = S.indices

    unassigned = cf == 0
    while unassigned.any():
        cand = unassigned & (measure > 1.0)

        # Edge competitions: for an edge (i, j) with both endpoints
        # candidates, the smaller measure is knocked out.
        ei, ej = edge_i, edge_j
        both = cand[ei] & cand[ej]
        bi, bj = ei[both], ej[both]
        loser_j = measure[bi] > measure[bj]
        loser_i = measure[bj] > measure[bi]
        out = np.zeros(n, dtype=bool)
        out[bj[loser_j]] = True
        out[bi[loser_i]] = True
        new_c = cand & ~out

        cf[new_c] = C_PT

        # F assignment pass (order follows par_coarsen.c:2613-2672)
        low = unassigned & (measure < 1.0)
        cf[low] = F_PT

        is_c = cf == C_PT
        has_c_dep = np.zeros(n, dtype=bool)
        dep_edges = is_c[edge_j]
        has_c_dep[edge_i[dep_edges]] = True
        make_f = unassigned & ~new_c & ~low & has_c_dep
        cf[make_f] = F_PT

        newly_assigned = unassigned & (cf != 0)
        measure[newly_assigned] = 0.0
        unassigned = cf == 0

    return cf.astype(np.int32)


def hmis(S: sp.csr_matrix, seed: int = 2747,
         global_ids: np.ndarray | None = None) -> np.ndarray:
    """HMIS coarsening (ref: par_coarsen.c:2849 — one-pass Ruge-Stüben
    on processor interiors, PMIS on the boundaries).  With the global
    setup view the boundary set is empty, so HMIS reduces to the native
    greedy RS first pass (exactly hypre's single-rank behavior)."""
    from hypre_tpu_torch.csrc.build import rs_first_pass

    S = S.tocsr()
    ST = S.T.tocsr()
    return rs_first_pass(S, ST)
