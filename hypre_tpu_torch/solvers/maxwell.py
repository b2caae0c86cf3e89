"""SStruct Maxwell solver — edge multigrid with Hiptmair smoothing.

Port of hypre_tpu/solvers/maxwell.py, the analog of hypre's SStruct
Maxwell (ref: src/sstruct_ls/maxwell_TV_setup.c:25, maxwell_solve.c):
a solver for the edge (Nedelec) curl-curl system
A_e = alpha C^T C + beta M_e that builds

  * a NODAL coarsening from the auxiliary Poisson operator G^T A_e G
    (strength, PMIS, direct interpolation: the port's host setup),
  * an EDGE hierarchy from it by the Reitzinger-Schoeberl commuting
    construction: nodes aggregate to their strongest coarse node, a
    coarse edge exists between distinct aggregates, and the edge
    prolongation carries +-1 per fine edge (so G_c = R G P holds and
    gradients stay gradients across levels),
  * Hiptmair relaxation at every level: edge l1-Jacobi followed by a
    nodal-subspace correction z += G D_n^{-1} G^T r.

The level loop is numpy/scipy on the host, as the reference's; each
level's A, G, G^T, Pe and Pe^T are uploaded once (K2 on CSR, dense
matvecs on small levels) and the V-cycle runs on the configured device.
The coarsest edge system is solved with a numpy pseudo-inverse computed
on the host and uploaded once (at most max_coarse_edges rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.setup.coarsen import C_PT


@dataclasses.dataclass
class MaxwellConfig:
    max_levels: int = 10
    max_coarse_edges: int = 64
    n_smooth: int = 1
    jacobi_weight: float = 1.0


class SStructMaxwell:
    """Create/Setup/Solve for the sstruct Maxwell system."""

    def __init__(self, config: MaxwellConfig | None = None):
        self.config = config or MaxwellConfig()
        self.levels = []          # dicts: A, G, GT, de, dn, Pe, PeT
        self.c_inv = None

    def setup(self, A_e: sp.csr_matrix, G: sp.csr_matrix
              ) -> "SStructMaxwell":
        from hypre_tpu_torch.core.config import as_real
        from hypre_tpu_torch.setup.coarsen import pmis
        from hypre_tpu_torch.setup.interp import direct_interp
        from hypre_tpu_torch.setup.l1norms import l1_norms
        from hypre_tpu_torch.setup.strength import strength_matrix

        cfg = self.config
        A_l = A_e.tocsr()
        G_l = G.tocsr()
        self.levels = []
        for _ in range(cfg.max_levels - 1):
            if A_l.shape[0] <= cfg.max_coarse_edges:
                break
            # nodal auxiliary operator + one coarsening step
            A_n = (G_l.T @ A_l @ G_l).tocsr()
            S, mask = strength_matrix(A_n, 0.25, 0.9, return_mask=True)
            cf = pmis(S)
            n_c = int((cf == C_PT).sum())
            if n_c == 0 or n_c == A_n.shape[0]:
                break
            P_n = direct_interp(A_n, S, cf, 0.0, 4, strong_mask=mask)
            # aggregate: node -> its largest-weight coarse node
            agg = _strongest_col(P_n)
            # Reitzinger-Schoeberl coarse edges
            Gc, Pe = _rs_edge_interp(G_l, agg, n_c)
            if Pe.shape[1] == 0 or Pe.shape[1] >= A_l.shape[0]:
                break
            de = l1_norms(A_l, 1)
            A_nl = (G_l.T @ A_l @ G_l).tocsr()
            dn = l1_norms(A_nl, 1)
            self.levels.append(_level(A_l, G_l, de, dn, Pe))
            A_l = (Pe.T @ A_l @ Pe).tocsr()
            A_l.sum_duplicates()
            G_l = Gc
        # coarsest
        de = l1_norms(A_l, 1)
        A_nl = (G_l.T @ A_l @ G_l).tocsr()
        dn = l1_norms(A_nl, 1)
        self.levels.append(_level(A_l, G_l, de, dn, None))
        self.c_inv = as_real(np.linalg.pinv(A_l.toarray()))
        return self

    @property
    def level_sizes(self) -> list[int]:
        return [lvl["A"].shape[0] for lvl in self.levels]

    # -- cycle --------------------------------------------------------

    def _hiptmair(self, lvl, b, x):
        """Edge Jacobi + nodal-subspace correction (the alternating
        edge/node smoother of maxwell_solve.c)."""
        from hypre_tpu_torch.ops.formats import matvec

        w = self.config.jacobi_weight
        Aop, Gop, GTop = lvl["A"], lvl["G"], lvl["GT"]
        de, dn = lvl["de"], lvl["dn"]
        r = b if x is None else b - matvec(Aop, x)
        z = w * de * r
        x = z if x is None else x + z
        r = b - matvec(Aop, x)
        zn = dn * matvec(GTop, r)
        return x + matvec(Gop, zn)

    def _cycle_at(self, l, b):
        from hypre_tpu_torch.ops.formats import matvec

        lvl = self.levels[l]
        if lvl["Pe"] is None:
            return (self.c_inv @ b.to(self.c_inv.dtype))[:b.shape[0]]
        x = None
        for _ in range(self.config.n_smooth):
            x = self._hiptmair(lvl, b, x)
        r = b - matvec(lvl["A"], x)
        rc = matvec(lvl["PeT"], r)
        ec = self._cycle_at(l + 1, rc)
        x = x + matvec(lvl["Pe"], ec)
        for _ in range(self.config.n_smooth):
            x = self._hiptmair(lvl, b, x)
        return x

    def precondition(self, r) -> torch.Tensor:
        from hypre_tpu_torch.core.config import as_real

        r = r if isinstance(r, torch.Tensor) else as_real(r)
        return self._cycle_at(0, r)


def _level(A, G, de, dn, Pe):
    from hypre_tpu_torch.core.config import as_real
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

    def op(M):
        return sparse_op_from_scipy(M, prefer_dia=False)

    out = {
        "A": op(A), "G": op(G), "GT": op(G.T.tocsr()),
        "de": as_real(1.0 / np.where(de != 0, de, 1.0)),
        "dn": as_real(1.0 / np.where(dn != 0, dn, 1.0)),
        "Pe": None, "PeT": None,
    }
    if Pe is not None:
        out["Pe"] = op(Pe)
        out["PeT"] = op(Pe.T.tocsr())
    return out


def _strongest_col(P: sp.csr_matrix) -> np.ndarray:
    """Per row: column of the largest |entry| (aggregation map)."""
    P = P.tocsr()
    n = P.shape[0]
    out = np.zeros(n, dtype=np.int64)
    counts = np.diff(P.indptr)
    rows = np.repeat(np.arange(n), counts)
    if len(rows):
        mag = np.abs(P.data)
        order = np.lexsort((-mag, rows))
        first = np.concatenate([[True], rows[order][1:]
                                != rows[order][:-1]])
        out[rows[order][first]] = P.indices[order][first]
    return out


def _rs_edge_interp(G: sp.csr_matrix, agg: np.ndarray, n_c: int):
    """Reitzinger-Schoeberl: coarse gradient + edge prolongation.

    Each fine edge e = (n-, n+) (from G's -1/+1 row) maps to the
    coarse edge (agg(n-), agg(n+)) with sign matching orientation;
    intra-aggregate edges map to nothing.  G_c rows are the distinct
    coarse pairs with -1/+1 — the commuting relation G_c = Pe^T G P_n
    holds by construction."""
    G = G.tocsr()
    ne = G.shape[0]
    # endpoints of each edge from the +-1 pattern
    n_minus = np.full(ne, -1, np.int64)
    n_plus = np.full(ne, -1, np.int64)
    rows = np.repeat(np.arange(ne), np.diff(G.indptr))
    neg = G.data < 0
    n_minus[rows[neg]] = G.indices[neg]
    n_plus[rows[~neg]] = G.indices[~neg]
    ok = (n_minus >= 0) & (n_plus >= 0)
    am = agg[np.where(ok, n_minus, 0)]
    ap = agg[np.where(ok, n_plus, 0)]
    inter = ok & (am != ap)
    lo = np.minimum(am, ap)
    hi = np.maximum(am, ap)
    sign = np.where(am == lo, 1.0, -1.0)   # orientation lo -> hi
    key = lo * n_c + hi
    uk, inv = np.unique(key[inter], return_inverse=True)
    nec = len(uk)
    Pe = sp.coo_matrix(
        (sign[inter], (np.flatnonzero(inter), inv)),
        shape=(ne, nec)).tocsr()
    Gc = sp.coo_matrix(
        (np.concatenate([-np.ones(nec), np.ones(nec)]),
         (np.concatenate([np.arange(nec), np.arange(nec)]),
          np.concatenate([uk // n_c, uk % n_c]))),
        shape=(nec, n_c)).tocsr()
    return Gc, Pe
