"""AMG-DD: communication-avoiding composite-grid AMG over shards.

Port of hypre_tpu/parallel/amgdd.py (``AmgDD`` :78, ``setup`` :112,
``solve`` :268, ``_bfs`` :333, ``_fac_solve`` :381), hypre's
BoomerAMG-DD (ref: src/parcsr_ls/par_amgdd_setup.c:22 composite grids,
par_amgdd_fac_cycle.c FAC cycles, par_amgdd_solve.c the outer
iteration; Mitchell, Manteuffel and McCormick's AMG-DD).

After a standard AMG setup each shard holds, at every level, its own
rows, a padding region (the distance-eta neighbourhood, relaxed) and one
ghost layer (kept, not relaxed): its composite grid; the coarsest level
is whole in every composite grid, so the bottom solve is exact.  The
solve iterates

  1. r = b - A x                          (a distributed matvec)
  2. r onto each shard's composite fine dofs: the one composite gather
     (an exchange of the fine-level CommPkg) of the iteration
  3. FAC V-cycles on each composite hierarchy, no communication
  4. x += each shard's owned part of its correction.

The setup is the reference's host numpy (BFS over the level graphs).
The composite hierarchies are stacked as block-diagonal CSR (all shards'
composite grids one after another) so that each FAC product is one K2
launch for all shards, and the exact coarsest solve is one batched
product with the replicated dense inverse.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.core.config import get_config
from hypre_tpu_torch.ops.spmv import CsrMatrix, csr_from_scipy, csr_spmv
from hypre_tpu_torch.parallel.comm import StackedComm, build_comm_pkg
from hypre_tpu_torch.parallel.partition import RowPartition


@dataclasses.dataclass(frozen=True)
class CompositeLevel:
    """One level of every shard's composite hierarchy, stacked.

    A: block-diagonal CSR (n_held m, n_held m), local composite ids
    P: (n_held m, n_held mc) to the next level's composite ids, R its
       restriction (n_held mc, n_held m); None on the coarsest level
    dinv, real_mask: (n_held, m)"""

    A: CsrMatrix
    P: CsrMatrix | None
    R: CsrMatrix | None
    dinv: torch.Tensor
    real_mask: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.dinv.shape[1])


def _bfs(A: sp.csr_matrix, seed: np.ndarray, dist: int) -> np.ndarray:
    """Sorted union of `seed` and its <= dist-ring neighbourhood."""
    cur = np.unique(seed)
    for _ in range(dist):
        if len(cur) == 0:
            break
        cur = np.union1d(cur, np.unique(A[cur].indices))
    return cur


def _lut(n: int, ids: np.ndarray) -> np.ndarray:
    lut = np.full(n, -1, np.int64)
    lut[ids] = np.arange(len(ids))
    return lut


def _local_block(blk: sp.csr_matrix, lut: np.ndarray):
    """Rows of `blk` with columns mapped to local ids by lut; entries
    outside the local set dropped (the composite truncation: the ghost
    layer guarantees real rows lose nothing).  Returns COO (rows, cols,
    vals)."""
    blk = blk.tocsr()
    loc = lut[blk.indices]
    keep = loc >= 0
    rows = np.repeat(np.arange(blk.shape[0]), np.diff(blk.indptr))[keep]
    return rows, loc[keep], blk.data[keep]


def _stack_blocks(blocks, n_rows: int, n_cols: int, dtype, device):
    """Per-shard COO blocks (rows < n_rows, cols < n_cols) as one
    block-diagonal CSR."""
    rows = np.concatenate([r + p * n_rows for p, (r, _, _) in
                           enumerate(blocks)])
    cols = np.concatenate([c + p * n_cols for p, (_, c, _) in
                           enumerate(blocks)])
    vals = np.concatenate([v for _, _, v in blocks])
    k = len(blocks)
    M = sp.csr_matrix((vals, (rows, cols)), shape=(k * n_rows, k * n_cols))
    return csr_from_scipy(M, dtype, device)


class AmgDD:
    """BoomerAMGDD analog: Create/Setup/Solve over shards (stacked)."""

    def __init__(self, comm, config=None, padding: int = 1,
                 num_ghost_layers: int = 1, fac_cycles: int = 1):
        from hypre_tpu_torch.solvers.amg import AmgConfig

        self.comm = StackedComm(comm) if isinstance(comm, int) else comm
        if not isinstance(self.comm, StackedComm):
            raise ValueError("AmgDD runs on the stacked executor")
        self.config = config or AmgConfig()
        self.padding = padding            # ref: par_amgdd.c SetPadding
        self.num_ghost_layers = num_ghost_layers
        self.fac_cycles = fac_cycles
        self.levels: list[CompositeLevel] = []
        self.comm_pkg = None
        self.fine_part: RowPartition | None = None
        self.comp_gids0: list[np.ndarray] = []
        self.composite_gathers = 0

    @property
    def n_shards(self) -> int:
        return self.comm.n_shards

    def setup(self, A: sp.csr_matrix) -> "AmgDD":
        """The host AMG setup, each shard's composite index sets by BFS
        (amgdd.py:112-265), the stacked composite operators."""
        from hypre_tpu_torch.parallel.parcsr import parcsr_from_scipy
        from hypre_tpu_torch.setup.l1norms import l1_norms
        from hypre_tpu_torch.solvers.amg import build_host_hierarchy

        cfg = self.config
        ns = self.n_shards
        dtype = get_config().real_dtype
        dev = self.comm.device
        levels_host, Ac = build_host_hierarchy(A, cfg)
        As = [lvl[0].tocsr() for lvl in levels_host] + [Ac.tocsr()]
        Ps = [lvl[1].tocsr() for lvl in levels_host]
        nl = len(As)
        part = RowPartition.create(A.shape[0], ns)
        self.fine_part = part

        # composite sets: seed = own rows; padding = eta BFS rings; one
        # ghost ring more; the coarse seed is the own coarse rows plus
        # the coarse image of the fine composite (closure under P); the
        # coarsest level whole
        eta, gl = self.padding, self.num_ghost_layers
        parts = [RowPartition.create(M.shape[0], ns) for M in As]
        comp = [[None] * nl for _ in range(ns)]
        real = [[None] * nl for _ in range(ns)]
        for p in range(ns):
            seed = np.arange(part.n_local * p,
                             min(part.n_local * (p + 1), A.shape[0]))
            for l in range(nl):
                if l == nl - 1:
                    full = pad_set = np.arange(As[l].shape[0])
                else:
                    pad_set = _bfs(As[l], seed, eta)
                    full = _bfs(As[l], pad_set, gl)
                comp[p][l], real[p][l] = full, pad_set
                if l < nl - 1:
                    img = np.unique(Ps[l][full].indices)
                    r0 = parts[l + 1].n_local * p
                    r1 = min(parts[l + 1].n_local * (p + 1),
                             As[l + 1].shape[0])
                    seed = np.union1d(np.arange(r0, r1), img)

        self.levels = []
        for l in range(nl):
            m = max(len(comp[p][l]) for p in range(ns))
            mc = max(len(comp[p][l + 1]) for p in range(ns)) \
                if l < nl - 1 else 1
            dl1 = l1_norms(As[l], 1)
            a_blk, p_blk, r_blk = [], [], []
            dinv = np.zeros((ns, m))
            rm = np.zeros((ns, m))
            for p in range(ns):
                ids = comp[p][l]
                lut = _lut(As[l].shape[0], ids)
                a_blk.append(_local_block(As[l][ids], lut))
                dinv[p, :len(ids)] = 1.0 / dl1[ids]
                rm[p, :len(ids)] = np.isin(ids, real[p][l])
                if l < nl - 1:
                    ids_c = comp[p][l + 1]
                    lut_c = _lut(As[l + 1].shape[0], ids_c)
                    p_blk.append(_local_block(Ps[l][ids], lut_c))
                    r_blk.append(_local_block(Ps[l].T.tocsr()[ids_c], lut))

            def vec(a):
                return torch.as_tensor(a, dtype=dtype, device=dev)

            self.levels.append(CompositeLevel(
                A=_stack_blocks(a_blk, m, m, dtype, dev),
                P=_stack_blocks(p_blk, m, mc, dtype, dev) if p_blk else None,
                R=_stack_blocks(r_blk, mc, m, dtype, dev) if r_blk else None,
                dinv=vec(dinv), real_mask=vec(rm)))

        # exact replicated coarsest solve: the dense inverse of the whole
        # coarsest operator, identity on the composite padding
        n_c = As[-1].shape[0]
        m_co = self.levels[-1].m
        Mco = np.eye(m_co)
        Mco[:n_c, :n_c] = As[-1].toarray()
        self.coarse_inv = torch.as_tensor(np.linalg.inv(Mco), dtype=dtype,
                                          device=dev)

        # the fine-level composite gather: every shard's non-owned
        # composite fine dofs are its ghosts
        self.comp_gids0 = [comp[p][0] for p in range(ns)]
        ghost_lists = []
        for p in range(ns):
            ids = self.comp_gids0[p]
            ghost_lists.append(np.sort(ids[(ids // part.n_local) != p]))
        self.comm_pkg = build_comm_pkg(ghost_lists, part)
        ng = self.comm_pkg.n_ghost
        m0 = self.levels[0].m
        # composite slot -> flat index into the stacked (own | ghost) table
        cmap = np.full((ns, m0), -1, np.int64)
        own_slot = np.full((ns, part.n_local), -1, np.int64)  # -1: padding
        for p in range(ns):
            ids = self.comp_gids0[p]
            own = (ids // part.n_local) == p
            g = np.searchsorted(ghost_lists[p], ids)
            cmap[p, :len(ids)] = p * (part.n_local + ng) + np.where(
                own, ids - p * part.n_local, part.n_local + g)
            own_pos = np.flatnonzero(own)
            own_slot[p, ids[own_pos] - p * part.n_local] = p * m0 + own_pos
        self._comp_map = torch.as_tensor(cmap, device=dev)
        self._own_slot = torch.as_tensor(own_slot, device=dev)
        self.Apar = parcsr_from_scipy(A, ns, dtype, communicator=self.comm)
        return self

    def gather_composite(self, r: torch.Tensor) -> torch.Tensor:
        """r (n_shards, n_local) onto each shard's composite fine dofs,
        (n_shards, m): the iteration's one composite gather."""
        ng = self.comm_pkg.n_ghost
        g = self.comm.exchange(r, self.comm_pkg)
        table = torch.cat([r, g[:, :ng]], dim=1).reshape(-1)
        m = self._comp_map
        self.composite_gathers += 1
        return torch.where(m >= 0, table[m.clamp(min=0)], 0.0)

    def solve(self, b, tol: float = 1e-8, max_iter: int = 100):
        """Outer AMG-DD iteration (ref: par_amgdd_solve.c; amgdd.py:268):
        the residual, one composite gather, FAC cycles, the owned update.
        Returns (x, iterations, relres), x a global numpy array."""
        from hypre_tpu_torch.parallel.parcsr import (
            par_matvec, to_device_shards, unshard_vector,
        )

        comm = self.comm
        b_sh = to_device_shards(np.asarray(b, np.float64), self.fine_part,
                                comm, get_config().real_dtype)
        bn = float(comm.norm(b_sh))
        safe = bn if bn > 0 else 1.0
        x = torch.zeros_like(b_sh)
        r = b_sh
        rn = bn
        it = 0
        while it < max_iter and rn / safe > tol and np.isfinite(rn):
            u = _fac_solve(self.levels, self.gather_composite(r),
                           self.fac_cycles, self.coarse_inv)
            own = self._own_slot
            x = x + torch.where(own >= 0, u.reshape(-1)[own.clamp(min=0)],
                                0.0)
            r = b_sh - par_matvec(self.Apar, x)
            rn = float(comm.norm(r))
            it += 1
        return unshard_vector(x.cpu().numpy(), self.fine_part), it, rn / safe


def _comp_matvec(M: CsrMatrix, x: torch.Tensor, n_rows: int):
    """A block-diagonal composite product over every shard (one K2)."""
    return csr_spmv(M, x.reshape(-1)).reshape(x.shape[0], n_rows)


def _fac_solve(levels, r0: torch.Tensor, n_cycles: int, coarse_inv):
    """FAC V-cycles on every shard's composite hierarchy, no
    communication (ref: par_amgdd_fac_cycle.c; amgdd.py:381): l1-Jacobi
    relaxation on the real dofs, local transfers, the exact coarsest
    solve with the replicated dense inverse."""
    nl = len(levels)

    def cycle_at(l, f):
        lvl = levels[l]
        if l == nl - 1:
            return f @ coarse_inv.T
        w = lvl.dinv * lvl.real_mask
        m = lvl.m
        u = w * f
        r = f - _comp_matvec(lvl.A, u, m)
        fc = _comp_matvec(lvl.R, r, levels[l + 1].m)
        uc = cycle_at(l + 1, fc)
        u = u + _comp_matvec(lvl.P, uc, m)
        return u + w * (f - _comp_matvec(lvl.A, u, m))

    u = torch.zeros_like(r0)
    for _ in range(n_cycles):
        u = u + cycle_at(0, r0 - _comp_matvec(levels[0].A, u, levels[0].m))
    return u
