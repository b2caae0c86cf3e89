"""SparseMSG — multiple-semicoarsening multigrid.

Port of hypre_tpu/struct/sparse_msg.py, the analog of hypre's SparseMSG
(ref: src/struct_ls/sparse_msg_setup.c:20, sparse_msg_solve.c:26,
sparse_msg_filter.c).  The MSG grid lattice is indexed by
per-dimension coarsening levels l = (lz, ly, lx); grid l is the fine
grid semicoarsened l_d times in dimension d.  As in the reference, the
FULL lattice is built; the ``jump`` knob only skips relaxation and
residual work on lattice levels 1..jump ("r = b = x through the jump
region", sparse_msg_solve.c:351-377).

* down: the residual is restricted to EVERY child and accumulated; a
  grid reached by k parents averages its rhs by 1/k (restrict_count,
  sparse_msg_solve.c:226-230);
* up: each interpolated child correction is filtered by a per-point
  winner-take-all visit mask — a point takes correction only from the
  child in its locally strongest coarsening direction
  (sparse_msg_filter.c: lambda_d = (sum of stencil coefficients with
  zero offset along d minus the rest)^2, largest wins, ties scan x,
  then y, then z);
* a fine-grid post-relaxation closes every cycle
  (sparse_msg_solve.c:452-456).

The lattice, its Galerkin RAPs and the visit masks are built on the host
in numpy (PFMG's helpers); each grid's transfer level and mask is
uploaded once, and the cycle is torch on the device.  ``solve`` is a
host loop with one norm sync an iteration, as the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.core.config import as_real, get_device
from hypre_tpu_torch.struct.grid import StructMatrix, np_real, struct_matvec
from hypre_tpu_torch.struct.pfmg import (
    _device_level, _interp_apply, _interp_weights, _pfmg_relax,
    _restrict_apply, _semicoarsen_rap, _stencil_to_dense, mg_solve,
)


@dataclasses.dataclass
class SparseMSGConfig:
    jump: int = 0                 # HYPRE_SparseMSGSetJump (default 0)
    max_levels: int = 25
    max_coarse_size: int = 64
    relax_type: int = 1           # 0 Jacobi, 1 wJacobi, 2 RB-GS
    jacobi_weight: float = 2.0 / 3.0
    num_pre_relax: int = 1
    num_post_relax: int = 1
    num_fine_relax: int = 1
    tol: float = 1e-6
    max_iter: int = 100


def _visit_masks(Ad, shape, dirs, real, device):
    """Per-point winner-take-all correction filter (ref:
    src/struct_ls/sparse_msg_filter.c hypre_SparseMSGFilterSetup)."""
    lam = {}
    for d in range(3):
        s = np.zeros(shape, dtype=real)
        for off, c in Ad.items():
            s = s + (c if off[d] == 0 else -c)
        lam[d] = s * s
    best = np.full(shape, -1, dtype=np.int8)
    lmax = np.zeros(shape, dtype=real)
    for d in (2, 1, 0):            # x, then y, then z (hypre order)
        if d not in dirs:
            continue
        take = lam[d] > lmax
        lmax = np.where(take, lam[d], lmax)
        best = np.where(take, np.int8(d), best)
    if dirs:
        best = np.where(best < 0, np.int8(dirs[0]), best)
    return {d: torch.as_tensor((best == d).astype(real), device=device)
            for d in dirs}


def _grid_level(Ad, shape, d, real, device):
    """Transfer ops + relax data for semicoarsening (Ad, shape) along
    axis d, as a PfmgLevel (PFMG's relax/interp/restrict apply)."""
    wm, wp = _interp_weights(Ad, shape, d, real)
    Ac, cshape = _semicoarsen_rap(Ad, wm, wp, d, shape)
    lvl = _device_level(Ad, shape, d, wm, wp, cshape, real, device)
    return lvl, Ac, cshape


class SparseMSG:
    """Create/Setup/Solve object (HYPRE_StructSparseMSG* surface)."""

    def __init__(self, config: SparseMSGConfig | None = None):
        self.config = config or SparseMSGConfig()
        self.grids = {}        # l-tuple -> {"dirs": {d: PfmgLevel},
        #                         "children": {d: l'}, "visit": {...}}
        self.fronts = []       # l-tuples grouped by |l|_1
        self.A0 = None
        self._c_inv = None
        self._coarsest = None

    def setup(self, A: StructMatrix) -> "SparseMSG":
        device = get_device()
        real = np_real()
        self.A0 = A
        Ad0 = {off: A.coefs[k].cpu().numpy().astype(real, copy=False)
               for k, off in enumerate(A.offsets)}
        shape0 = tuple(A.shape)

        # per-dim level counts (coarsen while the dim can halve)
        L = [1, 1, 1]
        for d in range(3):
            s = shape0[d]
            while s >= 3 and L[d] < self.config.max_levels:
                L[d] += 1
                s = (s + 1) // 2
        lattice = [(lz, ly, lx) for lz in range(L[0])
                   for ly in range(L[1]) for lx in range(L[2])]
        lattice.sort(key=sum)
        nl_max = max(sum(l) for l in lattice)
        self.fronts = [[l for l in lattice if sum(l) == k]
                       for k in range(nl_max + 1)]

        # operators: each grid's A comes from its canonical parent
        # (z-parent first, then y, then x — any one path; Galerkin
        # semicoarsening RAPs commute for tensor-product transfers)
        ops = {(0, 0, 0): (Ad0, shape0)}
        self.grids = {l: {"dirs": {}, "children": {}, "visit": {}}
                      for l in lattice}
        for front in self.fronts:
            for l in front:
                Ad, shape = ops[l]
                g = self.grids[l]
                dirs = []
                for d in range(3):
                    if l[d] + 1 >= L[d] or shape[d] < 3:
                        continue
                    lc = tuple(l[e] + (1 if e == d else 0)
                               for e in range(3))
                    lvl, Ac, cshape = _grid_level(Ad, shape, d, real,
                                                  device)
                    g["dirs"][d] = lvl
                    g["children"][d] = lc
                    dirs.append(d)
                    if lc not in ops:
                        ops[lc] = (Ac, cshape)
                g["visit"] = _visit_masks(Ad, shape, tuple(dirs), real,
                                          device)

        # coarsest lattice grid: dense inverse (instead of the
        # reference's zero-guess relax — strictly stronger)
        lc = lattice[-1]
        Ad, shape = ops[lc]
        dense = _stencil_to_dense(Ad, shape, real)
        self._c_inv = torch.as_tensor(np.linalg.inv(dense).astype(real),
                                      device=device)
        self._coarsest = (lc, tuple(shape))
        return self

    # -- cycle ---------------------------------------------------------

    def cycle(self, b0):
        """One MSG cycle with zero initial guess (the preconditioner
        application; ref: sparse_msg_solve.c:26)."""
        cfg = self.config
        b = {(0, 0, 0): b0}
        rc = {(0, 0, 0): 1}
        x = {}
        last = len(self.fronts) - 1
        for lvl, front in enumerate(self.fronts):
            for l in front:
                bb = b[l] / rc[l] if rc[l] > 1 else b[l]
                b[l] = bb
                g = self.grids[l]
                if lvl == last:
                    x[l] = (self._c_inv @ bb.reshape(-1)).reshape(
                        self._coarsest[1])
                    continue
                any_lvl = next(iter(g["dirs"].values()))
                if lvl > cfg.jump:
                    u = _pfmg_relax(any_lvl, cfg.relax_type,
                                    cfg.jacobi_weight, bb, None,
                                    cfg.num_pre_relax)
                    r = bb - struct_matvec(any_lvl.A, u)
                    x[l] = u
                else:
                    # jump region: r = b, x = 0 (sparse_msg_solve.c)
                    r = bb
                    x[l] = None
                for d, lc in g["children"].items():
                    rcd = _restrict_apply(g["dirs"][d], r)
                    if lc in b:
                        b[lc] = b[lc] + rcd
                        rc[lc] += 1
                    else:
                        b[lc] = rcd
                        rc[lc] = 1
        # up sweep
        for lvl in range(last - 1, -1, -1):
            for l in self.fronts[lvl]:
                g = self.grids[l]
                corr = 0.0
                for d, lc in g["children"].items():
                    corr = corr + g["visit"][d] * _interp_apply(
                        g["dirs"][d], x[lc])
                u = corr if x[l] is None else x[l] + corr
                if lvl > cfg.jump:
                    any_lvl = next(iter(g["dirs"].values()))
                    u = _pfmg_relax(any_lvl, cfg.relax_type,
                                    cfg.jacobi_weight, b[l], u,
                                    cfg.num_post_relax)
                x[l] = u
        # fine-grid post-relaxation (sparse_msg_solve.c:452-456)
        dirs0 = self.grids[(0, 0, 0)]["dirs"]
        if dirs0 and cfg.num_fine_relax > 0:
            return _pfmg_relax(next(iter(dirs0.values())), cfg.relax_type,
                               cfg.jacobi_weight, b[(0, 0, 0)],
                               x[(0, 0, 0)], cfg.num_fine_relax)
        return x[(0, 0, 0)]

    def precondition(self, r):
        return self.cycle(r)

    # -- solve ---------------------------------------------------------

    def solve(self, b, x0=None, tol=None, max_iter=None):
        """Standalone MSG iteration; returns (x, iterations, relres)."""
        cfg = self.config
        A0 = self.A0
        return mg_solve(
            lambda u: struct_matvec(A0, u), self.cycle,
            as_real(b, A0.coefs.dtype), x0,
            float(tol if tol is not None else cfg.tol),
            int(max_iter or cfg.max_iter))
