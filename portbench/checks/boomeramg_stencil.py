"""The comparison that decides `correct` for a stencil operator with
BoomerAMG-PCG (programs/boomeramg_stencil.py): what the timed path
produced against the plain reference (reference.py), once the window
has closed.

Four numbers, each with its limit from the configuration's file:

* relres_max: the largest ||b - A x|| / ||b|| over the window's sampled
  solutions, A the reference's stencil operator;
* cycle_rel_diff: one preconditioner application of the window, taken
  as it ran, against the reference's V-cycle on its own hierarchy and
  the same residual (max-norm gap over max-norm);
* interp_rel_diff: every row of every level's P against the
  reference's;
* galerkin_rel_diff: every row of every coarse operator against the
  reference's.

A row's gap is its largest entry of |program - reference| over its
largest |reference| entry.  A hierarchy of another depth, or a level
of another size (another C/F split), gaps by 1e300.
"""
from __future__ import annotations

import torch

from portbench import reference as ref


def prog_csr(op, device) -> ref.Csr:
    """A stored operator of the program as the reference's Csr: a CSR
    matrix as it holds it, a dense one through its nonzeros."""
    if hasattr(op, "indptr"):
        ip, ix, v, n_cols = op.indptr, op.indices, op.values, op.n_cols
    else:
        S = op.vals.to_sparse_csr()
        ip, ix, v = S.crow_indices(), S.col_indices(), S.values()
        n_cols = op.vals.shape[1]
    return ref.Csr(ip.to(device, torch.int64), ix.to(device, torch.int64),
                   v.to(device, torch.float64), int(n_cols))


def relres_max(cfg, answers, device) -> float:
    """The largest true relative residual of the sampled solutions."""
    worst = 0.0
    for b, x in answers:
        b = b.to(device, torch.float64)
        r = b - ref.stencil_apply(cfg["grid"], cfg["stencil"],
                                  x.to(device, torch.float64))
        rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
        worst = max(worst, rel if rel == rel else ref.MISMATCH)
    return worst


def level_gaps(levels, mine, coarse, device) -> list:
    """[(interp, galerkin)] a level: the largest row gaps of the
    program's P_l and A_{l+1} against the reference's levels `mine` and
    coarsest A, as far as both hierarchies go."""
    want = [lv.A for lv in mine[1:]] + [coarse]
    return [(ref.row_gap(prog_csr(levels[l].P, device), mine[l].P),
             ref.row_gap(prog_csr(levels[l + 1].A, device), want[l]))
            for l in range(min(len(mine), len(levels) - 1))]


def hierarchy_gaps(levels, mine, coarse, device, detail=None):
    """(interp, galerkin) over all levels; a hierarchy of another depth
    gaps by 1e300.  `detail`, if given, receives the level gaps."""
    gaps = level_gaps(levels, mine, coarse, device)
    if detail is not None:
        detail["levels"] = gaps
    if len(levels) != len(mine) + 1:
        return ref.MISMATCH, ref.MISMATCH
    return (max((g[0] for g in gaps), default=0.0),
            max((g[1] for g in gaps), default=0.0))


def cycle_rel_diff(mine, coarse, cfg, pair, device) -> float:
    """One preconditioner application of the window, z = M r, against
    the reference's V-cycle on the same r."""
    r, z = pair
    cyc = ref.cycle_levels(mine, cfg["grid"], cfg["stencil"], cfg["amg"])
    want = ref.v_cycle(cyc, coarse.sparse().to_dense(), cfg["amg"],
                       r.to(device, torch.float64))
    gap = float((z.to(device, torch.float64) - want).abs().max())
    scale = float(want.abs().max())
    if not gap == gap:
        return ref.MISMATCH
    return gap / scale if scale > 0 else (0.0 if gap == 0 else ref.MISMATCH)


def compare(program, win: dict, cfg: dict, traffic: dict, seed: int,
            device, detail=None) -> dict:
    """Every number with its limit, in the order they are printed;
    `detail`, if given, receives the gaps level by level."""
    levels = program.amg.hierarchy.levels

    def prog_P(l):
        return prog_csr(levels[l].P, device) if l < len(levels) - 1 \
            else None

    def prog_A(l):
        return prog_csr(levels[l].A, device) if 0 < l < len(levels) \
            else None

    vals = {"relres_max": relres_max(cfg, win["answers"], device)}
    mine, coarse = ref.hierarchy(cfg["grid"], cfg["stencil"], cfg["amg"],
                                 device, prog_P, prog_A)
    vals["cycle_rel_diff"] = cycle_rel_diff(mine, coarse, cfg, win["pair"],
                                            device)
    vals["interp_rel_diff"], vals["galerkin_rel_diff"] = hierarchy_gaps(
        levels, mine, coarse, device, detail)
    return {k: {"value": v, "limit": cfg["limits"][k]}
            for k, v in vals.items()}
