"""Distributed BoomerAMG + Krylov on a row-partitioned ParCSR hierarchy.

Port of hypre_tpu/solvers/par_amg.py (``ParBoomerAMG`` :122, ``setup``
:151, ``setup_distributed`` :194, ``_build_level`` :324, ``solve`` :369,
``_par_relax`` :467, ``_par_cheby`` :523, ``par_amg_cycle`` :553), the
ij driver's configuration on many ranks:

  hypre (ref)                         here
  ---------------------------------   --------------------------------
  MPI rank / 1-D block row partition  shard / RowPartition
  CommPkg + Isend/Irecv halo          CommPkg + the communicator's
                                      exchange (parallel/comm.py)
  MPI_Allreduce inner products        the communicator's dot / norm
  gather-to-all coarse GE             all_gather + replicated LU solve,
  (par_gauss_elim.c:185-223)          each shard keeps its own rows
  hybrid GS (GS in-rank, Jacobi       a triangular solve of each
  across, par_relax.c types 3/4/6/    shard's local diag block + the
  8/13/14)                            offd lagged one sweep

The solver text is written once against the communicator, so the same
code runs every shard stacked in one process (``StackedComm``, the CPU
tests and the card) or one shard a rank (``DistComm``).  Stacked, every
level's products are two K2 launches (the block-diagonal diag and the
offd CSR, parallel/parcsr.py) whatever the shard count, and the
smoothers act on the whole ``(n_shards, n_local)`` stack at once: the
dense local triangles as one batched ``solve_triangular``, the sparse
ones as one wavefront schedule (ops/trisolve.py) over the block-diagonal
triangle, the two-stage triangles as one block-diagonal CSR on K2.

Departures from the reference, each on purpose:
  * exact hybrid GS on shards larger than ``exact_gs_max`` runs the
    wavefront solve of the local triangles; the reference falls back
    there to two-stage GS (13/14/8) or Jacobi (3/4/6) (par_amg.py:
    303-305, 494-497);
  * with a stencil fine level, level 0's stored A is not built (it is
    never applied), as the single-device setup does;
  * the Chebyshev bounds are host scalars, not a (n_shards, 2) array.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.core.config import get_config
from hypre_tpu_torch.ops.spmv import CsrMatrix, csr_from_scipy, csr_spmv
from hypre_tpu_torch.ops.trisolve import WavefrontTriSolve, build_trisolve
from hypre_tpu_torch.parallel.comm import StackedComm
from hypre_tpu_torch.parallel.parcsr import (
    ParCSR, ParStencilOp, par_matvec, par_stencil_matvec, par_stencil_op,
    parcsr_from_scipy, shard_vector, to_device_shards, unshard_vector,
)
from hypre_tpu_torch.parallel.partition import RowPartition, true_counts
from hypre_tpu_torch.setup.coarsen import C_PT
from hypre_tpu_torch.setup.l1norms import l1_norms
from hypre_tpu_torch.solvers.amg import (
    EXACT_GS_RELAX, AmgConfig, build_host_hierarchy, chebyshev_setup,
    l1_option_for_relax,
)

DIST_RELAX = (18, 0, 7)    # setup_distributed's smoothers (par_amg.py:218)


@dataclasses.dataclass(frozen=True)
class ParAmgLevel:
    A: Optional[ParCSR]                 # None on a stencil level 0
    P: Optional[ParCSR]
    R: Optional[ParCSR]
    dinv: Optional[torch.Tensor]        # (n_held, n_local)
    cheby_ds: Optional[torch.Tensor] = None
    cheby_bounds: Optional[tuple] = None        # (lmax, lmin)
    gs_lo: Optional[torch.Tensor] = None        # (n_held, nl, nl) D+L
    gs_up: Optional[torch.Tensor] = None
    gs_wf_lo: Optional[WavefrontTriSolve] = None   # block-diagonal D+L
    gs_wf_up: Optional[WavefrontTriSolve] = None
    L: Optional[CsrMatrix] = None       # strict lower of the diag block
    U: Optional[CsrMatrix] = None
    c_mask: Optional[torch.Tensor] = None
    stencil: Optional[ParStencilOp] = None


def level_matvec(lvl: ParAmgLevel, x: torch.Tensor) -> torch.Tensor:
    """A x on a level: the stencil operator where there is one, else the
    ParCSR matvec (par_amg.py:91)."""
    if lvl.stencil is not None:
        return par_stencil_matvec(lvl.stencil, x)
    return par_matvec(lvl.A, x)


def local_matvec(T: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """A shard-local block-diagonal product (no communication)."""
    return csr_spmv(T, x.reshape(-1)).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class ParAmgHierarchy:
    levels: tuple
    c_lu: torch.Tensor          # replicated dense LU of the padded coarse A
    c_piv: torch.Tensor
    relax_weight: float
    num_sweeps: int
    communicator: object
    relax_type: int = 18
    cheby_order: int = 2
    cycle_type: str = "V"
    relax_order: int = 0


def _as_comm(comm):
    return StackedComm(comm) if isinstance(comm, int) else comm


class ParBoomerAMG:
    """Distributed Create/Setup/Solve object.  comm: a communicator
    (StackedComm, DistComm) or a shard count (stacked)."""

    def __init__(self, comm, config: AmgConfig | None = None):
        self.comm = _as_comm(comm)
        self.config = config or AmgConfig()
        self.hierarchy: ParAmgHierarchy | None = None
        self.fine_part = None
        self.level_sizes: list[int] = []
        self.operator_complexity = 1.0
        self.setup_stats: dict = {}
        # setup_distributed: each level's C/F marker in global order
        self.level_cf: list = []

    @property
    def n_shards(self) -> int:
        return self.comm.n_shards

    def _fine_stencil_op(self, fine_stencil, n_local, dtype):
        """ParStencilOp for level 0 when the fine operator is a known
        stencil and the halo fits one slab neighbour (par_amg.py:134)."""
        if fine_stencil is None:
            return None
        shape, entries = fine_stencil
        op = par_stencil_op(shape, entries, n_local, self.comm, dtype)
        return op if op.maxdisp <= n_local else None

    def setup(self, A: sp.csr_matrix, fine_stencil=None) -> "ParBoomerAMG":
        """The host setup (build_host_hierarchy, bit for bit the
        reference's), then each level sharded.  fine_stencil=((nx, ny,
        nz), entries): level 0 is applied matrix-free (ParStencilOp)."""
        cfg = self.config
        ns = self.n_shards
        dtype = get_config().real_dtype
        t0 = time.perf_counter()
        levels_host, Ac = build_host_hierarchy(A, cfg)
        t1 = time.perf_counter()
        opt = l1_option_for_relax(cfg.relax_type)
        parts = [RowPartition.create(lvl[0].shape[0], ns)
                 for lvl in levels_host]
        parts.append(RowPartition.create(Ac.shape[0], ns))

        par_levels = []
        for i, (Al, Pl, Rl, cfm) in enumerate(levels_host):
            st = self._fine_stencil_op(fine_stencil, parts[i].n_local,
                                       dtype) if i == 0 else None
            par_levels.append(self._build_level(
                Al, Pl, Rl, cfm, parts[i], parts[i + 1], opt, dtype, st))
        par_levels.append(ParAmgLevel(
            A=parcsr_from_scipy(Ac, ns, dtype, communicator=self.comm),
            P=None, R=None, dinv=None))
        # padded dense coarse matrix: identity on padding rows
        cpart = parts[-1]
        dense = np.eye(cpart.n_padded)
        dense[:Ac.shape[0], :Ac.shape[1]] = Ac.toarray()
        self._finish(par_levels, dense, parts, dtype)
        nnz = [lvl[0].nnz for lvl in levels_host] + [Ac.nnz]
        self.operator_complexity = sum(nnz) / A.nnz
        self.setup_stats = {"host_hierarchy_s": t1 - t0,
                            "shard_s": time.perf_counter() - t1}
        return self

    def _finish(self, par_levels, dense, parts, dtype):
        cfg = self.config
        c_lu, c_piv = torch.linalg.lu_factor(torch.as_tensor(
            dense, dtype=dtype, device=self.comm.device))
        self.hierarchy = ParAmgHierarchy(
            levels=tuple(par_levels), c_lu=c_lu, c_piv=c_piv,
            relax_weight=cfg.relax_weight, num_sweeps=cfg.num_sweeps,
            communicator=self.comm, relax_type=cfg.relax_type,
            cheby_order=cfg.cheby_order, cycle_type=cfg.cycle_type,
            relax_order=cfg.relax_order)
        self.fine_part = parts[0]
        self.level_sizes = [p.n_global for p in parts]

    def setup_distributed(self, A, fine_stencil=None) -> "ParBoomerAMG":
        """The distributed setup (parallel/par_setup.py): the hierarchy
        is built on the stacked shards, no global level is formed, and
        each level is converted shard by shard into the solve's ParCSR.
        A: a global scipy matrix (sliced per shard on ingest) or a
        ParDEll.  Jacobi-family smoothers only (18/0/7), as the
        reference (par_amg.py:218).  Ref: par_amg_setup.c:29, NP > 1."""
        from hypre_tpu_torch.parallel.par_setup import (
            ParDEll, dense_coarse, iter_par_hierarchy, pardell_from_scipy,
            real_rows,
        )
        from hypre_tpu_torch.parallel.parcsr import parcsr_from_pardell

        cfg = self.config
        if cfg.relax_type not in DIST_RELAX:
            raise ValueError(
                f"relax_type {cfg.relax_type} needs host factorization"
                " in the distributed setup; use setup()")
        dtype = get_config().real_dtype
        t0 = time.perf_counter()
        if not isinstance(A, ParDEll):
            part = RowPartition.create(A.shape[0], self.n_shards)
            A = pardell_from_scipy(A, part, communicator=self.comm)
        opt = l1_option_for_relax(cfg.relax_type)
        par_levels, parts, nnz = [], [], []
        self.level_cf = []
        Ac = None
        for item in iter_par_hierarchy(A, cfg, self.comm):
            if not isinstance(item, tuple):
                Ac = item
                break
            Al, Pl, Rl, cfm = item
            self.level_cf.append(cfm.reshape(-1)[real_rows(
                Al.row_part, cfm.device).reshape(-1)])
            parts.append(Al.row_part)
            nnz.append(Al.nnz())
            st = self._fine_stencil_op(fine_stencil, Al.row_part.n_local,
                                       dtype) if not par_levels else None
            par_levels.append(ParAmgLevel(
                A=None if st is not None else parcsr_from_pardell(Al, dtype),
                P=parcsr_from_pardell(Pl, dtype),
                R=parcsr_from_pardell(Rl, dtype),
                dinv=(1.0 / Al.l1_norms(opt)).to(dtype),
                c_mask=((cfm == C_PT).to(dtype) if cfg.relax_order
                        else None),
                stencil=st))
        parts.append(Ac.row_part)
        nnz.append(Ac.nnz())
        par_levels.append(ParAmgLevel(A=parcsr_from_pardell(Ac, dtype),
                                      P=None, R=None, dinv=None))
        self._finish(par_levels, dense_coarse(Ac), parts, dtype)
        self.operator_complexity = sum(nnz) / nnz[0]
        self.setup_stats = {"setup_s": time.perf_counter() - t0}
        return self

    def _build_level(self, Al, Pl, Rl, cfm, rp, cp, opt, dtype,
                     stencil) -> ParAmgLevel:
        """Per-level smoother precompute, sharded (par_amg.py:324)."""
        cfg = self.config
        comm = self.comm
        ns = self.n_shards
        s0, nh = comm.shards.start, comm.n_held

        def vec(a):
            return to_device_shards(a, rp, comm, dtype)

        dl1 = l1_norms(Al, opt)
        extra = {}
        rt = cfg.relax_type
        if rt == 16:
            ds, bounds = chebyshev_setup(Al, cfg.cheby_fraction,
                                         cfg.cheby_eig_iters)
            extra.update(cheby_ds=vec(ds),
                         cheby_bounds=(float(bounds[0]), float(bounds[1])))
        elif rt in EXACT_GS_RELAX or rt in (11, 12):
            B = _local_block_diag(Al, rp, s0, nh)
            if rt in (11, 12):
                extra.update(L=csr_from_scipy(sp.tril(B, -1), dtype,
                                              comm.device),
                             U=csr_from_scipy(sp.triu(B, 1), dtype,
                                              comm.device))
            else:
                d = shard_vector(dl1, rp)[s0:s0 + nh]
                pad = np.arange(rp.n_local)[None, :] >= true_counts(rp)[
                    s0:s0 + nh, None]
                d = np.where(pad, 1.0, d).reshape(-1)   # identity rows
                if rp.n_local <= cfg.exact_gs_max:
                    lo, up = _dense_local_triangles(B, d, nh, rp.n_local)
                    extra.update(
                        gs_lo=torch.as_tensor(lo, dtype=dtype,
                                              device=comm.device),
                        gs_up=torch.as_tensor(up, dtype=dtype,
                                              device=comm.device))
                else:
                    extra.update(
                        gs_wf_lo=build_trisolve(B, d, backward=False,
                                                dtype=dtype,
                                                device=comm.device),
                        gs_wf_up=build_trisolve(B, d, backward=True,
                                                dtype=dtype,
                                                device=comm.device))
        if cfg.relax_order and cfm is not None:
            extra.update(c_mask=vec((cfm == C_PT).astype(np.float64)))
        return ParAmgLevel(
            A=(None if stencil is not None else
               parcsr_from_scipy(Al, ns, dtype, communicator=comm)),
            P=parcsr_from_scipy(Pl, ns, dtype, row_part=rp, col_part=cp,
                                communicator=comm),
            R=parcsr_from_scipy(Rl, ns, dtype, row_part=cp, col_part=rp,
                                communicator=comm),
            dinv=vec(1.0 / dl1), stencil=stencil, **extra)

    # -- solve --------------------------------------------------------

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        return par_amg_cycle(self.hierarchy, r)

    def fine_matvec(self, x: torch.Tensor) -> torch.Tensor:
        return level_matvec(self.hierarchy.levels[0], x)

    def shard(self, b) -> torch.Tensor:
        """A global vector as this communicator's shards on its device."""
        return to_device_shards(np.asarray(b, np.float64), self.fine_part,
                                self.comm, get_config().real_dtype)

    def solve_sharded(self, b_sh: torch.Tensor, method: str = "pcg",
                      tol: float = 1e-8, max_iter: int = 1000, **kw):
        """The solve on sharded vectors: b_sh (n_held, n_local) on the
        device; returns the Krylov result with x sharded."""
        from hypre_tpu_torch.solvers import krylov, krylov_more

        fns = {"pcg": krylov.pcg, "gmres": krylov_more.gmres,
               "flexgmres": krylov_more.flexgmres,
               "lgmres": krylov_more.lgmres,
               "cogmres": krylov_more.cogmres,
               "bicgstab": krylov_more.bicgstab, "cgnr": krylov_more.cgnr}
        return fns[method](self.fine_matvec, b_sh, M=self.precondition,
                           tol=tol, max_iter=max_iter, dot=self.comm.dot,
                           norm=self.comm.norm, **kw)

    def solve(self, b: np.ndarray, method: str = "pcg",
              tol: float = 1e-8, max_iter: int = 1000, **kw):
        """AMG-preconditioned Krylov solve over the shards (par_amg.py:
        369).  method in {pcg, gmres, flexgmres, lgmres, cogmres,
        bicgstab, cgnr}.  Returns (x, iters, relres), x a global numpy
        array."""
        res = self.solve_sharded(self.shard(b), method, tol, max_iter, **kw)
        x = unshard_vector(self.comm.gather_host(res.x), self.fine_part)
        return x, int(res.iters), float(res.relres)

    def solve_pcg(self, b: np.ndarray, tol: float = 1e-8,
                  max_iter: int = 1000):
        return self.solve(b, method="pcg", tol=tol, max_iter=max_iter)


def _local_block_diag(Al, rp, s0: int, nh: int) -> sp.csr_matrix:
    """The held shards' diag blocks as one block-diagonal matrix in the
    padded stacked order (n_held n_local square; padding rows empty)."""
    A = Al.tocoo()
    nl = rp.n_local
    p = rp.owner(A.row)
    keep = (rp.owner(A.col) == p) & (p >= s0) & (p < s0 + nh)
    rows = A.row[keep] - s0 * nl
    cols = A.col[keep] - s0 * nl
    B = sp.csr_matrix((A.data[keep], (rows, cols)), shape=(nh * nl, nh * nl))
    B.sort_indices()
    return B


def _dense_local_triangles(B, d, nh: int, nl: int):
    """Dense (n_held, nl, nl) D+L / D+U of each shard's diag block with
    the l1 diagonal d, identity on padding rows (par_amg.py:389)."""
    C = B.tocoo()
    sh, i, j = C.row // nl, C.row % nl, C.col % nl
    lo = np.zeros((nh, nl, nl))
    up = np.zeros((nh, nl, nl))
    low = j < i
    lo[sh[low], i[low], j[low]] = C.data[low]
    high = j > i
    up[sh[high], i[high], j[high]] = C.data[high]
    k = np.arange(nl)
    dd = d.reshape(nh, nl)
    lo[:, k, k] = dd
    up[:, k, k] = dd
    return lo, up


# ---------------------------------------------------------------------------
# the cycle
# ---------------------------------------------------------------------------

def _par_relax(lvl: ParAmgLevel, relax_type: int, w, f, u, num_sweeps,
               cheby_order: int = 2, relax_order: int = 0,
               up: bool = False):
    """Distributed smoother dispatch (ref: par_relax.c:24; par_amg.py:
    467).  Shard boundary = rank boundary: hybrid GS is exact GS on the
    local diag block with the offd contribution lagged one sweep."""
    dinv = lvl.dinv
    if relax_type == 16:
        return _par_cheby(lvl, f, u, cheby_order, num_sweeps)

    if relax_type in EXACT_GS_RELAX and (lvl.gs_lo is not None
                                         or lvl.gs_wf_lo is not None):
        def gs_sweep(u, back):
            r = f if u is None else f - level_matvec(lvl, u)
            if lvl.gs_lo is not None:
                T = lvl.gs_up if back else lvl.gs_lo
                z = torch.linalg.solve_triangular(
                    T, r[..., None], upper=back)[..., 0]
            else:
                wf = lvl.gs_wf_up if back else lvl.gs_wf_lo
                z = wf.solve(r.reshape(-1)).reshape(r.shape)
            return z if u is None else u + z

        for _ in range(num_sweeps):
            if relax_type in (6, 8):       # symmetric (l1-)GS
                u = gs_sweep(gs_sweep(u, False), True)
            elif relax_type in (13, 3):    # forward down, backward up
                u = gs_sweep(u, up)
            else:                          # 14, 4: backward down
                u = gs_sweep(u, not up)
        return u

    two_stage = relax_type in (11, 12, 13, 14, 8) and lvl.L is not None
    tri = None
    if two_stage:
        back = up if relax_type != 14 else not up
        tri = lvl.U if back else lvl.L

    def jac_update(u):
        r = f if u is None else f - level_matvec(lvl, u)
        z = w * dinv * r
        if two_stage:
            z = z - dinv * local_matvec(tri, z)
        return z if u is None else u + z

    if relax_order and lvl.c_mask is not None:
        first = lvl.c_mask if not up else (1.0 - lvl.c_mask)
        for _ in range(num_sweeps):
            z = jac_update(u)
            u = first * z if u is None else torch.where(first > 0, z, u)
            z = jac_update(u)
            u = torch.where(first > 0, u, z)
        return u

    for _ in range(num_sweeps):
        u = jac_update(u)
    return u


def _par_cheby(lvl: ParAmgLevel, f, u, order: int, num_sweeps: int):
    """Distributed Chebyshev smoothing (relax 16, ref: par_cheby.c;
    par_amg.py:523)."""
    lmax, lmin = lvl.cheby_bounds
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    d = lvl.cheby_ds

    def op(z):
        return d * level_matvec(lvl, d * z)

    for _ in range(num_sweeps):
        u_s = None if u is None else u / torch.where(d != 0, d, 1.0)
        f_s = d * f
        r = f_s if u_s is None else f_s - op(u_s)
        p = r / theta
        u_s = p if u_s is None else u_s + p
        rho_old = 1.0 / sigma
        for _k in range(1, order):
            rho = 1.0 / (2.0 * sigma - rho_old)
            r = f_s - op(u_s)
            p = rho * rho_old * p + (2.0 * rho / delta) * r
            u_s = u_s + p
            rho_old = rho
        u = d * u_s
    return u


def par_amg_cycle(h: ParAmgHierarchy, f: torch.Tensor) -> torch.Tensor:
    """One distributed multigrid cycle with zero initial guess: V by
    default, W and F recursively (ref: par_cycle.c:23,194-226)."""
    return _par_cycle_at(h, 0, f, h.cycle_type)


def _par_cycle_at(h: ParAmgHierarchy, l: int, f, ctype: str):
    levels = h.levels
    nl = len(levels)
    comm = h.communicator
    if l == nl - 1:
        # coarsest: gather to all, replicated dense solve, own rows
        # (par_gauss_elim.c:185-223)
        f_all = comm.all_gather(f)
        u_all = torch.linalg.lu_solve(h.c_lu, h.c_piv, f_all[:, None])[:, 0]
        return comm.own_rows(u_all, f.shape[1])
    lvl = levels[l]
    w, ns = h.relax_weight, h.num_sweeps
    u = _par_relax(lvl, h.relax_type, w, f, None, ns, h.cheby_order,
                   h.relax_order, up=False)
    r = f - level_matvec(lvl, u)
    fc = par_matvec(lvl.R, r)
    if ctype == "W" and l < nl - 2:
        uc = _par_cycle_at(h, l + 1, fc, "W")
        rc = fc - level_matvec(levels[l + 1], uc)
        uc = uc + _par_cycle_at(h, l + 1, rc, "W")
    elif ctype == "F" and l < nl - 2:
        uc = _par_cycle_at(h, l + 1, fc, "F")
        rc = fc - level_matvec(levels[l + 1], uc)
        uc = uc + _par_cycle_at(h, l + 1, rc, "V")
    else:
        uc = _par_cycle_at(h, l + 1, fc, "V" if ctype != "W" else ctype)
    u = u + par_matvec(lvl.P, uc)
    return _par_relax(lvl, h.relax_type, w, f, u, ns, h.cheby_order,
                      h.relax_order, up=True)
