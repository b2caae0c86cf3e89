"""BoomerAMG: host or device setup + V-cycle solve on the card.

Port of hypre_tpu/solvers/amg.py, cut to the branches that hypre's
out.14 benchmark and the ij driver's defaults (HMIS or PMIS, interp 3
or 6, relax 13) reach (setup driver ref: src/parcsr_ls/par_amg_setup.c:
29; cycle ref: par_cycle.c:23; solve ref: par_amg_solve.c:22).  Two
setups:

* ``setup`` runs on the host (numpy plus the OpenMP kernels, f64) and
  is the reference's own algorithm, so the hierarchy is the same bit for
  bit;
* ``setup_device`` runs the whole setup on the card in f64
  (setup/device_amg.py, the counterpart of the reference's
  ``setup_device``, amg.py:526-666) and packs each level there.

The solve phase runs eagerly on torch tensors: l1/weighted Jacobi
(relax 18/0/7) or exact (l1-)Gauss-Seidel (relax 3/4/6/8/13/14: dense
triangular factors on small levels, the wavefront solve of
ops/trisolve.py above ``exact_gs_max`` rows), a V-cycle, and a dense LU
on the coarsest level.

Options of AmgConfig that the port does not carry yet raise
NotImplementedError at setup.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.core.config import (
    as_real, get_config, get_device, synchronize,
)
from hypre_tpu_torch.ops.formats import (
    SparseOp, dense_from_dell, matvec, sparse_op_from_dell,
    sparse_op_from_scipy,
)
from hypre_tpu_torch.ops.stencil import stencil_op
from hypre_tpu_torch.ops.trisolve import WavefrontTriSolve, build_trisolve
from hypre_tpu_torch.setup.coarsen import C_PT, hmis, pmis
from hypre_tpu_torch.setup.interp import direct_interp
from hypre_tpu_torch.setup.interp_ext import extpi_interp
from hypre_tpu_torch.setup.l1norms import l1_norms
from hypre_tpu_torch.setup.strength import strength_matrix


@dataclasses.dataclass
class AmgConfig:
    max_levels: int = 25
    max_coarse_size: int = 9          # ref: par_amg.c:163
    strong_threshold: float = 0.25    # ref: par_amg.c:168
    max_row_sum: float = 0.9          # ref: par_amg.c:172
    coarsen_type: str = "pmis"        # GPU default (docs solvers-boomeramg.rst:61)
    interp_type: int = 3              # direct; 6 = ext+i (hypre default)
    trunc_factor: float = 0.0
    p_max_elmts: int = 4              # ref: par_amg.c:182
    relax_type: int = 18              # l1-Jacobi (GPU-friendly default here)
    relax_weight: float = 1.0
    num_sweeps: int = 1
    relax_order: int = 0              # 1 = C-points first (par_amg.c:269)
    cycle_type: str = "V"             # V, W, or F
    agg_num_levels: int = 0           # aggressive coarsening levels
    agg_interp_type: int = 4          # multipass (par_amg.c:194)
    agg_trunc_factor: float = 0.0
    agg_p_max_elmts: int = 0
    agg_p12_trunc_factor: float = 0.0
    agg_p12_max_elmts: int = 0
    num_paths: int = 1
    restr_type: int = 0               # 0: R=P^T; 1: distance-1 lAIR
    nongalerk_tol: tuple = ()         # per-level drop tolerances
    nongalerk_tol_all: float = 0.0
    additive: int = -1                # first additive level; -1 = off
    simple: int = -1
    add_last_lvl: int = -1
    seed: int = 2747
    exact_gs_max: int = 8192          # exact GS: dense factors up to here
    cheby_order: int = 2              # Chebyshev relax 16 (not ported)
    cheby_fraction: float = 0.3
    cheby_eig_iters: int = 20
    prefer_dia: bool = True           # level A as DIA where it is a stencil
    gsmg: int = 0
    num_samples: int = 5
    gsmg_sweeps: int = 5
    num_functions: int = 1
    nodal: int = 0
    nodal_diag: int = 0
    dof_func: object = None
    print_level: int = 0              # >=1: per-level trace to stderr


JACOBI_RELAX = (18, 0, 7)             # the device setup's smoothers
EXACT_GS_RELAX = (3, 4, 6, 8, 13, 14)
PORTED_RELAX = JACOBI_RELAX + EXACT_GS_RELAX
DEVICE_RELAX_LATER = (16, 11, 12)     # the reference's device setup has them


def check_ported(cfg: AmgConfig) -> None:
    """Raise NotImplementedError for an option outside the slice."""
    unported = []
    if cfg.coarsen_type not in ("pmis", "hmis"):
        unported.append(f"coarsen_type={cfg.coarsen_type!r}")
    if cfg.interp_type not in (3, 6):
        unported.append(f"interp_type={cfg.interp_type}")
    if cfg.relax_type not in PORTED_RELAX:
        unported.append(f"relax_type={cfg.relax_type}")
    if cfg.cycle_type != "V":
        unported.append(f"cycle_type={cfg.cycle_type!r}")
    for name, off in (("relax_order", 0), ("agg_num_levels", 0),
                      ("restr_type", 0), ("nongalerk_tol", ()),
                      ("nongalerk_tol_all", 0.0), ("additive", -1),
                      ("simple", -1), ("gsmg", 0), ("num_functions", 1),
                      ("nodal", 0), ("dof_func", None)):
        if getattr(cfg, name) != off:
            unported.append(f"{name}={getattr(cfg, name)!r}")
    if unported:
        raise NotImplementedError(
            "not in the port yet (see ROADMAP.md Queue 1): "
            + ", ".join(unported))


@dataclasses.dataclass(frozen=True)
class AmgLevel:
    A: SparseOp
    P: Optional[SparseOp]       # None on the coarsest level
    R: Optional[SparseOp]       # explicit P^T
    dinv: Optional[torch.Tensor]  # 1 / smoother diagonal (l1 norms)
    gs_lo: Optional[torch.Tensor] = None  # dense D+L (exact GS, small)
    gs_up: Optional[torch.Tensor] = None  # dense D+U
    gs_wf_lo: Optional[WavefrontTriSolve] = None  # exact GS, large
    gs_wf_up: Optional[WavefrontTriSolve] = None


@dataclasses.dataclass(frozen=True)
class AmgHierarchy:
    levels: tuple               # tuple[AmgLevel]
    c_lu: torch.Tensor          # dense LU of the coarsest A
    c_piv: torch.Tensor         # 1-based LAPACK pivots (torch convention)
    relax_weight: float
    num_sweeps: int
    relax_type: int = 18


def iter_host_hierarchy(A: sp.csr_matrix, cfg: AmgConfig):
    """Generator form of the level loop of hypre_BoomerAMGSetup
    (ref: src/parcsr_ls/par_amg_setup.c:990-3155): strength → coarsen →
    interp → RAP until the coarse grid is small enough.  Yields
    (A_l, P_l, R_l, cf_l) per level, then the coarsest A last."""
    check_ported(cfg)
    Al = A.tocsr()
    if Al.data.dtype != np.float64:
        # setup runs in f64 (hypre semantics); converting once here
        # makes every native kernel's f64 view a no-copy pass-through
        Al = Al.astype(np.float64)
    for _level in range(cfg.max_levels - 1):
        n = Al.shape[0]
        if n <= cfg.max_coarse_size:
            break
        S, strong_mask = strength_matrix(
            Al, cfg.strong_threshold, cfg.max_row_sum, return_mask=True)
        if cfg.coarsen_type == "hmis":
            cf = hmis(S, seed=cfg.seed)
        else:
            cf = pmis(S, seed=cfg.seed)
        n_coarse = int((cf == C_PT).sum())
        if n_coarse == 0 or n_coarse == n:
            break
        interp = direct_interp if cfg.interp_type == 3 else extpi_interp
        P = interp(Al, S, cf, cfg.trunc_factor, cfg.p_max_elmts,
                   strong_mask=strong_mask)
        from hypre_tpu_torch.setup.utils import native_enabled

        if native_enabled():
            from hypre_tpu_torch.csrc import build as native

            R = native.csr_transpose(P)
            AP = native.spgemm(Al.tocsr(), P)
            Ac = native.spgemm(R, AP)
        else:
            R = P.T.tocsr()
            AP = (Al @ P).tocsr()
            Ac = (R @ AP).tocsr()
            Ac.sort_indices()
        yield (Al, P, R, cf)
        Al = Ac
    yield Al


def l1_option_for_relax(relax_type: int) -> int:
    if relax_type == 18:
        return 1
    if relax_type in (13, 14, 8):
        return 4
    return 5  # plain diagonal (Jacobi types 0/7, exact GS 3/4/6)


class BoomerAMG:
    """Create/Setup/Solve object, mirroring the hypre solver shape
    ({Create, Setup(A,b,x), Solve(A,b,x)}, ref: SURVEY §1 object model).
    """

    def __init__(self, config: AmgConfig | None = None):
        self.config = config or AmgConfig()
        self.hierarchy: AmgHierarchy | None = None
        self.level_sizes: list[int] = []
        self.level_nnz: list[int] = []
        self.grid_complexity = 1.0
        self.operator_complexity = 1.0
        self.setup_stats: list[dict] = []

    # -- setup --------------------------------------------------------

    def setup(self, A: sp.csr_matrix, fine_stencil=None) -> "BoomerAMG":
        """Build the hierarchy on the host and move each level to the
        configured device as soon as it is built.

        fine_stencil=((nx,ny,nz), entries): the fine operator is that
        constant stencil, so level 0 becomes a StencilOp applied by
        kernel K1 and A itself is never stored on the device."""
        cfg = self.config
        device = get_device()
        dtype = get_config().real_dtype
        t0 = time.perf_counter()

        def trace(msg):
            if cfg.print_level >= 1:
                print(f"  [amg setup +{time.perf_counter() - t0:7.1f}s] "
                      f"{msg}", file=sys.stderr, flush=True)

        levels = []
        self.level_sizes, self.level_nnz = [], []
        Al = None
        for item in iter_host_hierarchy(A, cfg):
            if not isinstance(item, tuple):
                Al = item
                break
            Ah = item[0]
            trace(f"level {len(levels)} host built "
                  f"(n={Ah.shape[0]}, nnz={Ah.nnz})")
            a_op = None
            if not levels and fine_stencil is not None:
                a_op = stencil_op(*fine_stencil, dtype=dtype)
            levels.append(self._build_dev_level(*item, a_op=a_op,
                                                dtype=dtype, device=device))
            trace(f"level {len(levels) - 1} on the device")
            self.level_sizes.append(Ah.shape[0])
            self.level_nnz.append(Ah.nnz)
        # coarsest level: dense LU
        levels.append(AmgLevel(
            A=sparse_op_from_scipy(Al, dtype, device,
                                   prefer_dia=cfg.prefer_dia),
            P=None, R=None, dinv=None))
        dense = torch.as_tensor(Al.toarray(), dtype=dtype, device=device)
        c_lu, c_piv = torch.linalg.lu_factor(dense)
        self.level_sizes.append(Al.shape[0])
        self.level_nnz.append(Al.nnz)
        trace("coarsest level factored on the device")

        self.hierarchy = AmgHierarchy(
            levels=tuple(levels), c_lu=c_lu, c_piv=c_piv,
            relax_weight=cfg.relax_weight, num_sweeps=cfg.num_sweeps,
            relax_type=cfg.relax_type)
        self.grid_complexity = sum(self.level_sizes) / self.level_sizes[0]
        self.operator_complexity = sum(self.level_nnz) / A.nnz
        return self

    def _build_dev_level(self, Ah, Ph, Rh, cfm, a_op=None, *, dtype,
                         device) -> AmgLevel:
        """One level on the device (amg.py:440-522): A in the format the
        reference picks (P and R never DIA), the smoother's inverse l1
        diagonal and, for exact GS, its triangular factors."""
        cfg = self.config
        dl1 = l1_norms(Ah, l1_option_for_relax(cfg.relax_type))
        gs = {}
        if cfg.relax_type in EXACT_GS_RELAX:
            # exact (l1-)GS (ref: par_relax.c:24, types 3/4/6/8/13/14):
            # dense triangular factors on small levels, the wavefront
            # solve above exact_gs_max rows (amg.py:453-475)
            if Ah.shape[0] <= cfg.exact_gs_max:
                lo = sp.tril(Ah, -1).toarray()
                up = sp.triu(Ah, 1).toarray()
                np.fill_diagonal(lo, dl1)
                np.fill_diagonal(up, dl1)
                gs["gs_lo"] = torch.as_tensor(lo, dtype=dtype, device=device)
                gs["gs_up"] = torch.as_tensor(up, dtype=dtype, device=device)
            else:
                gs["gs_wf_lo"] = build_trisolve(Ah, dl1, backward=False,
                                                dtype=dtype, device=device)
                gs["gs_wf_up"] = build_trisolve(Ah, dl1, backward=True,
                                                dtype=dtype, device=device)
        return AmgLevel(
            A=(a_op if a_op is not None
               else sparse_op_from_scipy(Ah, dtype, device,
                                         prefer_dia=cfg.prefer_dia)),
            P=sparse_op_from_scipy(Ph, dtype, device, prefer_dia=False),
            R=sparse_op_from_scipy(Rh, dtype, device, prefer_dia=False),
            dinv=torch.as_tensor(1.0 / dl1, dtype=dtype, device=device),
            **gs)

    # -- device-resident setup ------------------------------------------

    def setup_device(self, A=None, *, stencil=None) -> "BoomerAMG":
        """Device-resident setup: the whole setup phase runs on the card
        in f64 (setup/device_amg.py builds the hierarchy, ops/formats.py
        packs each level), the analog of hypre's device setup path (ref:
        src/parcsr_ls/par_amg_setup.c:29 with exec policy DEVICE).  The
        host sees only per-level scalars.

        A: a scipy matrix (uploaded once) or a device_amg.DEll; or
        stencil=(shape, entries), which generates the fine operator on
        the card (ref: par_laplace.c:63); level 0 is then a StencilOp
        applied by kernel K1.  Always coarsens by PMIS, as the reference
        does.  Relax 18/0/7 only.

        After it, ``setup_stats`` holds one dict per level: the wall
        seconds of strength, PMIS (and its rounds), interpolation, RAP
        and packing, with the widths."""
        from hypre_tpu_torch.setup import device_amg as dev

        cfg = self.config
        if cfg.relax_type in DEVICE_RELAX_LATER:
            raise NotImplementedError(
                f"relax_type {cfg.relax_type} on the device setup is not in "
                "the port yet (see ROADMAP.md Queue 1, slice 3)")
        if cfg.relax_type not in JACOBI_RELAX:
            raise ValueError(
                f"relax_type {cfg.relax_type} needs host factorization;"
                " use setup()")
        check_ported(cfg)
        device = get_device()
        dtype = get_config().real_dtype
        t0 = time.perf_counter()

        def trace(msg):
            if cfg.print_level >= 1:
                print(f"  [amg setup_device +{time.perf_counter() - t0:7.3f}s]"
                      f" {msg}", file=sys.stderr, flush=True)

        fine_op = None
        if stencil is not None:
            shape, entries = stencil
            A = dev.dell_stencil(shape, entries, torch.float64, device)
            fine_op = stencil_op(shape, entries, dtype=dtype)
            trace("fine operator generated on the device")
        elif not isinstance(A, dev.DEll):
            A = dev.dell_from_scipy(A, torch.float64, device)
        else:
            A = dev.DEll(cols=A.cols.to(device),
                         vals=A.vals.to(device, torch.float64),
                         n_cols=A.n_cols)

        levels = []
        self.level_sizes, self.level_nnz = [], []
        self.setup_stats = []
        Al = None
        for item in dev.iter_device_hierarchy(A, cfg, self.setup_stats,
                                              trace):
            if not isinstance(item, tuple):
                Al = item
                break
            t1 = time.perf_counter()
            Ah = item[0]
            self.level_sizes.append(Ah.n_rows)
            self.level_nnz.append(int(Ah.mask.sum()))
            a_op = fine_op if not levels else None
            levels.append(self._build_dev_level_dell(*item, a_op=a_op,
                                                     dtype=dtype))
            synchronize(device)
            self.setup_stats[len(levels) - 1]["pack_s"] = \
                time.perf_counter() - t1
            trace(f"level {len(levels) - 1} packed (n={Ah.n_rows}, "
                  f"nnz={self.level_nnz[-1]}, "
                  f"fmt={type(levels[-1].A).__name__})")
        # coarsest level: dense LU on the device
        self.level_sizes.append(Al.n_rows)
        self.level_nnz.append(int(Al.mask.sum()))
        dense = dense_from_dell(Al, dtype)
        levels.append(AmgLevel(A=dense, P=None, R=None, dinv=None))
        c_lu, c_piv = torch.linalg.lu_factor(dense.vals)
        synchronize(device)
        trace(f"coarsest dense LU (n={Al.n_rows})")

        self.hierarchy = AmgHierarchy(
            levels=tuple(levels), c_lu=c_lu, c_piv=c_piv,
            relax_weight=cfg.relax_weight, num_sweeps=cfg.num_sweeps,
            relax_type=cfg.relax_type)
        self.grid_complexity = sum(self.level_sizes) / self.level_sizes[0]
        self.operator_complexity = sum(self.level_nnz) / self.level_nnz[0]
        return self

    def _build_dev_level_dell(self, Al, P, PT, cf, a_op=None, *,
                              dtype) -> AmgLevel:
        """Pack one device-built level (amg.py:623-654): A (unless the
        stencil operator stands in for it), P, R = P^T and the smoother's
        inverse l1 diagonal, all on the card."""
        from hypre_tpu_torch.setup import device_amg as dev

        l1 = dev.device_l1_norms(Al, l1_option_for_relax(
            self.config.relax_type))
        return AmgLevel(
            A=a_op if a_op is not None else sparse_op_from_dell(Al, dtype),
            P=sparse_op_from_dell(P, dtype),
            R=sparse_op_from_dell(PT, dtype),
            dinv=(1.0 / l1).to(dtype))

    @property
    def level_formats(self) -> list[str]:
        return [type(lvl.A).__name__ for lvl in self.hierarchy.levels]

    # -- solve --------------------------------------------------------

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        """One cycle with zero initial guess (the PCG preconditioner)."""
        return amg_cycle(self.hierarchy, r)

    def solve(self, b, x0=None, tol: float = 1e-8, max_iter: int = 20):
        """Standalone AMG iteration (hypre_BoomerAMGSolve semantics:
        cycle + 2-norm relative-residual check, ref: par_amg_solve.c:
        265-335).  Returns (x, iterations, relative residual)."""
        h = self.hierarchy
        A0 = h.levels[0].A
        b = as_real(b, h.c_lu.dtype)
        x = torch.zeros_like(b) if x0 is None else as_real(x0, b.dtype)
        bnorm = float(torch.linalg.vector_norm(b))
        safe_b = bnorm if bnorm > 0 else 1.0
        r = b - matvec(A0, x)
        rnorm = float(torch.linalg.vector_norm(r))
        it = 0
        while it < max_iter and rnorm / safe_b > tol:
            x = x + amg_cycle(h, r)
            r = b - matvec(A0, x)
            rnorm = float(torch.linalg.vector_norm(r))
            it += 1
        return x, it, rnorm / safe_b


def _relax(lvl: AmgLevel, relax_type: int, w: float, f: torch.Tensor,
           u: Optional[torch.Tensor], num_sweeps: int,
           up: bool = False) -> torch.Tensor:
    """Smoother dispatch (ref: par_relax.c:24 hypre_BoomerAMGRelax).

    18 / 7 / 0: (l1-)Jacobi, u += w * dinv * (f - A u); the first sweep
    from u = 0 folds to u = w * dinv * f.
    3 / 4 / 6 / 8 / 13 / 14: exact (l1-)GS, u += (D + T)^{-1} (f - A u)
    with T the strict lower (forward) or upper (backward) part: 13 and 3
    forward going down and backward going up, 14 and 4 the reverse, 6
    and 8 symmetric (a forward then a backward sweep); the weight is not
    applied (amg.py:861-885)."""
    A, dinv = lvl.A, lvl.dinv
    if relax_type in EXACT_GS_RELAX:
        def gs_sweep(u, back):
            r = f if u is None else f - matvec(A, u)
            if lvl.gs_lo is not None:
                T = lvl.gs_up if back else lvl.gs_lo
                z = torch.linalg.solve_triangular(
                    T, r[:, None], upper=back)[:, 0]
            else:
                z = (lvl.gs_wf_up if back else lvl.gs_wf_lo).solve(r)
            return z if u is None else u + z

        for _ in range(num_sweeps):
            if relax_type in (6, 8):
                u = gs_sweep(gs_sweep(u, False), True)
            elif relax_type in (13, 3):
                u = gs_sweep(u, up)
            else:
                u = gs_sweep(u, not up)
        return u
    for _ in range(num_sweeps):
        r = f if u is None else f - matvec(A, u)
        z = w * dinv * r
        u = z if u is None else u + z
    return u


def coarse_solve(h: AmgHierarchy, f: torch.Tensor) -> torch.Tensor:
    """Coarsest level: dense LU solve (GE, ref: par_gauss_elim.c:457)."""
    return torch.linalg.lu_solve(h.c_lu, h.c_piv, f[:, None])[:, 0]


def amg_cycle(h: AmgHierarchy, f: torch.Tensor) -> torch.Tensor:
    """One V-cycle with zero initial guess (ref: par_cycle.c:23)."""
    return _cycle_at(h, 0, f)


def _cycle_at(h: AmgHierarchy, l: int, f: torch.Tensor) -> torch.Tensor:
    levels = h.levels
    if l == len(levels) - 1:
        return coarse_solve(h, f)
    lvl = levels[l]
    rt, w, ns = h.relax_type, h.relax_weight, h.num_sweeps
    u = _relax(lvl, rt, w, f, None, ns, up=False)
    r = f - matvec(lvl.A, u)
    uc = _cycle_at(h, l + 1, matvec(lvl.R, r))
    u = u + matvec(lvl.P, uc)
    return _relax(lvl, rt, w, f, u, ns, up=True)
