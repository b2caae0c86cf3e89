"""BoomerAMG: host or device setup + multigrid cycles on the card.

Port of hypre_tpu/solvers/amg.py (setup driver ref:
src/parcsr_ls/par_amg_setup.c:29; cycle ref: par_cycle.c:23; additive
cycles par_add_cycle.c:22; solve ref: par_amg_solve.c:22).  Two setups:

* ``setup`` runs on the host (numpy plus the OpenMP kernels, f64) and
  is the reference's own algorithm with every option of AmgConfig
  (coarsenings, interpolations, aggressive coarsening, AIR, GSMG,
  non-Galerkin, systems), so the hierarchy is the same bit for bit
  (AIR and GSMG: to the last bits of a LAPACK solve);
* ``setup_device`` runs the whole setup on the card in f64
  (setup/device_amg.py, the counterpart of the reference's
  ``setup_device``, amg.py:526-666) and packs each level there.

The solve phase runs eagerly on torch tensors: l1/weighted Jacobi
(relax 18/0/7), two-stage Gauss-Seidel (5/11/12), exact (l1-)GS
(3/4/6/8/13/14: dense triangular factors on small levels, the wavefront
solve of ops/trisolve.py above ``exact_gs_max`` rows), topologically
ordered GS (10), Chebyshev (16) and Cimmino Kaczmarz (30); V, W and F
cycles, the additive, mult-additive and simple cycles; a dense LU on
the coarsest level.

On the card, a V-cycle of a multiplicative hierarchy of three or more
levels whose smoother makes no host sync (``GRAPH_RELAX``) runs its
levels >= 1 as one CUDA graph: captured at the hierarchy's first such
cycle, replayed at every later one (``CoarseGraph``).  The graph
replays the very kernels the eager cycle launches, so the numbers are
the eager cycle's bit for bit; every other cycle, and every cycle on
the CPU, runs eagerly.  ``amg_cycle.captures``, ``.replays`` and
``.eager`` count them.

While the tracer (core/trace.py) is on, ``setup_device`` records
``amg.setup_device`` and its stage spans (``setup.*``), and each cycle
``amg.cycle`` (with its device time) and, in the multiplicative cycles,
one ``amg.level`` span per level and direction (``level``, ``phase``);
a graph's replay is one span, ``level`` 1, ``phase`` "graph".
"""
from __future__ import annotations

import dataclasses
import sys
import time
from collections import deque
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.core import trace
from hypre_tpu_torch.core.config import (
    as_real, get_config, get_device, synchronize,
)
from hypre_tpu_torch.ops.dia import dia_matvec
from hypre_tpu_torch.ops.formats import (
    SparseOp, dense_from_dell, matvec, sparse_op_from_dell,
    sparse_op_from_scipy,
)
from hypre_tpu_torch.ops.spmv import csr_spmv
from hypre_tpu_torch.ops.stencil import stencil_matvec, stencil_op
from hypre_tpu_torch.ops.trisolve import WavefrontTriSolve, build_trisolve
from hypre_tpu_torch.setup.coarsen import C_PT, hmis, pmis
from hypre_tpu_torch.setup.interp import direct_interp
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
    agg_interp_type: int = 4          # multipass (par_amg.c:194);
    #                                   5/7 = 2-stage mod-ext / mod-ext+e
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
    cheby_order: int = 2              # Chebyshev relax 16 (par_cheby.c)
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


EXACT_GS_RELAX = (3, 4, 6, 8, 13, 14)
DEVICE_RELAX = (18, 0, 7, 16, 11, 12)  # the device setup's smoothers
# smoothers whose work on a level is a fixed sequence of launches with no
# host sync (Chebyshev's coefficients are host scalars): a V-cycle's
# levels >= 1 with one of them run as a CUDA graph on the card
GRAPH_RELAX = (18, 7, 0, 16, 30, 5, 11, 12)
# the kernel wrappers whose ``launches`` a graph's replay adds to
_COUNTED = (stencil_matvec, csr_spmv, dia_matvec)


@dataclasses.dataclass(frozen=True)
class AmgLevel:
    A: SparseOp
    P: Optional[SparseOp]       # None on the coarsest level
    R: Optional[SparseOp]       # P^T, or AIR's restriction
    dinv: Optional[torch.Tensor]  # 1 / smoother diagonal (l1 norms)
    cheby_ds: Optional[torch.Tensor] = None   # 1/sqrt(|diag|), relax 16
    cheby_bounds: Optional[tuple] = None      # (lmax, lmin) of ds A ds
    L: Optional[SparseOp] = None   # strict lower part (two-stage GS)
    U: Optional[SparseOp] = None   # strict upper part (backward sweep)
    c_mask: Optional[torch.Tensor] = None  # 1.0 at C points (relax_order)
    gs_lo: Optional[torch.Tensor] = None  # dense D+L (exact GS, small)
    gs_up: Optional[torch.Tensor] = None  # dense D+U
    gs_wf_lo: Optional[WavefrontTriSolve] = None  # exact GS, large
    gs_wf_up: Optional[WavefrontTriSolve] = None
    add_dinv: Optional[torch.Tensor] = None  # additive-cycle weights
    AT: Optional[SparseOp] = None  # A^T (Kaczmarz relax 30)
    topo_perm: Optional[torch.Tensor] = None   # relax 10 topo order
    topo_iperm: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class AmgHierarchy:
    levels: tuple               # tuple[AmgLevel]
    c_lu: torch.Tensor          # dense LU of the coarsest A
    c_piv: torch.Tensor         # 1-based LAPACK pivots (torch convention)
    relax_weight: float
    num_sweeps: int
    relax_type: int = 18
    cheby_order: int = 2
    cycle_type: str = "V"
    relax_order: int = 0
    additive: int = -1          # first additive level (par_add_cycle.c)
    simple: int = -1
    add_last_lvl: int = -1


def build_host_hierarchy(A: sp.csr_matrix, cfg: AmgConfig):
    """The host setup as lists (amg.py:149): ([(A_l, P_l, R_l, cf_l)],
    A_coarsest), scipy matrices."""
    levels_host = list(iter_host_hierarchy(A, cfg))
    Al = levels_host.pop()  # the generator's last item is the coarsest A
    return levels_host, Al


def iter_host_hierarchy(A: sp.csr_matrix, cfg: AmgConfig):
    """Generator form of the level loop of hypre_BoomerAMGSetup
    (ref: src/parcsr_ls/par_amg_setup.c:990-3155; amg.py:162-338):
    strength → coarsen → interp → RAP until the coarse grid is small
    enough.  Yields (A_l, P_l, R_l, cf_l) per level, then the coarsest
    A last."""
    from hypre_tpu_torch.setup.utils import native_enabled

    Al = A.tocsr()
    if Al.data.dtype != np.float64:
        # setup runs in f64 (hypre semantics); converting once here
        # makes every native kernel's f64 view a no-copy pass-through
        Al = Al.astype(np.float64)
    nf = cfg.num_functions
    dof = None
    if nf > 1:
        from hypre_tpu_torch.setup.systems import default_dof_func

        dof = (np.asarray(cfg.dof_func, dtype=np.int32)
               if cfg.dof_func is not None
               else default_dof_func(Al.shape[0], nf))
    for _level in range(cfg.max_levels - 1):
        n = Al.shape[0]
        if n <= cfg.max_coarse_size:
            break
        if dof is not None:
            # unknown-based systems AMG: interpolation weights come from
            # the same-function submatrix; RAP uses the full operator
            rows_a = np.repeat(np.arange(n), np.diff(Al.indptr))
            same = dof[rows_a] == dof[Al.indices]
            indptr2 = np.concatenate(
                [[0], np.cumsum(np.bincount(rows_a[same], minlength=n))])
            Ai = sp.csr_matrix(
                (Al.data[same], Al.indices[same],
                 indptr2.astype(Al.indptr.dtype)), shape=Al.shape)
        else:
            Ai = Al
        Vg = None
        if cfg.gsmg:
            from hypre_tpu_torch.setup.gsmg import smooth_dirs, smooth_vectors

            Vg = smooth_vectors(Ai, cfg.num_samples, cfg.gsmg_sweeps)
            S, strong_mask = smooth_dirs(Ai, Vg, cfg.strong_threshold,
                                         dof_func=dof)
        else:
            S, strong_mask = strength_matrix(
                Ai, cfg.strong_threshold, cfg.max_row_sum,
                return_mask=True)
        if dof is not None and cfg.nodal > 0:
            # nodal coarsening: PMIS on the block-norm condensed matrix
            # (absolute-value strength, par_amg_setup.c:1123), node CF
            # broadcast to its unknowns
            from hypre_tpu_torch.setup.systems import (
                expand_node_cf, nodal_matrix,
            )

            AN = nodal_matrix(Al, nf, cfg.nodal, cfg.nodal_diag)
            SN = strength_matrix(AN, cfg.strong_threshold,
                                 cfg.max_row_sum, abs_soc=True)
            cf = expand_node_cf(pmis(SN, seed=cfg.seed), nf)
        elif cfg.coarsen_type == "hmis":
            cf = hmis(S, seed=cfg.seed)
        elif cfg.coarsen_type in ("cljp", "falgout", "ruge", "cgc"):
            from hypre_tpu_torch.setup import coarsen

            cf = getattr(coarsen, cfg.coarsen_type)(S, seed=cfg.seed)
        elif cfg.coarsen_type == "cr":
            from hypre_tpu_torch.setup.coarsen import cr

            cf = cr(Ai, S, seed=cfg.seed)
        else:
            cf = pmis(S, seed=cfg.seed)
        n_coarse = int((cf == C_PT).sum())
        if n_coarse == 0 or n_coarse == n:
            break
        if _level < cfg.agg_num_levels:
            if cfg.agg_interp_type in (5, 7):
                # 2-stage: P = P1 (mod-ext onto C1) @ P2 (partial
                # mod-ext C1 -> C2); ref par_amg_setup.c:1739
                from hypre_tpu_torch.setup.interp_2s import two_stage_interp

                P, cf = two_stage_interp(
                    Ai, S, cf, strong_mask,
                    agg_interp_type=cfg.agg_interp_type,
                    num_paths=cfg.num_paths, seed=cfg.seed,
                    p12_trunc=cfg.agg_p12_trunc_factor,
                    p12_max_elmts=cfg.agg_p12_max_elmts,
                    trunc_factor=cfg.agg_trunc_factor,
                    max_elmts=cfg.agg_p_max_elmts)
                n_coarse = int((cf == C_PT).sum())
                if n_coarse == 0 or n_coarse == n:
                    break
            else:
                from hypre_tpu_torch.setup.aggressive import (
                    aggressive_coarsen, multipass_interp,
                )

                cf = aggressive_coarsen(S, cf, cfg.num_paths, cfg.seed)
                n_coarse = int((cf == C_PT).sum())
                if n_coarse == 0 or n_coarse == n:
                    break
                P = multipass_interp(
                    Ai, S, cf, strong_mask=strong_mask,
                    trunc_factor=(cfg.agg_trunc_factor
                                  or cfg.trunc_factor),
                    max_elmts=(cfg.agg_p_max_elmts or cfg.p_max_elmts))
        elif cfg.gsmg:
            from hypre_tpu_torch.setup.gsmg import interp_ls

            P = interp_ls(Ai, Vg, cf, strong_mask,
                          max_elmts=max(cfg.p_max_elmts, 4),
                          trunc_factor=cfg.trunc_factor)
        elif cfg.interp_type == 3:
            P = direct_interp(Ai, S, cf, cfg.trunc_factor, cfg.p_max_elmts,
                              strong_mask=strong_mask)
        elif cfg.interp_type == 6:
            from hypre_tpu_torch.setup.interp_ext import extpi_interp

            P = extpi_interp(Ai, S, cf, cfg.trunc_factor, cfg.p_max_elmts,
                             strong_mask=strong_mask)
        elif cfg.interp_type in (0, 8, 9, 14):
            from hypre_tpu_torch.setup.interp_more import lr_interp

            P = lr_interp(Ai, S, cf, cfg.interp_type,
                          trunc_factor=cfg.trunc_factor,
                          max_elmts=cfg.p_max_elmts,
                          strong_mask=strong_mask)
        else:
            raise ValueError(f"interp_type {cfg.interp_type} not built")
        R = None  # P^T, materialized below
        if cfg.restr_type != 0:
            # AIR (hypre restri: 1 dist-1 lAIR, 2 dist-2 lAIR, >=3
            # Neumann of degree restr_type-3) with one-point P
            from hypre_tpu_torch.setup.air import (
                air_restriction, neumann_air_restriction,
                one_point_interp,
            )

            P = one_point_interp(Ai, S, cf, strong_mask=strong_mask)
            if cfg.restr_type >= 3:
                R = neumann_air_restriction(
                    Ai, S, cf, strong_mask=strong_mask,
                    degree=cfg.restr_type - 3)
            else:
                R = air_restriction(Ai, S, cf, strong_mask=strong_mask,
                                    dist=cfg.restr_type)
        if native_enabled():
            from hypre_tpu_torch.csrc import build as native

            if R is None:
                R = native.csr_transpose(P)
            AP = native.spgemm(Al.tocsr(), P)
            Ac = native.spgemm(R, AP)
        else:
            if R is None:
                R = P.T.tocsr()
            AP = (Al @ P).tocsr()
            Ac = (R @ AP).tocsr()
            Ac.sort_indices()
        tol_l = (cfg.nongalerk_tol[_level]
                 if _level < len(cfg.nongalerk_tol)
                 else cfg.nongalerk_tol_all)
        if tol_l > 0.0 and cfg.restr_type == 0:
            from hypre_tpu_torch.setup.nongalerkin import \
                nongalerkin_coarse_operator

            Ac = nongalerkin_coarse_operator(
                Ac, AP, cf, tol_l, cfg.strong_threshold, cfg.max_row_sum)
        yield (Al, P, R, cf)
        if dof is not None:
            # coarse dof_func: the function ids of the surviving C points
            dof = dof[cf == C_PT]
        Al = Ac
    yield Al


def l1_option_for_relax(relax_type: int) -> int:
    if relax_type == 18:
        return 1
    if relax_type in (13, 14, 8):
        return 4
    return 5  # plain diagonal (Jacobi types 0/7, exact GS 3/4/6)


def chebyshev_setup(A_scipy, fraction: float, eig_iters: int):
    """Host Chebyshev precompute (amg.py:755): ds = 1/sqrt(|diag|) and
    the spectral bounds of D^{-1/2} A D^{-1/2} (ref: par_cheby.c:65-170;
    eig estimate par_relax_more.c:137-170).  Power iteration from
    RandomState(7919) with a 1.05 safety factor; lmin = fraction *
    lmax."""
    diag = A_scipy.diagonal()
    ds = 1.0 / np.sqrt(np.abs(diag))
    rng = np.random.RandomState(7919)
    v = rng.rand(A_scipy.shape[0])
    lmax = 1.0
    for _ in range(eig_iters):
        w = ds * (A_scipy @ (ds * v))
        lmax = np.linalg.norm(w)
        v = w / max(lmax, 1e-300)
    lmax *= 1.05
    return ds, np.array([lmax, fraction * lmax])


def chebyshev_setup_device(A_op, Al, fraction: float, eig_iters: int,
                           dtype: torch.dtype):
    """Device twin of chebyshev_setup (amg.py:730): the power iteration
    on the packed operator A_op (K1, K2 or K3 on the card), started from
    JAX's uniform draw of PRNGKey(7919) as the reference is
    (core/threefry.py); ds = 1/sqrt(|diag|) with the correctly rounded
    square root of core/ieee.py, so that the card, the CPU and the host
    setup's numpy give the same ds.  Returns ds on the card and
    (lmax, lmin)."""
    from hypre_tpu_torch.core.ieee import sqrt_rn
    from hypre_tpu_torch.core.threefry import uniform
    from hypre_tpu_torch.setup.device_amg import device_diagonal

    ds = (1.0 / sqrt_rn(torch.abs(device_diagonal(Al)))).to(dtype)
    v = uniform(7919, Al.n_rows, dtype, ds.device)
    lmax = torch.ones((), dtype=dtype, device=ds.device)
    for _ in range(eig_iters):
        w = ds * matvec(A_op, ds * v)
        lmax = torch.linalg.vector_norm(w)
        v = w / torch.clamp_min(lmax, 1e-30)
    lmax = float(lmax) * 1.05
    return ds, (lmax, fraction * lmax)


def topo_order(Ah: sp.csr_matrix) -> np.ndarray:
    """Topological order of A's dependency digraph (edge j -> i when
    A[i, j] != 0): the order relax 10 sweeps in (ref: par_relax.c:1314;
    amg.py:774).  Cycles collapse to their strongly connected component;
    components are ordered topologically (Kahn) and rows within one
    keep natural order, so a triangularizable pattern yields an exact
    forward-solve order."""
    import scipy.sparse.csgraph as csg

    pat = Ah.tocsr().copy()
    pat.setdiag(0)
    pat.eliminate_zeros()
    ncomp, labels = csg.connected_components(
        pat, directed=True, connection="strong")
    coo = pat.tocoo()
    src = labels[coo.col]
    dst = labels[coo.row]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    topo = np.full(ncomp, -1, np.int64)
    adj = {}
    for s, d in zip(src, dst):
        adj.setdefault(int(s), set()).add(int(d))
    indeg = np.zeros(ncomp, np.int64)
    for s, d in {(int(a), int(b)) for a, b in zip(src, dst)}:
        indeg[d] += 1
    q = deque(int(c) for c in np.flatnonzero(indeg == 0))
    pos = 0
    while q:
        c = q.popleft()
        topo[c] = pos
        pos += 1
        for d in adj.get(c, ()):
            indeg[d] -= 1
            if indeg[d] == 0:
                q.append(d)
    topo[topo < 0] = np.arange(pos, ncomp)  # cycles at the end (safety)
    return np.argsort(topo[labels], kind="stable").astype(np.int64)


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
            P=None, R=None, dinv=None,
            add_dinv=self._additive_dinv(Al, dtype, device)))
        dense = torch.as_tensor(Al.toarray(), dtype=dtype, device=device)
        c_lu, c_piv = torch.linalg.lu_factor(dense)
        self.level_sizes.append(Al.shape[0])
        self.level_nnz.append(Al.nnz)
        trace("coarsest level factored on the device")

        self.hierarchy = self._hierarchy(levels, c_lu, c_piv)
        self.grid_complexity = sum(self.level_sizes) / self.level_sizes[0]
        self.operator_complexity = sum(self.level_nnz) / A.nnz
        return self

    def _hierarchy(self, levels, c_lu, c_piv) -> AmgHierarchy:
        cfg = self.config
        return AmgHierarchy(
            levels=tuple(levels), c_lu=c_lu, c_piv=c_piv,
            relax_weight=cfg.relax_weight, num_sweeps=cfg.num_sweeps,
            relax_type=cfg.relax_type, cheby_order=cfg.cheby_order,
            cycle_type=cfg.cycle_type, relax_order=cfg.relax_order,
            additive=cfg.additive, simple=cfg.simple,
            add_last_lvl=cfg.add_last_lvl)

    def _build_dev_level(self, Ah, Ph, Rh, cfm, a_op=None, *, dtype,
                         device) -> AmgLevel:
        """One level on the device (amg.py:440-522): A in the format the
        reference picks (P, R and the smoothers' operators never DIA),
        the smoother's inverse diagonal and whatever the relax type
        needs besides."""
        cfg = self.config
        rt = cfg.relax_type

        def op(M):
            return sparse_op_from_scipy(M, dtype, device, prefer_dia=False)

        def vec(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        dl1 = l1_norms(Ah, l1_option_for_relax(rt))
        dinv = 1.0 / dl1
        extra = {}
        if rt == 16:
            ds, bounds = chebyshev_setup(Ah, cfg.cheby_fraction,
                                         cfg.cheby_eig_iters)
            extra.update(cheby_ds=vec(ds),
                         cheby_bounds=(float(bounds[0]), float(bounds[1])))
        elif rt in EXACT_GS_RELAX:
            # exact (l1-)GS (ref: par_relax.c:24, types 3/4/6/8/13/14):
            # dense triangular factors on small levels, the wavefront
            # solve above exact_gs_max rows (amg.py:453-475)
            if Ah.shape[0] <= cfg.exact_gs_max:
                lo = sp.tril(Ah, -1).toarray()
                up = sp.triu(Ah, 1).toarray()
                np.fill_diagonal(lo, dl1)
                np.fill_diagonal(up, dl1)
                extra.update(gs_lo=vec(lo), gs_up=vec(up))
            else:
                extra.update(
                    gs_wf_lo=build_trisolve(Ah, dl1, backward=False,
                                            dtype=dtype, device=device),
                    gs_wf_up=build_trisolve(Ah, dl1, backward=True,
                                            dtype=dtype, device=device))
        elif rt in (5, 11, 12):
            extra.update(L=op(sp.tril(Ah, k=-1).tocsr()),
                         U=op(sp.triu(Ah, k=1).tocsr()))
        elif rt == 10:
            # topo-ordered GS (ref: par_relax.c:1314): an exact forward
            # GS sweep on the topologically permuted operator
            p = topo_order(Ah)
            Ap = Ah[p][:, p].tocsr()
            dg = Ap.diagonal()
            dg = np.where(dg != 0, dg, 1.0)
            ip = np.empty_like(p)
            ip[p] = np.arange(len(p))
            extra.update(
                gs_wf_lo=build_trisolve(Ap, dg, backward=False,
                                        dtype=dtype, device=device),
                topo_perm=torch.as_tensor(p, device=device),
                topo_iperm=torch.as_tensor(ip, device=device))
        elif rt == 30:
            rowsq = np.asarray(Ah.multiply(Ah).sum(axis=1)).ravel()
            # Cimmino damping: lam_max(A^T D^-1 A) <= max column count,
            # so 1/m keeps the simultaneous sweep contractive
            m = int(np.diff(Ah.tocsc().indptr).max(initial=1))
            dinv = 1.0 / np.where(rowsq != 0, rowsq * m, 1.0)
            extra.update(AT=op(Ah.T.tocsr()))
        if cfg.relax_order:
            extra.update(c_mask=vec((cfm == C_PT).astype(np.float64)))
        return AmgLevel(
            A=(a_op if a_op is not None
               else sparse_op_from_scipy(Ah, dtype, device,
                                         prefer_dia=cfg.prefer_dia)),
            P=op(Ph), R=op(Rh), dinv=vec(dinv),
            add_dinv=self._additive_dinv(Ah, dtype, device), **extra)

    def _additive_dinv(self, Ah, dtype, device):
        """Additive-cycle correction weights (ref: par_add_cycle.c:
        218-247): l1-Jacobi weights for the additive/mult-additive
        variants, plain 1/diag for ``simple``."""
        cfg = self.config
        if cfg.additive < 0 and cfg.simple < 0:
            return None
        if cfg.simple >= 0:
            d = Ah.diagonal()
            w = 1.0 / np.where(d != 0, d, 1.0)
        else:
            w = 1.0 / l1_norms(Ah, 1)
        return torch.as_tensor(w, dtype=dtype, device=device)

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
        does.  Relax 18/0/7 (Jacobi), 16 (Chebyshev) and 11/12
        (two-stage GS), as the reference's (amg.py:553-556); the
        exact-GS types need host factors and raise ValueError.

        After it, ``setup_stats`` holds one dict per level: the wall
        seconds of strength, PMIS (and its rounds), interpolation, RAP
        and packing, with the widths.  While the tracer is on, the same
        clock readings are the ``setup.*`` spans, and the coarsest
        level's dense LU is ``setup.coarse_lu``."""
        from hypre_tpu_torch.setup import device_amg as dev

        cfg = self.config
        if cfg.relax_type not in DEVICE_RELAX:
            raise ValueError(
                f"relax_type {cfg.relax_type} needs host factorization;"
                " use setup()")
        device = get_device()
        dtype = get_config().real_dtype
        whole = trace.begin("amg.setup_device") if trace.on else None
        t0 = time.perf_counter()

        def note(msg):
            if cfg.print_level >= 1:
                print(f"  [amg setup_device +{time.perf_counter() - t0:7.3f}s]"
                      f" {msg}", file=sys.stderr, flush=True)

        fine_op = None
        if stencil is not None:
            shape, entries = stencil
            A = dev.dell_stencil(shape, entries, torch.float64, device)
            fine_op = stencil_op(shape, entries, dtype=dtype)
            note("fine operator generated on the device")
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
                                              note):
            if not isinstance(item, tuple):
                Al = item
                break
            t1, k1 = dev.stage_mark()
            Ah = item[0]
            self.level_sizes.append(Ah.n_rows)
            self.level_nnz.append(int(Ah.mask.sum()))
            a_op = fine_op if not levels else None
            levels.append(self._build_dev_level_dell(*item, a_op=a_op,
                                                     dtype=dtype))
            synchronize(device)
            t2, k2 = dev.stage_mark()
            self.setup_stats[len(levels) - 1]["pack_s"] = (t2 - t1) / 1e9
            if trace.on:
                trace.add("setup.pack", t1, t2, level=len(levels) - 1,
                          btake=k2 - k1)
            note(f"level {len(levels) - 1} packed (n={Ah.n_rows}, "
                 f"nnz={self.level_nnz[-1]}, "
                 f"fmt={type(levels[-1].A).__name__})")
        # coarsest level: dense LU on the device
        lu = trace.begin("setup.coarse_lu", level=len(levels)) \
            if trace.on else None
        self.level_sizes.append(Al.n_rows)
        self.level_nnz.append(int(Al.mask.sum()))
        dense = dense_from_dell(Al, dtype)
        levels.append(AmgLevel(A=dense, P=None, R=None, dinv=None,
                               add_dinv=self._additive_dinv_dell(Al, dtype)))
        c_lu, c_piv = torch.linalg.lu_factor(dense.vals)
        synchronize(device)
        if lu is not None:
            trace.end(lu)
        note(f"coarsest dense LU (n={Al.n_rows})")

        self.hierarchy = self._hierarchy(levels, c_lu, c_piv)
        self.grid_complexity = sum(self.level_sizes) / self.level_sizes[0]
        self.operator_complexity = sum(self.level_nnz) / self.level_nnz[0]
        if whole is not None:
            trace.end(whole)
        return self

    def _build_dev_level_dell(self, Al, P, PT, cf, a_op=None, *,
                              dtype) -> AmgLevel:
        """Pack one device-built level (amg.py:623-654): A (unless the
        stencil operator stands in for it), P, R = P^T, the smoother's
        inverse l1 diagonal and, for relax 16, the Chebyshev scaling and
        bounds; for 11/12, the strict triangles L and U masked out of
        A's slots; all on the card."""
        from hypre_tpu_torch.setup import device_amg as dev

        cfg = self.config
        A_op = a_op if a_op is not None else sparse_op_from_dell(Al, dtype)
        l1 = dev.device_l1_norms(Al, l1_option_for_relax(cfg.relax_type))
        extra = {}
        if cfg.relax_type == 16:
            ds, bounds = chebyshev_setup_device(
                A_op, Al, cfg.cheby_fraction, cfg.cheby_eig_iters, dtype)
            extra.update(cheby_ds=ds, cheby_bounds=bounds)
        elif cfg.relax_type in (11, 12):
            row = torch.arange(Al.n_rows, dtype=Al.cols.dtype,
                               device=Al.device)[None, :]
            for name, part in (("L", Al.mask & (Al.cols < row)),
                               ("U", Al.mask & (Al.cols > row))):
                extra[name] = sparse_op_from_dell(dev.DEll(
                    cols=torch.where(part, Al.cols, -1),
                    vals=torch.where(part, Al.vals, 0.0),
                    n_cols=Al.n_cols), dtype)
        if cfg.relax_order:
            extra.update(c_mask=(cf == C_PT).to(dtype))
        return AmgLevel(
            A=A_op, P=sparse_op_from_dell(P, dtype),
            R=sparse_op_from_dell(PT, dtype), dinv=(1.0 / l1).to(dtype),
            add_dinv=self._additive_dinv_dell(Al, dtype), **extra)

    def _additive_dinv_dell(self, Al, dtype):
        from hypre_tpu_torch.setup import device_amg as dev

        cfg = self.config
        if cfg.additive < 0 and cfg.simple < 0:
            return None
        if cfg.simple >= 0:
            d = dev.device_diagonal(Al)
            return (1.0 / torch.where(d != 0, d, 1.0)).to(dtype)
        return (1.0 / dev.device_l1_norms(Al, 1)).to(dtype)

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
           cheby_order: int = 2, relax_order: int = 0,
           up: bool = False) -> torch.Tensor:
    """Smoother dispatch (ref: par_relax.c:24 hypre_BoomerAMGRelax;
    amg.py:796-916).

    18 / 7 / 0: (l1-)Jacobi, u += w * dinv * (f - A u); the first sweep
    from u = 0 folds to u = w * dinv * f.
    16: Chebyshev polynomial on the scaled operator.
    30: Kaczmarz in its simultaneous (Cimmino) form,
    u += w * A^T D^{-1} (f - A u) with D_ii = m * ||a_i||^2.
    10: exact forward GS on the topologically permuted operator.
    3 / 4 / 6 / 8 / 13 / 14: exact (l1-)GS, u += (D + T)^{-1} (f - A u)
    with T the strict lower (forward) or upper (backward) part: 13 and 3
    forward going down and backward going up, 14 and 4 the reverse, 6
    and 8 symmetric (a forward then a backward sweep); the weight is not
    applied.
    5 / 11 / 12: one two-stage GS formula, (D+T)^{-1} ~ D^{-1} -
    D^{-1} T D^{-1}, forward going down and backward going up.
    relax_order=1: C points first going down, F points first going up
    (ref: par_relax.c relax_points)."""
    if relax_type == 16:
        return _cheby_relax(lvl, f, u, cheby_order, num_sweeps)
    A, dinv = lvl.A, lvl.dinv
    if relax_type == 30:
        AT = lvl.AT if lvl.AT is not None else A
        for _ in range(num_sweeps):
            r = f if u is None else f - matvec(A, u)
            z = w * matvec(AT, dinv * r)
            u = z if u is None else u + z
        return u
    if relax_type == 10 and lvl.gs_wf_lo is not None:
        for _ in range(num_sweeps):
            r = f if u is None else f - matvec(A, u)
            z = lvl.gs_wf_lo.solve(r[lvl.topo_perm])[lvl.topo_iperm]
            u = w * z if u is None else u + w * z
        return u
    if relax_type in EXACT_GS_RELAX \
            and (lvl.gs_lo is not None or lvl.gs_wf_lo is not None):
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
    two_stage = relax_type in (5, 11, 12, 13, 14, 8) and lvl.L is not None
    tri = None
    if two_stage:
        back = up if relax_type != 14 else not up
        tri = lvl.U if back else lvl.L

    def jac_update(u):
        r = f if u is None else f - matvec(A, u)
        z = w * dinv * r
        if two_stage:
            z = z - dinv * matvec(tri, z)
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


def _cheby_relax(lvl: AmgLevel, f, u, order: int, num_sweeps: int):
    """Chebyshev smoothing (relax 16) on B = D^{-1/2} A D^{-1/2} over
    [lmin, lmax] (ref: par_cheby.c hypre_ParCSRRelax_Cheby_Solve;
    amg.py:919).  The coefficients are host scalars."""
    A, ds = lvl.A, lvl.cheby_ds
    lmax, lmin = lvl.cheby_bounds
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def op(z):
        return ds * matvec(A, ds * z)

    for _ in range(num_sweeps):
        u_s = None if u is None else u / ds
        f_s = ds * f
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
        u = ds * u_s
    return u


def coarse_solve(h: AmgHierarchy, f: torch.Tensor) -> torch.Tensor:
    """Coarsest level: dense LU solve (GE, ref: par_gauss_elim.c:457)."""
    return torch.linalg.lu_solve(h.c_lu, h.c_piv, f[:, None])[:, 0]


def amg_cycle(h: AmgHierarchy, f: torch.Tensor) -> torch.Tensor:
    """One multigrid cycle with zero initial guess (ref: par_cycle.c:23,
    194-226): V by default, W (mu=2) and F recursively, or the additive
    family when ``additive`` or ``simple`` is set.  A 1-D CUDA `f` and a
    ``graphable`` hierarchy run levels >= 1 as the hierarchy's CUDA
    graph (``CoarseGraph``).  The result is always a fresh tensor."""
    tok = trace.begin("amg.cycle", device=f) if trace.on else None
    if f.is_cuda and f.dim() == 1 and graphable(h) \
            and not torch.cuda.is_current_stream_capturing():
        u = _cycle_at(h, 0, f, "V", coarse=_graphed)
    else:
        amg_cycle.eager += 1
        if h.additive >= 0 or h.simple >= 0:
            u = _additive_cycle(h, f)
        else:
            u = _cycle_at(h, 0, f, h.cycle_type)
    if tok is not None:
        trace.end(tok)
    return u


amg_cycle.captures = 0   # CUDA graphs captured (one a hierarchy)
amg_cycle.replays = 0    # cycles whose levels >= 1 replayed a graph
amg_cycle.eager = 0      # cycles run without a graph


def graphable(h: AmgHierarchy) -> bool:
    """Whether the levels >= 1 of `h`'s cycle are one fixed sequence of
    launches with no host sync, which a CUDA graph can replay: a
    multiplicative V-cycle of three or more levels smoothed by one of
    ``GRAPH_RELAX``."""
    return (h.additive < 0 and h.simple < 0 and h.cycle_type == "V"
            and len(h.levels) >= 3 and h.relax_type in GRAPH_RELAX)


class CoarseGraph:
    """A V-cycle's levels >= 1 (level 1's pre-smooth down to the coarse
    solve and back up to level 1's post-smooth) as one CUDA graph on
    static buffers: `f_in` is level 1's right-hand side, `u_out` its
    correction, `launches` the (kernel wrapper, launches) one replay
    runs."""

    def __init__(self, graph, f_in: torch.Tensor, u_out: torch.Tensor,
                 launches: tuple):
        self.graph, self.f_in, self.u_out = graph, f_in, u_out
        self.launches = launches

    def __call__(self, fc: torch.Tensor) -> torch.Tensor:
        """Level 1's correction for `fc`, in `u_out` until the next
        replay."""
        tok = trace.begin("amg.level", level=1, phase="graph") \
            if trace.on else None
        self.f_in.copy_(fc)
        self.graph.replay()
        if tok is not None:
            trace.end(tok)
        for fn, n in self.launches:
            fn.launches += n
        amg_cycle.replays += 1
        return self.u_out


def _graphed(h: AmgHierarchy, fc: torch.Tensor) -> torch.Tensor:
    """Levels >= 1 of `h`'s V-cycle for level 1's right-hand side `fc`:
    the hierarchy's graph, captured at the first call.  The graphs live
    in the hierarchy's ``_cycle_graphs`` (not a field: checkpoints and
    ``dataclasses.replace`` leave them out), keyed by dtype, device and
    level 1's size; a capture that failed leaves its error message there
    and the cycles run eagerly."""
    graphs = h.__dict__.get("_cycle_graphs")
    if graphs is None:
        graphs = {}
        object.__setattr__(h, "_cycle_graphs", graphs)
    key = (fc.dtype, fc.device, fc.shape[0])
    if key not in graphs:
        graphs[key] = _capture(h, fc)
    g = graphs[key]
    if isinstance(g, str):
        amg_cycle.eager += 1
        return _cycle_at(h, 1, fc, "V")
    return g(fc)


def _capture(h: AmgHierarchy, fc: torch.Tensor):
    """``_cycle_at(h, 1, ., "V")`` captured as a CoarseGraph with its own
    memory pool, after one eager run on the capturing stream (cuBLAS's
    handles and workspaces); or the error message of a capture that
    raised.  Neither run is counted in the kernels' ``launches`` nor
    traced."""
    dev = fc.device
    counts = [fn.launches for fn in _COUNTED]
    traced, trace.on = trace.on, False
    f_in = fc.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    try:
        with torch.cuda.stream(side):
            _cycle_at(h, 1, f_in, "V")
        warm = [fn.launches for fn in _COUNTED]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                u_out = _cycle_at(h, 1, f_in, "V")
        except RuntimeError as e:   # an op that syncs or cannot be captured
            return f"{type(e).__name__}: {e}"
        launches = tuple((fn, fn.launches - w)
                         for fn, w in zip(_COUNTED, warm))
    finally:
        trace.on = traced
        for fn, c in zip(_COUNTED, counts):
            fn.launches = c
    amg_cycle.captures += 1
    return CoarseGraph(graph, f_in, u_out, launches)


def _smooth(h: AmgHierarchy, lvl: AmgLevel, f, u, up: bool):
    return _relax(lvl, h.relax_type, h.relax_weight, f, u, h.num_sweeps,
                  h.cheby_order, h.relax_order, up=up)


def _additive_cycle(h: AmgHierarchy, f: torch.Tensor) -> torch.Tensor:
    """BPX-style (mult-)additive cycle (ref: par_add_cycle.c:22;
    amg.py:959): levels in [addlvl, add_end] restrict the raw residual
    down with no smoothing update, receive one diagonal-scaled
    correction (l1-Jacobi weights; 1/diag for ``simple``), and the
    corrections are summed through prolongation on the way up.  Levels
    outside the range behave multiplicatively.  The coarsest level in
    the additive range is smoothed, not solved directly."""
    levels = h.levels
    nl = len(levels)
    addlvl = max(h.additive if h.additive >= 0 else h.simple, 0)
    add_end = h.add_last_lvl if h.add_last_lvl >= 0 else nl - 1
    w = h.relax_weight

    us, fs = [], [f]
    for l in range(nl - 1):
        lvl = levels[l]
        if l < addlvl or l > add_end:
            u = _smooth(h, lvl, fs[l], None, up=False)
            r = fs[l] - matvec(lvl.A, u)
        else:
            u = None
            r = fs[l]
        us.append(u)
        fs.append(matvec(lvl.R, r))

    if addlvl <= nl - 1 <= add_end:
        uc = w * levels[-1].add_dinv * fs[-1]
    else:
        uc = coarse_solve(h, fs[-1])

    for l in range(nl - 2, -1, -1):
        lvl = levels[l]
        if l < addlvl or l > add_end:
            u = us[l] + matvec(lvl.P, uc)
            u = _smooth(h, lvl, fs[l], u, up=True)
        else:
            dinv_a = lvl.add_dinv if lvl.add_dinv is not None else lvl.dinv
            u = w * dinv_a * fs[l] + matvec(lvl.P, uc)
        uc = u
    return uc


def _cycle_at(h: AmgHierarchy, l: int, f: torch.Tensor,
              ctype: str = "V", coarse=None) -> torch.Tensor:
    """The cycle from level `l` down; `coarse(h, fc)`, where given, stands
    in for the V-cycle below level `l`."""
    levels = h.levels
    nl = len(levels)
    if l == nl - 1:
        tok = trace.begin("amg.level", level=l, phase="coarse") \
            if trace.on else None
        u = coarse_solve(h, f)
        if tok is not None:
            trace.end(tok)
        return u
    tok = trace.begin("amg.level", level=l, phase="down") \
        if trace.on else None
    lvl = levels[l]
    u = _smooth(h, lvl, f, None, up=False)
    r = f - matvec(lvl.A, u)
    fc = matvec(lvl.R, r)
    if tok is not None:
        trace.end(tok)
    if ctype in ("W", "F") and l < nl - 2:
        # W: two coarse cycles of the same kind; F: an F then a V
        uc = _cycle_at(h, l + 1, fc, ctype)
        rc = fc - matvec(levels[l + 1].A, uc)
        uc = uc + _cycle_at(h, l + 1, rc, "W" if ctype == "W" else "V")
    elif coarse is not None:
        uc = coarse(h, fc)
    else:
        uc = _cycle_at(h, l + 1, fc, "W" if ctype == "W" else "V")
    tok = trace.begin("amg.level", level=l, phase="up") \
        if trace.on else None
    u = u + matvec(lvl.P, uc)
    u = _smooth(h, lvl, f, u, up=True)
    if tok is not None:
        trace.end(tok)
    return u
