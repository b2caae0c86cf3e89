"""ij driver — the port's counterpart of hypre_tpu/drivers/ij.py.

hypre's IJ test driver (ref: src/test/ij.c) on the PyTorch port: the
reference's flag parser unchanged, so every line of
tests/golden/solvers.jobs parses, the problem built by the port's
generators, and the same output tail (ref: src/test/ij.c:4427-4430):

    Iterations = %d
    Final Relative Residual Norm = %e

Every solver id and flag of the reference's driver runs (its dispatch,
hypre_tpu/drivers/ij.py:329-485): AMG, PCG, GMRES, CGNR, BiCGSTAB,
COGMRES, LGMRES and FlexGMRES with AMG or diagonal scaling, the
ParaSails, FSAI, Schwarz and ILU preconditioners, the hybrid solver,
``-lobpcg`` (eigenpairs, preconditioned per -solver), ``-fromfile``,
``-rhsfromfile`` and ``-printsystem``; an unknown solver id raises
ValueError.  The driver's defaults are hypre's: HMIS, ext+i (6), relax
13 (exact hybrid l1-GS), P_max 4.

It runs on the configured device (the card by default); ``-exec_host``
runs that one call on the CPU in f64 and restores the caller's Config
afterwards.  ``run(args)`` returns the run's objects; ``main(argv)``
prints.

    python -m hypre_tpu_torch.drivers.ij -n 100 100 100 -solver 1
    python -m hypre_tpu_torch.drivers.ij -n 33 33 1 -solver 3 -exec_host
    python -m hypre_tpu_torch.drivers.ij -n 16 16 16 -lobpcg -exec_host
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(prog="ij", add_help=True)
    p.add_argument("-n", nargs=3, type=int, default=[10, 10, 10],
                   metavar=("nx", "ny", "nz"))
    p.add_argument("-P", nargs=3, type=int, default=[1, 1, 1],
                   help="process grid (informational; sharding is mesh-wide)")
    p.add_argument("-c", nargs=3, type=float, default=[1.0, 1.0, 1.0],
                   metavar=("cx", "cy", "cz"))
    p.add_argument("-a", nargs=3, type=float, default=[0.0, 0.0, 0.0],
                   metavar=("ax", "ay", "az"), dest="conv")
    p.add_argument("-laplacian", action="store_true", default=True)
    p.add_argument("-9pt", dest="ninept", action="store_true")
    p.add_argument("-27pt", dest="twentysevenpt", action="store_true")
    p.add_argument("-difconv", action="store_true")
    p.add_argument("-atype", type=int, default=0)
    p.add_argument("-solver", type=int, default=1)
    # defaults mirror hypre's BoomerAMG (ref: par_amg.c:178-270):
    # HMIS coarsening (10), ext+i interp (6), hybrid GS 13 down / 14 up
    p.add_argument("-rlx", type=int, default=13)
    p.add_argument("-w", type=float, default=1.0, dest="relax_weight")
    p.add_argument("-ns", type=int, default=1, dest="num_sweeps")
    p.add_argument("-interptype", type=int, default=6)
    p.add_argument("-pmis", action="store_true")
    p.add_argument("-hmis", action="store_true")
    p.add_argument("-cljp", action="store_true")
    p.add_argument("-falgout", action="store_true")
    p.add_argument("-cr", action="store_true")
    p.add_argument("-cgc", action="store_true")
    p.add_argument("-CF", type=int, default=0, dest="relax_order")
    p.add_argument("-aug", type=int, default=2, dest="aug_dim")
    p.add_argument("-th", type=float, default=0.25, dest="theta")
    p.add_argument("-mxrs", type=float, default=0.9, dest="max_row_sum")
    p.add_argument("-Pmx", type=int, default=4, dest="p_max_elmts")
    p.add_argument("-tr", type=float, default=0.0, dest="trunc_factor")
    p.add_argument("-mxl", type=int, default=25, dest="max_levels")
    p.add_argument("-mxc", type=int, default=9, dest="max_coarse_size")
    p.add_argument("-tol", type=float, default=1e-8)
    p.add_argument("-max_iter", type=int, default=1000)
    p.add_argument("-mg_max_iter", type=int, default=100)
    p.add_argument("-k", type=int, default=5, dest="k_dim")
    p.add_argument("-additive", type=int, default=-1,
                   help="first additive-cycle level (par_add_cycle.c)")
    p.add_argument("-mult_add", type=int, default=-1, dest="mult_add",
                   help="mult-additive variant (same composite here)")
    p.add_argument("-simple", type=int, default=-1,
                   help="simple additive variant (1/diag weights)")
    p.add_argument("-add_end", type=int, default=-1, dest="add_last_lvl")
    p.add_argument("-nongalerk_tol", nargs="+", type=float, default=None,
                   help="<ntol> <tol list>: non-Galerkin drop tolerances")
    p.add_argument("-agg_nl", type=int, default=0, dest="agg_num_levels")
    p.add_argument("-agg_interp", type=int, default=4,
                   dest="agg_interp_type")
    p.add_argument("-np2", "-num_paths", type=int, default=1,
                   dest="num_paths")
    p.add_argument("-seed", type=int, default=2747)
    p.add_argument("-rhsone", action="store_true", default=True)
    p.add_argument("-rhsrand", action="store_true")
    p.add_argument("-x0rand", action="store_true")
    p.add_argument("-fromfile", type=str, default=None,
                   help="read the matrix from an IJ file")
    p.add_argument("-rhsfromfile", type=str, default=None)
    p.add_argument("-ilu_type", type=int, default=0,
                   help="ILU variant (hypre enum: 0/1 BJ-ILU(k)/ILUT, "
                        "10/11 GMRES-, 20/21 NSH-, 30/31 RAS-, 50 iter)")
    p.add_argument("-ilu_lfil", type=int, default=0,
                   help="level of fill k for ILU(k)")
    p.add_argument("-ilu_droptol", type=float, default=1e-2)
    p.add_argument("-ilu_max_row_nnz", type=int, default=1000)
    p.add_argument("-agg_Pmx", type=int, default=0,
                   dest="agg_p_max_elmts")
    p.add_argument("-agg_tr", type=float, default=0.0,
                   dest="agg_trunc_factor")
    p.add_argument("-agg_P12_mx", type=int, default=0,
                   dest="agg_p12_max_elmts")
    p.add_argument("-agg_P12_tr", type=float, default=0.0,
                   dest="agg_p12_trunc_factor")
    p.add_argument("-nf", type=int, default=1, dest="num_functions")
    p.add_argument("-nodal", type=int, default=0)
    p.add_argument("-nodal_diag", type=int, default=0)
    p.add_argument("-sysL", type=int, default=0,
                   help="n-function Laplacian system (ij.c -sysL)")
    p.add_argument("-cheby_order", type=int, default=2)
    p.add_argument("-cheby_fraction", type=float, default=0.3)
    p.add_argument("-cheby_eig_est", type=int, default=20,
                   dest="cheby_eig_iters",
                   help="CG eigenvalue-estimate iterations (0 -> 20)")
    p.add_argument("-restriction", type=int, default=0,
                   dest="restr_type",
                   help="0 P^T; 1/2 distance-1/2 lAIR; 3+k Neumann(k)")
    p.add_argument("-gsmg", type=int, default=0)
    p.add_argument("-numsamp", type=int, default=5,
                   dest="num_samples")
    p.add_argument("-rotate", action="store_true",
                   help="2D rotated anisotropic 7pt (par_rotate_7pt.c)")
    p.add_argument("-alpha", type=float, default=45.0)
    p.add_argument("-eps", type=float, default=0.001)
    p.add_argument("-vardifconv", action="store_true",
                   help="variable-coefficient diffusion (par_vardifconv.c)")
    p.add_argument("-mu", type=int, default=1,
                   help="cycle multiplier: 1 V, 2 W")
    p.add_argument("-fcycle", action="store_true")
    p.add_argument("-exec_host", action="store_true",
                   help="run the solve on CPU (f64)")
    p.add_argument("-print_level", type=int, default=1)
    # --- ParaSails (ij.c -sai_th/-sai_filter; solver 8/18) ----------
    p.add_argument("-sai_th", type=float, default=0.1,
                   help="ParaSails prune threshold")
    p.add_argument("-sai_filter", type=float, default=0.05,
                   help="ParaSails post-filter")
    p.add_argument("-sai_lev", type=int, default=1,
                   help="ParaSails pattern levels (nlevels)")
    p.add_argument("-sai_sym", type=int, default=None,
                   help="override symmetric mode (default: by solver)")
    # --- FSAI (ij.c -fs_* / HYPRE_FSAISet*; solver 43) --------------
    p.add_argument("-fs_max_steps", type=int, default=3)
    p.add_argument("-fs_max_step_size", type=int, default=5)
    p.add_argument("-fs_kap_tol", type=float, default=1e-3)
    p.add_argument("-fs_algo", type=int, default=1,
                   help="1 adaptive (hypre default), 2 static")
    # --- Schwarz (ij.c -var/-ov/-dom; solver 12) --------------------
    p.add_argument("-var", type=int, default=2, dest="sw_variant",
                   help="Schwarz variant: 0 multiplicative, "
                        "2 additive, 3 sym-multiplicative")
    p.add_argument("-ov", type=int, default=4, dest="sw_overlap")
    p.add_argument("-dom", type=int, default=32, dest="sw_domain",
                   help="Schwarz subdomain (block) size")
    p.add_argument("-sw_w", type=float, default=1.0,
                   dest="sw_weight")
    # --- hybrid (ij.c -cf/-sol_t; solver 20) ------------------------
    p.add_argument("-cf", type=float, default=0.9, dest="cf_tol",
                   help="hybrid convergence-factor switch tol")
    p.add_argument("-dscg_max_iter", type=int, default=1000)
    p.add_argument("-pcg_max_iter", type=int, default=200)
    # --- LOBPCG mode (ij.c -lobpcg/-vrand/-itr) ---------------------
    p.add_argument("-lobpcg", action="store_true",
                   help="solve the eigenproblem instead (ij.c lobpcg "
                        "mode); preconditioner from -solver")
    p.add_argument("-vrand", type=int, default=4, dest="block_size",
                   help="LOBPCG block size (random initial block)")
    p.add_argument("-itr", type=int, default=100, dest="lobpcg_itr")
    p.add_argument("-lobpcg_tol", type=float, default=1e-6)
    # --- accepted-for-compatibility (documented no-ops) -------------
    p.add_argument("-rap", type=int, default=0,
                   help="RAP algorithm selector in hypre; Galerkin "
                        "RAP is always the fused XLA/native path here")
    p.add_argument("-mm_vendor", type=int, default=0,
                   help="SpGEMM vendor toggle in hypre; one device "
                        "SpGEMM path here")
    p.add_argument("-dbg", type=int, default=0)
    # --- misc parity -------------------------------------------------
    p.add_argument("-srand", type=int, default=None,
                   help="alias of -seed")
    p.add_argument("-xisone", action="store_true",
                   help="initial guess = 1")
    p.add_argument("-rhszero", action="store_true")
    p.add_argument("-printsystem", action="store_true",
                   help="write A/b in IJ format (IJ print analog)")
    return p


SOLVER_NAMES = {0: "AMG", 1: "AMG-PCG", 2: "DS-PCG", 3: "AMG-GMRES",
                4: "DS-GMRES", 5: "AMG-CGNR", 6: "DS-CGNR",
                8: "ParaSails-PCG", 9: "AMG-BiCGSTAB", 10: "DS-BiCGSTAB",
                16: "AMG-COGMRES", 17: "DS-COGMRES", 20: "AMG-Hybrid",
                50: "DS-LGMRES", 51: "AMG-LGMRES",
                60: "DS-FlexGMRES", 61: "AMG-FlexGMRES",
                18: "ParaSails-GMRES",
                43: "FSAI-PCG", 80: "ILU-GMRES", 81: "ILU-PCG"}
# every solver id the reference's dispatch runs (12, Schwarz-PCG, has
# no name in its table, :335-345)
SOLVER_IDS = (*SOLVER_NAMES, 12)
# the solvers that set up BoomerAMG (the reference's need_amg, :330)
NEED_AMG = (0, 1, 3, 5, 9, 16, 51, 61, 20)


def build_problem(args):
    from hypre_tpu_torch.gen import difconv, laplacian, laplacian_9pt, \
        laplacian_27pt

    nx, ny, nz = args.n
    cx, cy, cz = args.c
    if args.sysL:
        import scipy.sparse as sp

        L = laplacian(nx, ny, nz, cx, cy, cz).tocsr()
        nf = args.sysL
        N = L.shape[0]
        A = sp.block_diag([L] * nf, format="csr")
        perm = np.arange(nf * N).reshape(nf, N).T.ravel()
        A = A[perm][:, perm].tocsr()
        args.num_functions = nf
        name = f"{nf}-function Laplacian system {nx}x{ny}x{nz}"
    elif args.rotate:
        from hypre_tpu_torch.gen import rotate_7pt

        A = rotate_7pt(nx, ny, args.alpha, args.eps)
        name = f"rotated 7pt {nx}x{ny} (alpha={args.alpha}, eps={args.eps})"
    elif args.vardifconv:
        from hypre_tpu_torch.gen import vardifconv

        A = vardifconv(nx, ny, nz, contrast=1.0 / max(args.eps, 1e-12))
        name = f"vardifconv {nx}x{ny}x{nz} (eps={args.eps})"
    elif args.twentysevenpt:
        A = laplacian_27pt(nx, ny, nz)
        name = f"27pt Laplacian {nx}x{ny}x{nz}"
    elif args.ninept:
        A = laplacian_9pt(nx, ny)
        name = f"9pt Laplacian {nx}x{ny}"
    elif args.difconv or any(a != 0 for a in args.conv):
        ax, ay, az = args.conv
        A = difconv(nx, ny, nz, cx, cy, cz, ax, ay, az, args.atype)
        name = f"convection-diffusion {nx}x{ny}x{nz}"
    else:
        A = laplacian(nx, ny, nz, cx, cy, cz)
        name = f"Laplacian {nx}x{ny}x{nz}"
    return A, name


def amg_config(args):
    """The AmgConfig of the reference driver's flag set (ij.py:284-327);
    HMIS (type 10) is hypre's default coarsening (par_amg.c:178)."""
    from hypre_tpu_torch.solvers import AmgConfig

    coarsen = "hmis"
    if args.pmis:
        coarsen = "pmis"
    if args.cljp:
        coarsen = "cljp"
    if args.falgout:
        coarsen = "falgout"
    if args.cr:
        coarsen = "cr"
    if args.hmis:
        coarsen = "hmis"
    if args.cgc:
        coarsen = "cgc"
    return AmgConfig(
        max_levels=args.max_levels, max_coarse_size=args.max_coarse_size,
        strong_threshold=args.theta, max_row_sum=args.max_row_sum,
        coarsen_type=coarsen,
        interp_type=args.interptype, trunc_factor=args.trunc_factor,
        p_max_elmts=args.p_max_elmts, relax_type=args.rlx,
        relax_weight=args.relax_weight, num_sweeps=args.num_sweeps,
        relax_order=args.relax_order,
        agg_num_levels=args.agg_num_levels,
        agg_interp_type=args.agg_interp_type, num_paths=args.num_paths,
        additive=max(args.additive, args.mult_add),
        simple=args.simple, add_last_lvl=args.add_last_lvl,
        nongalerk_tol=(tuple(args.nongalerk_tol[1:])
                       if args.nongalerk_tol else ()),
        agg_p_max_elmts=args.agg_p_max_elmts,
        agg_trunc_factor=args.agg_trunc_factor,
        agg_p12_max_elmts=args.agg_p12_max_elmts,
        agg_p12_trunc_factor=args.agg_p12_trunc_factor,
        num_functions=args.num_functions, nodal=args.nodal,
        nodal_diag=args.nodal_diag,
        cheby_order=args.cheby_order,
        cheby_fraction=args.cheby_fraction,
        cheby_eig_iters=args.cheby_eig_iters or 20,
        restr_type=args.restr_type,
        gsmg=args.gsmg, num_samples=args.num_samples,
        cycle_type=("F" if args.fcycle else
                    "W" if args.mu >= 2 else "V"),
        seed=args.seed,
    )


def check_flags(args) -> None:
    """An unknown solver id raises ValueError (the reference prints and
    returns 1)."""
    if args.solver not in SOLVER_IDS:
        raise ValueError(f"solver id {args.solver} not implemented")


def _diag_scale(A):
    from hypre_tpu_torch.core.config import as_real

    dinv = as_real(1.0 / A.diagonal())
    return lambda r: dinv * r


def run(args, amg=None) -> dict:
    """One driver run on the configured device (the CPU in f64 for this
    call under -exec_host).  Returns the problem's name and size, the
    operator ``op``, the BoomerAMG object ``amg`` (None for solvers
    without AMG), the preconditioner ``M``, ``b``, ``x``, ``iters``,
    ``relres``, ``setup_s``, ``solve_s`` and ``level_formats`` (of the
    AMG hierarchy, else of op alone); for -solver 20 also
    ``dscg_iters`` and ``pcg_iters``, for the ParaSails, FSAI, Schwarz
    and ILU ids ``precond_setup_s``; under -lobpcg ``eigenvalues`` and
    ``resnorms``, with ``x`` the eigenvectors and ``iters`` LOBPCG's.

    amg: a BoomerAMG already set up on this problem with this run's
    AmgConfig (amg_config(args)), used in place of a new setup; its
    setup time is then not counted in setup_s."""
    from hypre_tpu_torch.core.config import (
        Config, get_config, set_config,
    )

    check_flags(args)
    caller = get_config()
    if args.exec_host:
        set_config(Config(real_dtype=torch.float64, device="cpu"))
    try:
        return _run(args, amg)
    finally:
        set_config(caller)


def _print_system(A, b) -> None:
    """-printsystem: A and b in IJ format, IJ.out.A and IJ.out.b in the
    working directory (the reference's :247-282)."""
    from hypre_tpu_torch.ij import IJMatrix, IJVector

    n = A.shape[0]
    coo = A.tocoo()
    ijm = IJMatrix(0, n - 1, 0, n - 1)
    ijm.set_values(coo.row, coo.col, coo.data)
    ijm.assemble()
    ijm.print_to("IJ.out.A")
    ijv = IJVector(0, n - 1)
    ijv.set_values(np.arange(n), b)
    ijv.assemble()
    ijv.print_to("IJ.out.b")


def _solve(args, op, A, amg, b, x0, out: dict):
    """The reference's dispatch by solver id (:374-485); returns (x,
    iters, relres, M).  For the ParaSails, FSAI, Schwarz and ILU
    solvers, out["precond_setup_s"] is the preconditioner's setup time
    (part of the solve phase)."""
    from hypre_tpu_torch.core.config import synchronize
    from hypre_tpu_torch.solvers import (
        bicgstab, cgnr, cogmres, flexgmres, gmres, lgmres, pcg,
    )

    solver_id = args.solver
    M = amg if solver_id in NEED_AMG else _diag_scale(A)
    kw = {"x0": x0, "tol": args.tol, "max_iter": args.max_iter}
    kdim = {"k_dim": args.k_dim}
    if solver_id == 0:
        return (*amg.solve(b, x0=x0, tol=args.tol,
                           max_iter=args.mg_max_iter), M)
    krylov = {1: (pcg, {}), 2: (pcg, {}), 3: (gmres, kdim),
              4: (gmres, kdim), 5: (cgnr, {}), 6: (cgnr, {}),
              9: (bicgstab, {}), 10: (bicgstab, {}),
              16: (cogmres, kdim), 17: (cogmres, kdim),
              50: (lgmres, {**kdim, "aug_dim": args.aug_dim}),
              51: (lgmres, {**kdim, "aug_dim": args.aug_dim}),
              60: (flexgmres, kdim), 61: (flexgmres, kdim)}
    if solver_id in krylov:
        fn, extra = krylov[solver_id]
        res = fn(op, b, M=M, **kw, **extra)
        return res.x, res.iters, res.relres, M
    if solver_id == 20:
        from hypre_tpu_torch.solvers.hybrid import HybridConfig, hybrid_solve

        # the driver's own BoomerAMG (same AmgConfig) serves the switch;
        # the reference sets up a second, identical one there
        hres = hybrid_solve(A, b, HybridConfig(
            tol=args.tol, cf_tol=args.cf_tol,
            dscg_max_iter=args.dscg_max_iter,
            pcg_max_iter=args.pcg_max_iter, amg=amg_config(args)),
            amg=amg)
        out["dscg_iters"], out["pcg_iters"] = hres.dscg_iters, hres.pcg_iters
        return (hres.x, hres.dscg_iters + hres.pcg_iters, hres.relres,
                amg)
    t0 = time.perf_counter()
    if solver_id in (80, 81):
        from hypre_tpu_torch.solvers.ilu import ILU, IluConfig

        M = ILU(IluConfig(
            ilu_type=args.ilu_type, fill_level=args.ilu_lfil,
            drop_tol=args.ilu_droptol,
            max_row_nnz=args.ilu_max_row_nnz)).setup(A)
        fn, extra = (gmres, kdim) if solver_id == 80 else (pcg, {})
    elif solver_id in (8, 18):
        from hypre_tpu_torch.solvers.parasails import (
            ParaSails, ParaSailsConfig,
        )

        sym = bool(args.sai_sym) if args.sai_sym is not None \
            else (solver_id == 8)
        M = ParaSails(ParaSailsConfig(
            thresh=args.sai_th, filter=args.sai_filter,
            nlevels=args.sai_lev, sym=sym)).setup(A)
        fn, extra = (pcg, {}) if solver_id == 8 else (gmres, kdim)
    elif solver_id == 43:
        from hypre_tpu_torch.solvers.fsai import FSAI, FsaiConfig

        M = FSAI(FsaiConfig(
            algo_type="adaptive" if args.fs_algo == 1 else "static",
            max_steps=args.fs_max_steps,
            max_step_size=args.fs_max_step_size,
            kap_tolerance=args.fs_kap_tol)).setup(A)
        fn, extra = pcg, {}
    else:                                    # 12: Schwarz-PCG
        from hypre_tpu_torch.solvers.schwarz import Schwarz, SchwarzConfig

        variants = {0: "multiplicative", 2: "additive",
                    3: "sym-multiplicative"}
        M = Schwarz(SchwarzConfig(
            block_size=args.sw_domain, overlap=args.sw_overlap,
            weight=args.sw_weight,
            variant=variants.get(args.sw_variant, "additive"))).setup(A)
        fn, extra = pcg, {}
    # the preconditioner's setup runs in the solve phase, as in the
    # reference (its timer starts before the preconditioner is built)
    synchronize(b.device)
    out["precond_setup_s"] = time.perf_counter() - t0
    res = fn(op, b, M=M.precondition, **kw, **extra)
    return res.x, res.iters, res.relres, M.precondition


def _run(args, amg) -> dict:
    from hypre_tpu_torch.core.config import as_real, get_device, synchronize
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
    from hypre_tpu_torch.solvers import BoomerAMG

    device = get_device()
    if args.fromfile:
        from hypre_tpu_torch.ij import IJMatrix

        A = IJMatrix.read_from(args.fromfile).assemble()
        name = args.fromfile
    else:
        A, name = build_problem(args)
    n = A.shape[0]
    if args.srand is not None:
        args.seed = args.srand
    rng = np.random.RandomState(args.seed)
    if args.rhsfromfile:
        from hypre_tpu_torch.ij import IJVector

        b = IJVector.read_from(args.rhsfromfile).assemble()
    elif args.rhszero:
        b = np.zeros(n)
    else:
        b = rng.rand(n) if args.rhsrand else np.ones(n)
    x0 = (as_real(rng.rand(n)) if args.x0rand
          else as_real(np.ones(n)) if args.xisone else None)
    if args.printsystem:
        _print_system(A, b)
    b = as_real(b)

    solver_id = args.solver
    t0 = time.perf_counter()
    op = sparse_op_from_scipy(A)
    if solver_id in NEED_AMG and amg is None:
        amg = BoomerAMG(amg_config(args)).setup(A)
    elif solver_id not in NEED_AMG:
        amg = None
    synchronize(device)
    setup_s = time.perf_counter() - t0

    out = {"name": name, "n": n, "nnz": A.nnz, "solver": solver_id,
           "op": op, "amg": amg, "b": b,
           "level_formats": (amg.level_formats if amg is not None
                             else [type(op).__name__])}
    t0 = time.perf_counter()
    if args.lobpcg:
        from hypre_tpu_torch.solvers.lobpcg import lobpcg

        X0 = rng.rand(n, args.block_size)
        M = amg if solver_id in (0, 1, 3) else _diag_scale(A)
        res = lobpcg(op, X0, M=M, tol=args.lobpcg_tol,
                     max_iter=args.lobpcg_itr)
        out.update(M=M, x=res.eigenvectors, iters=int(res.iters),
                   eigenvalues=res.eigenvalues.cpu().numpy(),
                   resnorms=res.resnorms.cpu().numpy(), relres=None)
    else:
        x, iters, relres, M = _solve(args, op, A, amg, b, x0, out)
        out.update(M=M, x=x, iters=int(iters), relres=float(relres))
    synchronize(device)
    out.update(setup_s=setup_s, solve_s=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = run(args)
    print(f"  Problem: {out['name']}, {out['n']} rows, {out['nnz']} nonzeros")
    amg = out["amg"]
    if amg is not None and args.print_level:
        sizes = " ".join(str(s) for s in amg.level_sizes)
        print(f"  AMG levels: {sizes}")
        print(f"  Operator complexity = {amg.operator_complexity:.6f}")
        print(f"  Grid complexity     = {amg.grid_complexity:.6f}")
    print(f"Solver: {SOLVER_NAMES.get(out['solver'], out['solver'])}")
    if args.lobpcg:
        print(f"LOBPCG iterations = {out['iters']}")
        print("Eigenvalue lambda    Residual")
        for lam, rn in zip(out["eigenvalues"], out["resnorms"]):
            print(f"{lam: .15e}  {rn:.6e}")
        return 0
    if out["solver"] == 20:
        print(f"PCG_Iterations = {out['pcg_iters']}")
        print(f"DSCG_Iterations = {out['dscg_iters']}")
    print()
    print(f"Setup phase times:  wall clock time = {out['setup_s']:.6f} "
          f"seconds")
    print(f"Solve phase times:  wall clock time = {out['solve_s']:.6f} "
          f"seconds")
    print()
    print(f"Iterations = {out['iters']}")
    print(f"Final Relative Residual Norm = {out['relres']:e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
