"""struct driver — the port's counterpart of hypre's test/struct.c.

The reference's parser and flags unchanged (``-n``, ``-c``, ``-solver``,
``-tol``, ``-max_iter``, ``-relax``, ``-w``, ``-exec_host``), the
problem built by the port's ``struct_laplacian``, b = ones, and the same
output tail:

    Iterations = %d
    Final Relative Residual Norm = %e

Solver IDs follow the reference (ref: src/test/struct.c:628-658):
  0  = SMG             1  = PFMG
  10 = CG + SMG        11 = CG + PFMG
  17 = CG + diagonal   18 = CG (no precond)
  19 = Jacobi
an unknown id raises ValueError (the reference prints and returns 1).

It runs on the configured device (the card by default); ``-exec_host``
runs that one call on the CPU in f64 and restores the caller's Config.
``run(args)`` returns the run's objects; ``main(argv)`` prints.

    python -m hypre_tpu_torch.drivers.struct -n 256 256 256 -solver 11
    python -m hypre_tpu_torch.drivers.struct -n 32 32 32 -solver 11 -exec_host
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

SOLVER_NAMES = {0: "SMG", 1: "PFMG", 10: "CG+SMG", 11: "CG+PFMG",
                17: "CG+diag", 18: "CG", 19: "Jacobi"}


def build_parser():
    p = argparse.ArgumentParser(prog="struct")
    p.add_argument("-n", nargs=3, type=int, default=[32, 32, 32],
                   metavar=("nx", "ny", "nz"))
    p.add_argument("-c", nargs=3, type=float, default=[1.0, 1.0, 1.0])
    p.add_argument("-solver", type=int, default=0)
    p.add_argument("-tol", type=float, default=1e-6)
    p.add_argument("-max_iter", type=int, default=100)
    p.add_argument("-relax", type=int, default=1,
                   help="PFMG relax: 0 Jacobi, 1 wJacobi, 2 RB-GS")
    p.add_argument("-w", type=float, default=2.0 / 3.0, dest="weight")
    p.add_argument("-exec_host", action="store_true")
    return p


def check_flags(args) -> None:
    if args.solver not in SOLVER_NAMES:
        raise ValueError(f"solver id {args.solver} not implemented")


def run(args) -> dict:
    """One driver run on the configured device (the CPU in f64 for this
    call under -exec_host).  Returns ``name``, ``n``, the operator
    ``A``, the multigrid object ``mg`` (None for 17/18/19), ``level_shapes``
    (of mg), ``b``, ``x``, ``iters``, ``relres``, ``setup_s`` and
    ``solve_s``."""
    from hypre_tpu_torch.core.config import Config, get_config, set_config

    check_flags(args)
    caller = get_config()
    if args.exec_host:
        set_config(Config(real_dtype=torch.float64, device="cpu"))
    try:
        return _run(args)
    finally:
        set_config(caller)


def _run(args) -> dict:
    from hypre_tpu_torch.core.config import get_device, synchronize
    from hypre_tpu_torch.solvers.krylov import pcg
    from hypre_tpu_torch.struct.grid import struct_laplacian, struct_matvec
    from hypre_tpu_torch.struct.pfmg import PFMG, PfmgConfig, mg_solve
    from hypre_tpu_torch.struct.smg import SMG, SmgConfig

    device = get_device()
    nx, ny, nz = args.n
    cx, cy, cz = args.c
    A = struct_laplacian(nz, ny, nx, cz, cy, cx)
    b = torch.ones((nz, ny, nx), dtype=A.coefs.dtype, device=device)

    t0 = time.perf_counter()
    mg = None
    if args.solver in (0, 10):
        mg = SMG(SmgConfig(tol=args.tol, max_iter=args.max_iter)).setup(A)
    elif args.solver in (1, 11):
        mg = PFMG(PfmgConfig(relax_type=args.relax,
                             jacobi_weight=args.weight, tol=args.tol,
                             max_iter=args.max_iter)).setup(A)
    synchronize(device)
    setup_s = time.perf_counter() - t0

    def Aop(u):
        return struct_matvec(A, u)

    dinv = 1.0 / A.coefs[list(A.offsets).index((0, 0, 0))]
    t0 = time.perf_counter()
    if args.solver in (0, 1):
        x, it, rel = mg.solve(b, tol=args.tol, max_iter=args.max_iter)
    elif args.solver == 19:
        # standalone point Jacobi, the reference's struct Jacobi solver
        # (ref: src/struct_ls/jacobi.c)
        x, it, rel = mg_solve(Aop, lambda r: dinv * r, b, None, args.tol,
                              args.max_iter)
    else:
        M = (mg.precondition if mg is not None
             else (lambda r: dinv * r) if args.solver == 17 else None)
        res = pcg(A=Aop, b=b, M=M, tol=args.tol, max_iter=args.max_iter)
        x, it, rel = res.x, res.iters, res.relres
    synchronize(device)
    solve_s = time.perf_counter() - t0
    return {"name": f"{nx}x{ny}x{nz} Laplacian", "n": A.n_rows,
            "solver": args.solver, "A": A, "mg": mg,
            "level_shapes": mg.level_shapes if mg is not None else [],
            "b": b, "x": x, "iters": int(it), "relres": float(rel),
            "setup_s": setup_s, "solve_s": solve_s}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = run(args)
    print(f"Struct problem: {out['name']} ({out['n']} unknowns)")
    print(f"Solver: {SOLVER_NAMES[out['solver']]}")
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
