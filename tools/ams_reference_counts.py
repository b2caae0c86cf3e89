"""Reference iteration counts and eigenvalues of hypre_tpu's
auxiliary-space solvers and API rows, in f64 on the CPU, at the sizes
chip_smoke.py's ``maxwell`` phase holds.

    python tools/ams_reference_counts.py ams 40        # maxwell_3d(40)
    python tools/ams_reference_counts.py ads 18        # rt0_3d(18)
    python tools/ams_reference_counts.py maxwell 40
    python tools/ams_reference_counts.py ame 3
    python tools/ams_reference_counts.py capi 48
    python tools/ams_reference_counts.py amg 128
    python tools/ams_reference_counts.py ir 128
    python tools/ams_reference_counts.py examples 0

Each case prints one JSON line: the case, its size, the iterations, the
final relative residual (and the true one), the level sizes where there
are some, and the seconds taken.  Every row has b = ones:

* ams N: AMS-PCG (AmsConfig's defaults) on maxwell_3d(N), beta 1, tol
  1e-8, max_iter 200 (ex15);
* ads N: ADS-PCG with the inner AMS on rt0_3d(N), the same knobs;
* maxwell N: SStructMaxwell-PCG on maxwell_3d(N), the same knobs;
* ame N: AME (nev 3, tol 1e-6, max_iter 100, seed 0) on maxwell_3d(N):
  iterations and the eigenvalues;
* capi N: examples/ex_capi.py's HYPRE_* flow (Falgout, relax 6, PCG
  tol 1e-7) on the N^3 7-pt Laplacian;
* amg N: BoomerAMG(AmgConfig(interp_type=6))-PCG, tol 1e-8, on the N^3
  7-pt Laplacian (the checkpoint row);
* ir N: ir_solve to 1e-8 on the N^3 7-pt Laplacian with an inner
  AMG-PCG (AmgConfig(interp_type=6), tol 1e-6, max_iter 50) in f32: this
  case runs with jax's x64 off, so the inner solve is the reference's
  single-precision build; outer and total inner iterations;
* examples (n unused): each of examples/*.py (but ex_multichip) at the
  size of tests/test_examples.py, the iterations its main returns
  (ex_lobpcg: its eigenvalues).  chip_smoke.py and
  tests/test_torch_examples.py hold the port's examples to these.

The reference's cycles run inside its jitted PCG, one XLA program a
solve.  Its host setups are numpy and its compiles grow with the
hierarchy's depth: the sizes above are the largest that finish within
~20 minutes on an 8-core CPU (ads 18: 4 min, its B_Pi one dense 20577^2
level; capi 48: 12 min, while capi 64 compiled for over 28).  ex15 at
100 (3M edges) and SStructMaxwell at 100 are out of its reach here;
chip_smoke.py holds those rows to these counts + 2.
"""
import argparse
import json
import sys
import time

import numpy as np

ST7 = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
       ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
       ((0, 0, -1), -1.0), ((0, 0, 1), -1.0)]


def _jax(x64: bool = True):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)


def _pcg_row(A, M, tol=1e-8, max_iter=200) -> dict:
    from hypre_tpu.ops import sparse_op_from_scipy
    from hypre_tpu.solvers import pcg

    b = np.ones(A.shape[0])
    res = pcg(sparse_op_from_scipy(A), b, M=M, tol=tol, max_iter=max_iter)
    x = np.asarray(res.x)
    return {"iters": int(res.iters), "relres": float(res.relres),
            "true_relres": float(np.linalg.norm(b - A @ x)
                                 / np.linalg.norm(b))}


def ams_case(n: int) -> dict:
    from hypre_tpu.solvers import AMS
    from hypre_tpu.solvers.ams import maxwell_3d

    A, G, Pi = maxwell_3d(n)
    ams = AMS().setup(A, G, Pi)
    return {"edges": A.shape[0], "bg_levels": ams.bg.level_sizes,
            "bpi_levels": ams.bpi.level_sizes,
            **_pcg_row(A, ams.precondition)}


def ads_case(n: int) -> dict:
    from hypre_tpu.solvers.ams import ADS, rt0_3d

    A, C, Pi_f, G, Pi_e = rt0_3d(n)
    ads = ADS().setup(A, C, Pi_f, G=G, Pi_e=Pi_e)
    return {"faces": A.shape[0], "bpi_levels": ads.bpi.level_sizes,
            "inner_bg_levels": ads.bc_ams.bg.level_sizes,
            "inner_bpi_levels": ads.bc_ams.bpi.level_sizes,
            **_pcg_row(A, ads.precondition)}


def maxwell_case(n: int) -> dict:
    from hypre_tpu.solvers.ams import maxwell_3d
    from hypre_tpu.solvers.maxwell import SStructMaxwell

    A, G, _ = maxwell_3d(n)
    mx = SStructMaxwell().setup(A, G)
    return {"edges": A.shape[0],
            "levels": [int(lvl["A"].shape[0]) for lvl in mx.levels],
            **_pcg_row(A, mx.precondition)}


def ame_case(n: int) -> dict:
    from hypre_tpu.solvers import AME
    from hypre_tpu.solvers.ams import maxwell_3d

    A, G, Pi = maxwell_3d(n)
    res = AME().setup(A, G, Pi).solve(3, tol=1e-6, max_iter=100)
    return {"edges": A.shape[0], "iters": int(res.iters),
            "eigenvalues": [float(v) for v in np.asarray(res.eigenvalues)],
            "resnorms": [float(v) for v in np.asarray(res.resnorms)]}


def capi_case(n: int) -> dict:
    from hypre_tpu import hypre_compat as H
    from hypre_tpu.gen import laplacian

    A = laplacian(n, n, n)
    b = np.ones(A.shape[0])
    precond = H.HYPRE_BoomerAMGCreate()
    H.HYPRE_BoomerAMGSetCoarsenType(precond, 6)
    H.HYPRE_BoomerAMGSetRelaxType(precond, 6)
    H.HYPRE_BoomerAMGSetNumSweeps(precond, 1)
    H.HYPRE_BoomerAMGSetTol(precond, 0.0)
    H.HYPRE_BoomerAMGSetMaxIter(precond, 1)
    solver = H.HYPRE_ParCSRPCGCreate()
    H.HYPRE_PCGSetMaxIter(solver, 1000)
    H.HYPRE_PCGSetTol(solver, 1e-7)
    H.HYPRE_PCGSetPrecond(solver, precond_handle=precond)
    H.HYPRE_ParCSRPCGSetup(solver, A, b)
    x = H.HYPRE_ParCSRPCGSolve(solver, A, b)
    return {"iters": H.HYPRE_PCGGetNumIterations(solver),
            "relres": H.HYPRE_PCGGetFinalRelativeResidualNorm(solver),
            "true_relres": float(np.linalg.norm(b - A @ x)
                                 / np.linalg.norm(b)),
            "levels": precond.amg.level_sizes}


def amg_case(n: int) -> dict:
    from hypre_tpu.gen import laplacian
    from hypre_tpu.solvers import AmgConfig, BoomerAMG

    A = laplacian(n, n, n)
    amg = BoomerAMG(AmgConfig(interp_type=6)).setup(A)
    return {"levels": amg.level_sizes, **_pcg_row(A, amg)}


def ir_case(n: int) -> dict:
    from hypre_tpu.gen import laplacian
    from hypre_tpu.ops import sparse_op_from_scipy
    from hypre_tpu.solvers import AmgConfig, BoomerAMG, pcg
    from hypre_tpu.solvers.refine import ir_solve, stencil_apply_f64

    A = laplacian(n, n, n)
    amg = BoomerAMG(AmgConfig(interp_type=6)).setup(A)
    op = sparse_op_from_scipy(A)
    b = np.ones(A.shape[0])

    def inner(r32):
        res = pcg(op, np.asarray(r32, np.float32), M=amg, tol=1e-6,
                  max_iter=50)
        return np.asarray(res.x), int(res.iters)

    out = ir_solve(lambda x: stencil_apply_f64((n, n, n), ST7, x), b,
                   inner, tol=1e-8)
    return {"outer_iters": out["outer_iters"],
            "inner_iters_total": out["inner_iters_total"],
            "relres": out["relres"]}


def examples_case(_n: int) -> dict:
    import contextlib
    import io
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "examples"))
    import ex3_pfmg
    import ex5
    import ex6_multibox
    import ex9_systems
    import ex11
    import ex15_ams
    import ex_capi
    import ex_lobpcg
    import ex_struct

    with contextlib.redirect_stdout(io.StringIO()):
        got = {"ex5": int(ex5.main(n=20).iters),
               "ex11": int(ex11.main(n=16, m=2).iters),
               "ex_struct": int(ex_struct.main(n=16).iters),
               "ex3_pfmg": ex3_pfmg.main(n=32),
               "ex15_ams": ex15_ams.main(n=6),
               "ex9_systems": [ex9_systems.main(n=24),
                               ex9_systems.main(n=48)],
               "ex6_multibox": ex6_multibox.main(n=12)[0],
               "ex_capi": ex_capi.main(n=20)}
        lam = ex_lobpcg.main(n=16, nev=3)
    return {"iters": got, "ex_lobpcg_eigenvalues": [float(v) for v in lam]}


CASES = {"ams": ams_case, "ads": ads_case, "maxwell": maxwell_case,
         "ame": ame_case, "capi": capi_case, "amg": amg_case,
         "ir": ir_case, "examples": examples_case}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("case", choices=tuple(CASES))
    p.add_argument("n", type=int)
    a = p.parse_args()
    _jax(x64=a.case != "ir")
    t0 = time.time()
    row = CASES[a.case](a.n)
    print(json.dumps({"case": a.case, "n": a.n, **row,
                      "seconds": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
