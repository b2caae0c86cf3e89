"""Reference iteration counts of hypre_tpu's struct solvers at the sizes
chip_smoke.py's ``struct`` phase runs, in f64 on the CPU.

    python tools/struct_reference_counts.py out7      # -n 256^3 -solver 11
    python tools/struct_reference_counts.py out3 64   # -n 64^3 -solver 10
    python tools/struct_reference_counts.py msg 32

Each case prints one JSON line: the case, its size, the iterations, the
final relative residual and the seconds taken.  The driver cases run
``hypre_tpu.drivers.struct`` with ``-exec_host``:

* out7: -n 256 256 256 -solver 11 (CG+PFMG), hypre's out.7;
* out5: -n 2048 2048 1 -solver 11, hypre's out.5;
* out1: -n 2048 2048 1 -solver 10 (CG+SMG), hypre's out.1;
* out3 N: -n N N N -solver 10, hypre's out.3 at N (its 128 needs two
  32768^2 dense inverses on the host a 3-D level: the reference cannot
  build it here, so the count is held at the largest N it finishes);
* rbgs: -n 256 256 256 -solver 1 -relax 2 (PFMG alone, RB-GS).

The others build chip_smoke.py's problems with the reference's API:

* msg N: SparseMSG (jump 0) on the N^3 7-pt Laplacian, b = ones, its
  own solve to 1e-6;
* sys N: SysPFMG (relax 1) on tests/test_sys_pfmg.py's two-variable
  coupled system at N^3 (B = c (I + east shift), c = 0.15), with the
  identity added to each Laplacian block: without it the system is
  SPD only on that test's small grids (lambda_min of the 16^3
  Laplacian is 0.10, and the reference's solve diverges there);
  b = ones, to 1e-6;
* fac N: FAC on a (1, N, N) 5-pt coarse grid refined by 2 on the middle
  half (N/4 .. 3N/4), fine stencil 4x the coarse one, b = ones on both
  grids, FAC_CYCLES cycles (tol 1e-6): its convergence factor grows with
  N (1e-6 within 80 cycles at 32^2, 4.1e-5 after 80 at 64^2), so the
  card's run is held to the reference's residual after a fixed count;
* split N: tests/test_sstruct.py's two (1, N, N) parts glued along an
  edge, PCG preconditioned by the Split solver (one PFMG RB-GS cycle a
  part), b = ones, to 1e-6 (at most SPLIT_MAX_ITER iterations).

The counts feed chip_smoke.py's REF_STRUCT_* constants.

    python tools/struct_reference_counts.py fixtures

writes tests/golden/struct_reference.npz, the reference's side of the
port's SMG and SparseMSG tests (tests/test_torch_struct*.py), whose
compiles take 25-130 s a case on a CPU: for each case one cycle on the
rhs default_rng(6).standard_normal(shape) and the standalone solve of
b = ones to 1e-8 (iterations, relres).

The SparseMSG cases (msg, and the fixtures) compile at XLA's backend
optimization level 0: on this CPU (jax 0.9.0) the reference's optimized
SparseMSG cycle is not deterministic — two calls of one jitted cycle at
8^3 differed by 1e-3 relative, some runs abort with heap corruption
(free(): corrupted unsorted chunks), others NaN, as the reference's
own tests/test_sparse_msg.py does in some processes.  At level 0 four
calls agree bit for bit, and equal an uncorrupted optimized call.
"""
import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

DRIVER_CASES = {
    "out7": "-n 256 256 256 -solver 11",
    "out5": "-n 2048 2048 1 -solver 11",
    "out1": "-n 2048 2048 1 -solver 10",
    "out3": "-n {n} {n} {n} -solver 10",
    "rbgs": "-n 256 256 256 -solver 1 -relax 2",
}
L5 = [((0, 0, 0), 4.0), ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
      ((0, -1, 0), -1.0), ((0, 1, 0), -1.0)]
TOL = 1e-6
FAC_CYCLES = 20
# the Split preconditioner ignores the coupling between parts: its count
# grows with N (22 at 32, 62 at 256)
SPLIT_MAX_ITER = 500


def driver_case(flags: str):
    from hypre_tpu.drivers import struct

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        struct.main(flags.split() + ["-exec_host"])
    out = buf.getvalue()
    it = int(re.search(r"Iterations = (\d+)", out).group(1))
    rel = float(re.search(r"Final Relative Residual Norm = (\S+)",
                          out).group(1))
    return it, rel


def msg_case(n: int):
    from hypre_tpu.struct.grid import struct_laplacian
    from hypre_tpu.struct.sparse_msg import SparseMSG, SparseMSGConfig

    msg = SparseMSG(SparseMSGConfig(jump=0)).setup(struct_laplacian(n, n, n))
    _, it, rel = msg.solve(np.ones((n, n, n)), tol=TOL, max_iter=100)
    return int(it), float(rel)


def coupled_system(n: int, c: float = 0.15):
    from hypre_tpu.struct.grid import struct_matrix_from_stencil

    L = struct_matrix_from_stencil((n, n, n), [
        ((0, 0, -1), -1.0), ((0, 0, 1), -1.0), ((0, -1, 0), -1.0),
        ((0, 1, 0), -1.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
        ((0, 0, 0), 7.0)])
    B = struct_matrix_from_stencil((n, n, n),
                                   [((0, 0, 0), c), ((0, 0, 1), 0.5 * c)])
    Bt = struct_matrix_from_stencil((n, n, n),
                                    [((0, 0, 0), c), ((0, 0, -1), 0.5 * c)])
    return {(0, 0): L, (0, 1): B, (1, 0): Bt, (1, 1): L}


def sys_case(n: int):
    from hypre_tpu.struct.pfmg import PfmgConfig
    from hypre_tpu.struct.sys_pfmg import SysPFMG

    s = SysPFMG(PfmgConfig()).setup(coupled_system(n), 2, (n, n, n))
    _, it, rel = s.solve(np.ones((2, n, n, n)), tol=TOL, max_iter=100)
    return int(it), float(rel)


def fac_case(n: int):
    from hypre_tpu.struct.fac import FAC, FacConfig
    from hypre_tpu.struct.grid import struct_matrix_from_stencil

    Ac = struct_matrix_from_stencil((1, n, n), L5)
    fac = FAC(Ac, [(o, 4.0 * v) for o, v in L5], (0, n // 4, n // 4),
              (1, 3 * n // 4, 3 * n // 4), FacConfig())
    b = fac.composite_rhs(np.ones((1, n, n)), np.ones(fac.fine_shape))
    _, it, rel = fac.solve(b, tol=TOL, max_iter=FAC_CYCLES)
    return int(it), float(rel)


def split_case(n: int):
    from hypre_tpu.ops import sparse_op_from_scipy
    from hypre_tpu.solvers import pcg
    from hypre_tpu.sstruct import SplitSolver, SStructGrid, SStructMatrix

    grid = SStructGrid()
    grid.add_part((1, n, n), L5)
    grid.add_part((1, n, n), L5)
    M = SStructMatrix(grid)
    for y in range(n):
        M.add_graph_entry(0, (0, y, n - 1), 1, (0, y, 0), -1.0)
        M.add_graph_entry(1, (0, y, 0), 0, (0, y, n - 1), -1.0)
    A = M.assemble_parcsr()
    split = SplitSolver(M).setup()
    res = pcg(sparse_op_from_scipy(A), np.ones(A.shape[0]),
              M=split.precondition, tol=TOL, max_iter=SPLIT_MAX_ITER)
    return int(res.iters), float(res.relres)


# name -> (shape, struct_laplacian coefficients (cz, cy, cx), jump)
SMG_FIXTURES = {"8^3": ((8, 8, 8), None), "12x10x9": ((12, 10, 9), None),
                "16^3": ((16, 16, 16), None), "2-D 32^2": ((1, 32, 32), None)}
MSG_FIXTURES = {"8^3": ((8, 8, 8), (1.0, 1.0, 1.0), 0),
                "16^3 jump 1": ((16, 16, 16), (1.0, 1.0, 1.0), 1),
                "16^3 anisotropic": ((16, 16, 16), (100.0, 1.0, 0.01), 0),
                "2-D 32^2 jump 1": ((1, 32, 32), (1.0, 1.0, 1.0), 1)}
FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden", "struct_reference.npz")


def fixtures():
    import jax.numpy as jnp

    from hypre_tpu.struct.grid import struct_laplacian
    from hypre_tpu.struct.smg import SMG, SmgConfig, smg_cycle
    from hypre_tpu.struct.sparse_msg import SparseMSG, SparseMSGConfig

    out = {}
    for name, (shape, _) in SMG_FIXTURES.items():
        s = SMG(SmgConfig()).setup(struct_laplacian(*shape))
        rhs = np.random.default_rng(6).standard_normal(shape)
        out[f"smg cycle {name}"] = np.asarray(
            jax.jit(smg_cycle)(s.hierarchy, jnp.asarray(rhs)))
        _, it, rel = s.solve(np.ones(shape), tol=1e-8)
        out[f"smg solve {name}"] = np.array([int(it), float(rel)])
    for name, (shape, c, jump) in MSG_FIXTURES.items():
        m = SparseMSG(SparseMSGConfig(jump=jump)).setup(
            struct_laplacian(*shape, *c))
        rhs = np.random.default_rng(6).standard_normal(shape)
        out[f"msg cycle {name}"] = np.asarray(
            jax.jit(m.cycle)(jnp.asarray(rhs)))
        _, it, rel = m.solve(np.ones(shape), tol=1e-8, max_iter=80)
        out[f"msg solve {name}"] = np.array([int(it), float(rel)])
    np.savez_compressed(FIXTURES, **out)
    return {k: v.tolist() for k, v in out.items() if "solve" in k}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("case", choices=(*DRIVER_CASES, "msg", "sys", "fac",
                                    "split", "fixtures"))
    p.add_argument("n", type=int, nargs="?", default=None)
    opts = p.parse_args()
    if opts.case in ("msg", "fixtures"):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_backend_optimization_level=0")
    t0 = time.time()
    if opts.case == "fixtures":
        print(json.dumps({"fixtures": FIXTURES, "solves": fixtures(),
                          "seconds": time.time() - t0}), flush=True)
        return
    if opts.case in DRIVER_CASES:
        flags = DRIVER_CASES[opts.case].format(n=opts.n)
        it, rel = driver_case(flags)
        size = flags
    else:
        fn = {"msg": msg_case, "sys": sys_case, "fac": fac_case,
              "split": split_case}[opts.case]
        it, rel = fn(opts.n)
        size = opts.n
    print(json.dumps({"case": opts.case, "size": size, "iters": it,
                      "relres": rel, "seconds": time.time() - t0}),
          flush=True)


if __name__ == "__main__":
    main()
