"""Reference counts of hypre_tpu's ij driver where the driver itself
cannot run them on a CPU in reasonable time or memory.

    python tools/ij_reference_counts.py cgnr 100     # -solver 5
    python tools/ij_reference_counts.py lobpcg 128   # -lobpcg -solver 1

Both build the driver's problem and BoomerAMG (its defaults: HMIS,
ext+i, relax 13/14, P_max 4) at -n N N N in f64 on the CPU and call the
reference's own solver with the V-cycle jitted once:

* cgnr: the driver's AMG-CGNR compiles a while_loop with two inlined
  exact-GS V-cycles, which exhausts LLVM's mapped memory at 100^3.  Here
  hypre_tpu.solvers.krylov_more.cgnr takes the jitted cycle through
  jax.pure_callback.  At 12^3 it prints the driver's count and residual.
* lobpcg: the driver applies the cycle eagerly, one XLA op a wavefront
  (hours at 128^3).  Here hypre_tpu.solvers.lobpcg.lobpcg takes the
  jitted cycle; the block X0 is the driver's (RandomState(2747)).  At
  10^3 it prints the driver's output digit for digit.

The counts feed chip_smoke.py's REF_IJ_SOLVER_ITERS[5] and
REF_LOBPCG_ITERS.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from hypre_tpu.drivers import ij as ref_ij  # noqa: E402
from hypre_tpu.gen import laplacian  # noqa: E402
from hypre_tpu.ops import sparse_op_from_scipy  # noqa: E402
from hypre_tpu.solvers import AmgConfig, BoomerAMG  # noqa: E402
from hypre_tpu.solvers.amg import amg_cycle  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("cgnr", "lobpcg"))
    p.add_argument("n", type=int)
    opts = p.parse_args()
    n = opts.n
    flags = ["-n", str(n), str(n), str(n)] + (
        ["-solver", "5"] if opts.mode == "cgnr" else
        ["-lobpcg", "-solver", "1"])
    args = ref_ij.build_parser().parse_args(flags)
    A = laplacian(n, n, n)
    # the driver's AmgConfig for its default flags (ij.py:284-327)
    cfg = AmgConfig(
        max_levels=args.max_levels, max_coarse_size=args.max_coarse_size,
        strong_threshold=args.theta, max_row_sum=args.max_row_sum,
        coarsen_type="hmis", interp_type=args.interptype,
        trunc_factor=args.trunc_factor, p_max_elmts=args.p_max_elmts,
        relax_type=args.rlx, relax_weight=args.relax_weight,
        num_sweeps=args.num_sweeps, seed=args.seed)
    t = time.time()
    amg = BoomerAMG(cfg).setup(A)
    print("levels", amg.level_sizes, "setup_s", time.time() - t, flush=True)
    cycle = jax.jit(lambda r: amg_cycle(amg.hierarchy, r))
    op = sparse_op_from_scipy(A)
    t = time.time()
    if opts.mode == "cgnr":
        from hypre_tpu.solvers.krylov_more import cgnr

        def M(r):
            return jax.pure_callback(
                lambda v: np.asarray(cycle(jnp.asarray(v))),
                jax.ShapeDtypeStruct(r.shape, r.dtype), r)

        res = cgnr(op, jnp.ones(n ** 3), M=M, tol=args.tol,
                   max_iter=args.max_iter)
        print(f"Iterations = {int(res.iters)}")
        print(f"Final Relative Residual Norm = {float(res.relres):e}")
    else:
        from hypre_tpu.solvers.lobpcg import lobpcg

        X0 = np.random.RandomState(args.seed).rand(n ** 3, args.block_size)
        res = lobpcg(op, X0, M=cycle, tol=args.lobpcg_tol,
                     max_iter=args.lobpcg_itr)
        print(f"LOBPCG iterations = {int(res.iters)}")
        for lam, rn in zip(np.asarray(res.eigenvalues),
                           np.asarray(res.resnorms)):
            print(f"{lam: .15e}  {rn:.6e}")
    print("solve_s", time.time() - t)


if __name__ == "__main__":
    main()
