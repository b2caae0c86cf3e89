"""Example: porting hypre C-API code verbatim.

The body below is src/examples/ex5.c's solver section transliterated —
every HYPRE_* call keeps the reference's name and argument order, via
hypre_tpu_torch.hypre_compat.  Port of examples/ex_capi.py.
"""
import numpy as np

from hypre_tpu_torch import hypre_compat as H
from hypre_tpu_torch.gen import laplacian


def main(n=33):
    A = laplacian(n, n)                 # ex5.c's 2D 5-pt Laplacian
    b = np.ones(A.shape[0])

    # --- ex5.c lines 280-320, names preserved -----------------------
    precond = H.HYPRE_BoomerAMGCreate()
    H.HYPRE_BoomerAMGSetPrintLevel(precond, 1)
    H.HYPRE_BoomerAMGSetCoarsenType(precond, 6)      # Falgout
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

    num_iterations = H.HYPRE_PCGGetNumIterations(solver)
    final_res_norm = H.HYPRE_PCGGetFinalRelativeResidualNorm(solver)
    # ----------------------------------------------------------------

    print(f"Iterations = {num_iterations}")
    print(f"Final Relative Residual Norm = {final_res_norm:e}")
    assert final_res_norm < 1e-6
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-6
    return num_iterations


if __name__ == "__main__":
    main()
