"""Example 5: AMG-preconditioned CG on a 2D 5-point Laplacian.

The canonical hypre example (ref: src/examples/ex5.c) — assemble with
the IJ interface, solve with BoomerAMG-PCG.  Port of examples/ex5.py.
"""
import numpy as np

from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ij import IJMatrix, IJVector
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg


def main(n=33):
    N = n * n
    # assemble through the IJ interface exactly like ex5.c
    ref = laplacian(n, n)
    ij = IJMatrix(0, N - 1, 0, N - 1)
    coo = ref.tocoo()
    ij.set_values(coo.row, coo.col, coo.data)
    A = ij.assemble()

    bv = IJVector(0, N - 1)
    bv.set_values(np.arange(N), np.ones(N))
    b = bv.assemble()

    amg = BoomerAMG(AmgConfig(interp_type=6)).setup(A)
    res = pcg(sparse_op_from_scipy(A), b, M=amg, tol=1e-7, max_iter=100)
    print(f"Iterations = {int(res.iters)}")
    print(f"Final Relative Residual Norm = {float(res.relres):e}")
    return res


if __name__ == "__main__":
    main()
