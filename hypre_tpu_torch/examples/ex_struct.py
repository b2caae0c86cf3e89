"""Struct example: CG + PFMG on a structured 3D grid
(ref: src/examples/ex1-ex4 family).  Port of examples/ex_struct.py."""
import numpy as np

from hypre_tpu_torch.solvers.krylov import pcg
from hypre_tpu_torch.struct.grid import struct_laplacian, struct_matvec
from hypre_tpu_torch.struct.pfmg import PFMG, PfmgConfig


def main(n=32):
    A = struct_laplacian(n, n, n)
    b = np.ones((n, n, n))
    pf = PFMG(PfmgConfig(relax_type=2)).setup(A)
    res = pcg(A=lambda u: struct_matvec(A, u), b=b, M=pf.precondition,
              tol=1e-7, max_iter=50)
    print(f"Iterations = {int(res.iters)}")
    print(f"Final Relative Residual Norm = {float(res.relres):e}")
    return res


if __name__ == "__main__":
    main()
