"""Example 3: structured 2D Laplacian solved with PFMG.

Mirrors src/examples/ex3.c — the struct interface with a 5-point
stencil and the PFMG semicoarsening multigrid solver.  Port of
examples/ex3_pfmg.py.
"""
import numpy as np

from hypre_tpu_torch.struct.grid import struct_laplacian
from hypre_tpu_torch.struct.pfmg import PFMG, PfmgConfig


def main(n=64):
    A = struct_laplacian(1, n, n)      # (nz, ny, nx) single 2D slab
    b = np.ones((1, n, n))
    pfmg = PFMG(PfmgConfig(tol=1e-8, max_iter=60)).setup(A)
    x, iters, relres = pfmg.solve(b)
    print(f"Iterations = {int(iters)}")
    print(f"Final Relative Residual Norm = {float(relres):e}")
    assert float(relres) < 1e-7
    return int(iters)


if __name__ == "__main__":
    main()
