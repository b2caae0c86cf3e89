"""Example 6: multi-box struct grid — PFMG on an L-shaped domain.

Mirrors src/examples/ex6.c's two-box sstruct grid (an L-shaped union
of boxes), embedded in its bounding box with an active-cell mask; PFMG
runs unchanged on the masked operator (identity rows outside the
union).  Port of examples/ex6_multibox.py.
"""
import numpy as np

from hypre_tpu_torch.struct.boxes import Box, StructGrid
from hypre_tpu_torch.struct.grid import struct_matvec
from hypre_tpu_torch.struct.pfmg import PFMG, PfmgConfig

LAP7 = [((0, 0, 0), 6.0), ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
        ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
        ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0)]


def main(n=16):
    half = n // 2
    grid = StructGrid([
        Box((0, 0, 0), (half - 1, n - 1, n - 1)),
        Box((half, 0, 0), (n - 1, n - 1, half - 1)),
    ])
    print(f"L-domain: {grid.local_size} active of "
          f"{int(np.prod(grid.shape))} bounding cells")
    A = grid.matrix_from_stencil(LAP7)
    b = grid.vector(1.0)
    x, iters, relres = PFMG(PfmgConfig(tol=1e-8, max_iter=60)
                            ).setup(A).solve(b)
    r = b - struct_matvec(A, x).cpu().numpy()
    true_rel = np.linalg.norm(r[grid.mask]) / np.linalg.norm(
        b[grid.mask])
    print(f"Iterations = {int(iters)}")
    print(f"Final Relative Residual Norm = {true_rel:e}")
    assert true_rel < 1e-7
    return int(iters), true_rel


if __name__ == "__main__":
    main()
