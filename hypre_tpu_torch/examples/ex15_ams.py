"""Example 15: 3D electromagnetic diffusion (definite curl-curl) with
AMS-preconditioned CG.

Mirrors src/examples/ex15.c — lowest-order Nedelec (edge) elements on a
uniform hex mesh of the unit cube; the auxiliary-space solver gets the
discrete gradient G and the nodal vector interpolation Pi from the
de Rham complex builders.  Port of examples/ex15_ams.py.
"""
import numpy as np

from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import AMS, pcg
from hypre_tpu_torch.solvers.ams import maxwell_3d


def main(n=8, beta=1.0):
    A, G, Pi = maxwell_3d(n, beta=beta)
    b = np.ones(A.shape[0])
    ams = AMS().setup(A, G, Pi)
    res = pcg(sparse_op_from_scipy(A), b, M=ams.precondition,
              tol=1e-8, max_iter=200)
    r = b - A @ res.x.cpu().numpy()
    rel = np.linalg.norm(r) / np.linalg.norm(b)
    print(f"Iterations = {int(res.iters)}")
    print(f"Final Relative Residual Norm = {rel:e}")
    assert rel < 1e-6
    return int(res.iters)


if __name__ == "__main__":
    main()
