"""Eigenvalue example: smallest Laplacian eigenpairs with LOBPCG,
AMG-preconditioned.

Mirrors the ij driver's -lobpcg mode (ref: src/test/ij.c lobpcg branch;
examples ex5 family).  Port of examples/ex_lobpcg.py: the block
products run K2-NV on a CSR operator.
"""
import numpy as np

from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG
from hypre_tpu_torch.solvers.lobpcg import lobpcg


def main(n=24, nev=4):
    A = laplacian(n, n)
    amg = BoomerAMG(AmgConfig(interp_type=6)).setup(A)
    rng = np.random.default_rng(7)
    X0 = rng.standard_normal((A.shape[0], nev))
    res = lobpcg(sparse_op_from_scipy(A), X0,
                 M=lambda R: amg.precondition(R), tol=1e-6,
                 max_iter=80)
    # analytic eigenvalues of the 2D Dirichlet Laplacian
    k = np.arange(1, 3)
    lam = 4 * np.sin(k[:, None] * np.pi / (2 * (n + 1))) ** 2
    exact = np.sort((lam[:, None, 0] + lam[None, :, 0]).ravel())[:nev]
    got = np.sort(res.eigenvalues.cpu().numpy())[:nev]
    print("eigenvalues:", np.round(got, 6))
    print("exact      :", np.round(exact, 6))
    assert np.allclose(got, exact, rtol=1e-3)
    return got


if __name__ == "__main__":
    main()
