"""Example 11: smallest eigenvalues of the Laplacian with LOBPCG + AMG
(ref: src/examples/ex11.c).  Port of examples/ex11.py."""
import numpy as np

from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, lobpcg


def main(n=33, m=4):
    A = laplacian(n, n)
    amg = BoomerAMG(AmgConfig()).setup(A)
    X0 = np.random.RandomState(0).randn(A.shape[0], m)
    res = lobpcg(sparse_op_from_scipy(A), X0, M=amg, tol=1e-8,
                 max_iter=100)
    print("Eigenvalues:")
    for lam in res.eigenvalues.cpu().numpy():
        print(f"  {lam:.10f}")
    return res


if __name__ == "__main__":
    main()
