"""Example 9: the biharmonic system solved with systems AMG.

Mirrors src/examples/ex9.c — instead of Delta^2 u = f we solve the
system [[Delta, -h^2 I], [0, Delta]] [u; v] = [0; h^2 f] (the
unscaled 5-point stencil pairs with an h^2-scaled coupling, ex9.c:355)
with the systems-AMG configuration: num_functions=2, nodal=1 (block
norm coarsening over the Sabs nodal strength).  Port of
examples/ex9_systems.py.
"""
import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, gmres


def main(n=24):
    L = laplacian(n, n).tocsr()
    N = L.shape[0]
    h2 = 1.0 / (n + 1) ** 2
    eye = sp.identity(N, format="csr")
    # interleaved (node-major) ordering: dof 2i = u_i, 2i+1 = v_i
    A = sp.bmat([[L, -h2 * eye], [None, L]], format="csr")
    perm = np.arange(2 * N).reshape(2, N).T.ravel()
    A = A[perm][:, perm].tocsr()
    b = np.zeros(2 * N)
    b[1::2] = h2

    amg = BoomerAMG(AmgConfig(interp_type=6, num_functions=2,
                              nodal=1)).setup(A)
    res = gmres(sparse_op_from_scipy(A), b, M=amg, tol=1e-8,
                max_iter=200)
    r = b - A @ res.x.cpu().numpy()
    rel = np.linalg.norm(r) / np.linalg.norm(b)
    print(f"Iterations = {int(res.iters)}")
    print(f"Final Relative Residual Norm = {rel:e}")
    assert rel < 1e-6
    return int(res.iters)


if __name__ == "__main__":
    main()
