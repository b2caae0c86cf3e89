"""LOBPCG: locally optimal block preconditioned conjugate gradients.

Port of hypre_tpu/solvers/lobpcg.py (:42-103), the analog of hypre's
LOBPCG (ref: src/krylov/lobpcg.c:208 lobpcg_solve; HYPRE_lobpcg.c:504).
A multivector is an (n, m) tensor.  The block product A X is ``matmat``
(K2-NV on a CSR operator); the orthonormalization (QR) and the
Rayleigh-Ritz step (``eigh`` of the small Gram matrix) are torch.linalg
calls, as the reference's are jnp.linalg calls outside any Pallas
kernel; the preconditioner is applied column by column.  The
convergence test max(resn) < tol reads one scalar an iteration.

Finds the m smallest eigenpairs of the symmetric operator A.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LobpcgResult(NamedTuple):
    eigenvalues: torch.Tensor   # (m,)
    eigenvectors: torch.Tensor  # (n, m)
    iters: int
    resnorms: torch.Tensor      # (m,)


def _apply_columns(op, X):
    """Apply a single-vector operator to each column of (n, m)."""
    return torch.stack([op(X[:, j].contiguous()) for j in range(X.shape[1])],
                       dim=1)


def _ortho(V):
    """Orthonormal columns (QR; the dpotrf cascade of the reference)."""
    return torch.linalg.qr(V).Q


def _eigh(gram):
    """eigh of the symmetrized Gram matrix (jnp.linalg.eigh symmetrizes
    its input; torch's reads one triangle)."""
    return torch.linalg.eigh(0.5 * (gram + gram.T))


def lobpcg(A, X0, M: Callable | None = None, tol: float = 1e-6,
           max_iter: int = 100) -> LobpcgResult:
    """A: a SparseOp or a callable; X0: (n, m) initial block (array or
    tensor; moved to the configured device and dtype); M: a BoomerAMG
    object or AmgHierarchy (one V-cycle a column), a callable r -> z
    (one vector), or None."""
    from hypre_tpu_torch.core.config import as_real
    from hypre_tpu_torch.ops.formats import matmat
    from hypre_tpu_torch.solvers.krylov import _preconditioner

    if callable(A):
        def Amulti(X):
            return _apply_columns(A, X)
    else:
        def Amulti(X):
            return matmat(A, X)
    Mop = _preconditioner(M)

    X = X0 if isinstance(X0, torch.Tensor) else as_real(X0)
    m = X.shape[1]
    X = _ortho(X)
    AX = Amulti(X)
    theta, Q = _eigh(X.T @ AX)
    X = X @ Q
    AX = AX @ Q
    P = None

    it_done = 0
    resn = None
    for it in range(max_iter):
        R = AX - X * theta[None, :]
        resn = torch.linalg.vector_norm(R, dim=0) / torch.clamp(
            theta.abs(), min=1e-30)
        it_done = it
        if float(resn.max()) < tol:
            break
        W = _apply_columns(Mop, R)
        S = torch.cat([X, W] if P is None else [X, W, P], dim=1)
        S = _ortho(S)
        AS = Amulti(S)
        th_all, Q = _eigh(S.T @ AS)
        Qm = Q[:, :m]
        theta = th_all[:m]
        # implicit P: the component of the update orthogonal to X
        Qp = Qm.clone()
        Qp[:m, :] = 0.0
        P = S @ Qp
        X, AX = S @ Qm, AS @ Qm

    return LobpcgResult(eigenvalues=theta, eigenvectors=X, iters=it_done,
                        resnorms=resn)
