"""GMRES and BiCGSTAB on torch tensors.

Port of hypre_tpu/solvers/krylov_more.py ``gmres`` (:48-173) and
``bicgstab`` (:308-350), hypre's template solvers (ref:
src/krylov/gmres.c:274, bicgstab.c).  As in the port's ``pcg``, the
loop runs on the host and launches each step's work on the device; each
step reads one scalar (GMRES: the new Hessenberg column, BiCGSTAB: the
residual norm), one device-to-host sync.

GMRES is right-preconditioned restarted modified-Gram-Schmidt GMRES
with Givens rotations; the restart dimension k_dim is 5 by default, as
in the ij driver (ref: src/test/ij.c:1731).  Iterations are counted per
Arnoldi step, with the early exit on the Hessenberg residual estimate
(gmres.c:534-576); after each restart the true residual decides whether
another one runs.  The small Hessenberg system lives on the host in
f64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from hypre_tpu_torch.solvers.krylov import KrylovResult


def _ops(A, M):
    from hypre_tpu_torch.ops.formats import matvec
    from hypre_tpu_torch.solvers.krylov import _preconditioner

    Aop = A if callable(A) else (lambda v: matvec(A, v))
    return Aop, _preconditioner(M)


def _start(b, x0):
    from hypre_tpu_torch.core.config import as_real

    b = b if isinstance(b, torch.Tensor) else as_real(b)
    x = torch.zeros_like(b) if x0 is None else as_real(x0, b.dtype)
    bnorm = float(torch.linalg.vector_norm(b))
    return b, x, (bnorm if bnorm > 0 else 1.0)


def gmres(A, b, x0=None, M=None, tol: float = 1e-8, max_iter: int = 1000,
          k_dim: int = 5) -> KrylovResult:
    """Right-preconditioned restarted GMRES(k_dim), hypre semantics
    (ref: src/krylov/gmres.c:274).

    A: a SparseOp or a callable x -> A@x; b: right-hand side; M: a
    BoomerAMG object or AmgHierarchy (one V-cycle per application), a
    callable r -> z, or None for identity."""
    Aop, Mop = _ops(A, M)
    b, x, safe_b = _start(b, x0)
    m = k_dim

    def arnoldi_cycle(x):
        r = b - Aop(x)
        beta = float(torch.linalg.vector_norm(r))
        V = [r / beta if beta > 0 else torch.zeros_like(r)]
        Z = []
        H = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        done = beta / safe_b <= tol
        j = 0
        while j < m and not done:
            z = Mop(V[j])
            w = Aop(z)
            hs = []
            for i in range(j + 1):         # modified Gram-Schmidt
                hij = torch.dot(V[i], w)
                w = w - hij * V[i]
                hs.append(hij)
            hs.append(torch.linalg.vector_norm(w))
            hcol = np.zeros(m + 1)
            hcol[:j + 2] = torch.stack(hs).tolist()
            hj1 = hcol[j + 1]
            V.append(w / hj1 if hj1 > 0 else torch.zeros_like(w))
            # the earlier rotations on the new column, then its own
            for i in range(j):
                h_i = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = h_i
            denom = max(math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2), 1e-300)
            cs[j], sn[j] = hcol[j] / denom, hcol[j + 1] / denom
            hcol[j], hcol[j + 1] = denom, 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            H[:, j] = hcol
            Z.append(z)
            j += 1
            done = abs(g[j]) / safe_b <= tol
        # back-substitute y from the upper triangular H[:j, :j] and g
        y = np.zeros(j)
        for i in range(j - 1, -1, -1):
            hii = H[i, i] if abs(H[i, i]) > 0 else 1.0
            y[i] = (g[i] - H[i, i + 1:j] @ y[i + 1:]) / hii
        for i in range(j):
            x = x + float(y[i]) * Z[i]
        return x, j

    rel = float(torch.linalg.vector_norm(b - Aop(x))) / safe_b
    it = 0
    while it < max_iter and rel > tol and math.isfinite(rel):
        x, cnt = arnoldi_cycle(x)
        rel = float(torch.linalg.vector_norm(b - Aop(x))) / safe_b
        it += cnt
    return KrylovResult(x=x, iters=it, relres=rel)


def bicgstab(A, b, x0=None, M=None, tol: float = 1e-8,
             max_iter: int = 1000) -> KrylovResult:
    """Preconditioned BiCGSTAB (ref: src/krylov/bicgstab.c); A, b and M
    as for gmres."""
    Aop, Mop = _ops(A, M)
    b, x, safe_b = _start(b, x0)
    r = b - Aop(x)
    rt = r                                  # shadow residual
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    rel = float(torch.linalg.vector_norm(r)) / safe_b
    it = 0
    while it < max_iter and rel > tol and math.isfinite(rel):
        rho_new = torch.dot(rt, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = Mop(p)
        v = Aop(ph)
        alpha = rho_new / torch.dot(rt, v)
        s = r - alpha * v
        sh = Mop(s)
        t = Aop(sh)
        omega = torch.dot(t, s) / torch.clamp(torch.dot(t, t), min=1e-300)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        rel = float(torch.linalg.vector_norm(r)) / safe_b
        it += 1
    return KrylovResult(x=x, iters=it, relres=rel)
