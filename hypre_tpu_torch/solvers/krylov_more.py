"""GMRES, FlexGMRES, LGMRES, COGMRES, BiCGSTAB and CGNR on torch tensors.

Port of hypre_tpu/solvers/krylov_more.py (``gmres`` :48, ``flexgmres``
:174, ``lgmres`` :187, ``cogmres`` :233, ``bicgstab`` :308, ``cgnr``
:353), hypre's template solvers (ref: src/krylov/gmres.c:274,
flexgmres.c, lgmres.c, cogmres.c, bicgstab.c, cgnr.c).  As in the
port's ``pcg``, the loop runs on the host and launches each step's work
on the device; each step reads one scalar (GMRES: the new Hessenberg
column, BiCGSTAB and CGNR: the residual norm; COGMRES: its Hessenberg
matrix once a restart), one device-to-host sync.  Each takes the
optional ``dot=``/``norm=`` reducer of krylov.py (the distributed
solve's sums over shards).

GMRES is right-preconditioned restarted modified-Gram-Schmidt GMRES
with Givens rotations; the restart dimension k_dim is 5 by default, as
in the ij driver (ref: src/test/ij.c:1731).  Iterations are counted per
Arnoldi step, with the early exit on the Hessenberg residual estimate
(gmres.c:534-576); after each restart the true residual decides whether
another one runs.  The small Hessenberg system lives on the host in
f64, and so does COGMRES's least-squares step (numpy's lstsq where the
reference calls ``jnp.linalg.lstsq``, :289).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from hypre_tpu_torch.solvers.krylov import KrylovResult, reducers


def _ops(A, M):
    from hypre_tpu_torch.ops.formats import matvec
    from hypre_tpu_torch.solvers.krylov import _preconditioner

    Aop = A if callable(A) else (lambda v: matvec(A, v))
    return Aop, _preconditioner(M)


def _start(b, x0, norm):
    from hypre_tpu_torch.core.config import as_real

    b = b if isinstance(b, torch.Tensor) else as_real(b)
    x = torch.zeros_like(b) if x0 is None else as_real(x0, b.dtype)
    bnorm = float(norm(b))
    return b, x, (bnorm if bnorm > 0 else 1.0)


def gmres(A, b, x0=None, M=None, tol: float = 1e-8, max_iter: int = 1000,
          k_dim: int = 5, _aug=None, dot=None, norm=None) -> KrylovResult:
    """Right-preconditioned restarted GMRES(k_dim), hypre semantics
    (ref: src/krylov/gmres.c:274).  Because the preconditioned basis Z
    is kept, the same loop is the FGMRES recurrence: M may vary between
    iterations (ref: flexgmres.c).

    A: a SparseOp or a callable x -> A@x; b: right-hand side; M: a
    BoomerAMG object or AmgHierarchy (one V-cycle per application), a
    callable r -> z, or None for identity.  _aug: a list of
    augmentation directions minimized over, one at a time, after each
    Arnoldi cycle (LGMRES)."""
    Aop, Mop = _ops(A, M)
    dot, norm = reducers(dot, norm)
    b, x, safe_b = _start(b, x0, norm)
    m = k_dim

    def arnoldi_cycle(x):
        r = b - Aop(x)
        beta = float(norm(r))
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
                hij = dot(V[i], w)
                w = w - hij * V[i]
                hs.append(hij)
            hs.append(norm(w))
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
        if _aug is not None:
            # line searches along the augmentation directions (a zero
            # direction, not yet filled, moves nothing)
            r = b - Aop(x)
            for zk in _aug:
                Az = Aop(zk)
                den = torch.clamp(dot(Az, Az), min=1e-300)
                alpha = torch.where(norm(zk) > 0,
                                    dot(Az, r) / den, 0.0)
                x = x + alpha * zk
                r = r - alpha * Az
        return x, j

    rel = float(norm(b - Aop(x))) / safe_b
    it = 0
    while it < max_iter and rel > tol and math.isfinite(rel):
        x, cnt = arnoldi_cycle(x)
        rel = float(norm(b - Aop(x))) / safe_b
        it += cnt
    return KrylovResult(x=x, iters=it, relres=rel)


def bicgstab(A, b, x0=None, M=None, tol: float = 1e-8,
             max_iter: int = 1000, dot=None, norm=None) -> KrylovResult:
    """Preconditioned BiCGSTAB (ref: src/krylov/bicgstab.c); A, b and M
    as for gmres."""
    Aop, Mop = _ops(A, M)
    dot, norm = reducers(dot, norm)
    b, x, safe_b = _start(b, x0, norm)
    r = b - Aop(x)
    rt = r                                  # shadow residual
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    rel = float(norm(r)) / safe_b
    it = 0
    while it < max_iter and rel > tol and math.isfinite(rel):
        rho_new = dot(rt, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = Mop(p)
        v = Aop(ph)
        alpha = rho_new / dot(rt, v)
        s = r - alpha * v
        sh = Mop(s)
        t = Aop(sh)
        omega = dot(t, s) / torch.clamp(dot(t, t), min=1e-300)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        rel = float(norm(r)) / safe_b
        it += 1
    return KrylovResult(x=x, iters=it, relres=rel)


def flexgmres(A, b, x0=None, M=None, tol: float = 1e-8,
              max_iter: int = 1000, k_dim: int = 5, dot=None,
              norm=None) -> KrylovResult:
    """Flexible GMRES (ref: src/krylov/flexgmres.c): gmres keeps the
    preconditioned basis, which is the FGMRES recurrence, so this is
    the same loop under the reference's solver name."""
    return gmres(A, b, x0=x0, M=M, tol=tol, max_iter=max_iter, k_dim=k_dim,
                 dot=dot, norm=norm)


def lgmres(A, b, x0=None, M=None, tol: float = 1e-8,
           max_iter: int = 1000, k_dim: int = 10,
           aug_dim: int = 2, dot=None, norm=None) -> KrylovResult:
    """LGMRES (ref: src/krylov/lgmres.c): GMRES(k_dim) augmented with
    the last aug_dim error approximations z = x_r - x_{r-1}, newest
    first, as the reference's rolled (aug_dim, n) buffer holds them."""
    Aop, Mop = _ops(A, M)
    dot, norm = reducers(dot, norm)
    b, x, safe_b = _start(b, x0, norm)
    aug = [torch.zeros_like(b) for _ in range(max(int(aug_dim), 1))]
    rel = float(norm(b - Aop(x))) / safe_b
    it = 0
    while it < max_iter and rel > tol and math.isfinite(rel):
        res = gmres(Aop, b, x0=x, M=Mop, tol=tol, max_iter=k_dim,
                    k_dim=k_dim, _aug=aug, dot=dot, norm=norm)
        aug = [res.x - x] + aug[:-1]
        x = res.x
        rel = float(norm(b - Aop(x))) / safe_b
        it += res.iters
    return KrylovResult(x=x, iters=it, relres=rel)


def cogmres(A, b, x0=None, M=None, tol: float = 1e-8,
            max_iter: int = 1000, k_dim: int = 5, dot=None,
            norm=None) -> KrylovResult:
    """COGMRES (ref: src/krylov/cogmres.c): GMRES with classical
    Gram-Schmidt and one reorthogonalization (CGS2), so each Arnoldi
    step is two block products with the basis.  Every cycle runs all
    k_dim steps and counts them, as the reference's does; y solves the
    (k_dim + 1, k_dim) least-squares problem on the host in f64.  With a
    reducer, each block product is one reduced dot a basis vector (the
    reference's psum of the block, cogmres :247-251)."""
    Aop, Mop = _ops(A, M)
    reduced = dot is not None
    dot, norm = reducers(dot, norm)
    b, x, safe_b = _start(b, x0, norm)
    m = k_dim

    def bdot(Vj, w):
        if not reduced:
            return Vj.reshape(Vj.shape[0], -1) @ w.reshape(-1)
        return torch.stack([dot(v, w) for v in Vj])

    def bcomb(Vj, h):
        return (Vj.reshape(Vj.shape[0], -1).T @ h).reshape(Vj.shape[1:])

    def cycle(x):
        r = b - Aop(x)
        beta = norm(r)
        V = torch.zeros((m + 1,) + tuple(b.shape), dtype=b.dtype,
                        device=b.device)
        V[0] = torch.where(beta > 0, r / torch.clamp(beta, min=1e-300), 0.0)
        Z = torch.zeros((m,) + tuple(b.shape), dtype=b.dtype,
                        device=b.device)
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        for j in range(m):
            z = Mop(V[j])
            w = Aop(z)
            Vj = V[:j + 1]
            h = bdot(Vj, w)
            w = w - bcomb(Vj, h)
            h2 = bdot(Vj, w)
            w = w - bcomb(Vj, h2)
            hj1 = norm(w)
            V[j + 1] = torch.where(hj1 > 0, w / torch.clamp(hj1, min=1e-300),
                                   0.0)
            H[:j + 1, j] = h + h2
            H[j + 1, j] = hj1
            Z[j] = z
        e1 = np.zeros(m + 1)
        e1[0] = float(beta)
        y = np.linalg.lstsq(H.cpu().double().numpy(), e1, rcond=None)[0]
        return x + bcomb(Z, torch.as_tensor(y, dtype=b.dtype,
                                            device=b.device))

    rel = float(norm(b - Aop(x))) / safe_b
    it = 0
    while it < max_iter and rel > tol and math.isfinite(rel):
        x = cycle(x)
        rel = float(norm(b - Aop(x))) / safe_b
        it += m
    return KrylovResult(x=x, iters=it, relres=rel)


def cgnr(A, b, x0=None, M=None, tol: float = 1e-8, max_iter: int = 1000,
         At=None, Mt=None, dot=None, norm=None) -> KrylovResult:
    """CGNR, hypre semantics (ref: src/krylov/cgnr.c:206-434): CG on the
    preconditioned normal equations (AC)^T (AC) y = (AC)^T b with
    x = C y (cgnr.c:361 "q = A*C*p", the transpose at cgnr.c:380).

    At / Mt: operators for A^T and C^T; they default to A and C (a
    symmetric operator), as the reference's do."""
    Aop, Mop = _ops(A, M)
    Atop = Aop if At is None else _ops(At, None)[0]
    Mtop = Mop if Mt is None else _ops(A, Mt)[1]
    dot, norm = reducers(dot, norm)
    b, x, safe_b = _start(b, x0, norm)
    r = b - Aop(x)
    p = Mtop(Atop(r))                      # s = C^T A^T r
    gamma = dot(p, p)
    rel = float(norm(r)) / safe_b
    it = 0
    while it < max_iter and rel > tol and math.isfinite(rel):
        t = Mop(p)                         # t = C p
        w = Aop(t)                         # w = A C p
        alpha = gamma / torch.clamp(dot(w, w), min=1e-300)
        x = x + alpha * t
        r = r - alpha * w
        s = Mtop(Atop(r))
        gamma_new = dot(s, s)
        p = s + gamma_new / torch.clamp(gamma, min=1e-300) * p
        gamma = gamma_new
        rel = float(norm(r)) / safe_b
        it += 1
    return KrylovResult(x=x, iters=it, relres=rel)
