"""Hybrid solver: diagonal-scaled CG first, AMG-PCG when it is slow.

Port of hypre_tpu/solvers/hybrid.py (``hybrid_solve`` :39), the analog
of hypre's AMGHybrid (ref: src/parcsr_ls/amg_hybrid.c:1703; the DSCG to
AMG switch :1922+): diagonal-scaled CG runs while the convergence factor
of an iteration stays at or below cf_tol (0.9 by default, the ij
driver's -cf); past it BoomerAMG is set up and AMG-PCG continues from
the current iterate.  The driver prints dscg_iters + pcg_iters.  Each
DSCG iteration reads the residual norm (one sync), as the reference's
does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from hypre_tpu_torch.ops.vector import dot
from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG


class HybridResult(NamedTuple):
    x: torch.Tensor
    dscg_iters: int
    pcg_iters: int
    relres: float


@dataclasses.dataclass
class HybridConfig:
    cf_tol: float = 0.9            # convergence-factor switch threshold
    dscg_max_iter: int = 1000
    pcg_max_iter: int = 200
    tol: float = 1e-8
    amg: AmgConfig = dataclasses.field(default_factory=AmgConfig)


def hybrid_solve(A_scipy, b, config: HybridConfig | None = None,
                 amg: BoomerAMG | None = None) -> HybridResult:
    """DSCG first, the convergence factor checked every iteration; AMG-PCG
    once it exceeds cf_tol.  amg: a BoomerAMG already set up on A_scipy
    with config.amg, used in place of a new setup at the switch."""
    from hypre_tpu_torch.core.config import as_real
    from hypre_tpu_torch.ops.formats import matvec, sparse_op_from_scipy
    from hypre_tpu_torch.solvers.krylov import pcg

    cfg = config or HybridConfig()
    op = sparse_op_from_scipy(A_scipy)
    b = b if isinstance(b, torch.Tensor) else as_real(np.asarray(b))
    dinv = as_real(1.0 / A_scipy.diagonal(), b.dtype)

    bnorm = float(torch.linalg.vector_norm(b))
    safe_b = bnorm if bnorm > 0 else 1.0

    # phase 1: diagonal-scaled CG, the convergence factor monitored
    x = torch.zeros_like(b)
    r = b
    z = dinv * r
    p = z
    gamma = dot(r, z)
    rnorm_prev = float(torch.linalg.vector_norm(r))
    dscg_iters = 0
    switched = False
    relres = rnorm_prev / safe_b
    while dscg_iters < cfg.dscg_max_iter and relres > cfg.tol:
        s = matvec(op, p)
        alpha = gamma / dot(p, s)
        x = x + alpha * p
        r = r - alpha * s
        z = dinv * r
        gamma_new = dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        rnorm = float(torch.linalg.vector_norm(r))
        dscg_iters += 1
        cf = rnorm / max(rnorm_prev, 1e-300)
        rnorm_prev = rnorm
        relres = rnorm / safe_b
        if cf > cfg.cf_tol and dscg_iters >= 2:
            switched = True
            break

    if not switched or relres <= cfg.tol:
        return HybridResult(x=x, dscg_iters=dscg_iters, pcg_iters=0,
                            relres=relres)

    # phase 2: AMG-PCG from the current iterate
    if amg is None:
        amg = BoomerAMG(cfg.amg).setup(A_scipy)
    res = pcg(op, b, x0=x, M=amg, tol=cfg.tol, max_iter=cfg.pcg_max_iter)
    return HybridResult(x=res.x, dscg_iters=dscg_iters,
                        pcg_iters=int(res.iters), relres=float(res.relres))
