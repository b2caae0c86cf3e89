"""Preconditioned conjugate gradients on torch tensors.

Port of hypre_tpu/solvers/krylov.py ``pcg`` (ref: src/krylov/pcg.c:
318).  The loop runs on the host and launches each iteration's work on
the device; the stop test is the reference's (krylov.py:125-158): the
two-norm form the ij driver selects (HYPRE_PCGSetTwoNorm(pcg, 1), ref:
src/test/ij.c:5019), ||r_k||_2 / ||b||_2 <= tol with the recursively
updated residual, plus the atol and NaN/Inf guards.  Reading the
residual norm each iteration is one device-to-host sync.

Every loop takes an optional reducer, ``dot=`` and ``norm=``: the
analog of the reference's ``make_reducers(axis_name)`` (krylov.py:
32-52), the TPU form of hypre's vtable (ref: src/krylov/pcg.h:49-70).
The default is the flat ``ops/vector.dot`` and ``vector_norm`` of one
device; the distributed solve (solvers/par_amg.py) passes its
communicator's, which sum per shard and then over shards.

While the tracer (core/trace.py) is on, pcg records the spans
``pcg.solve`` (``iters``), ``pcg.iter`` (the K1 and K2 launches of the
iteration) and ``pcg.sync`` (the host waiting on a norm).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from hypre_tpu_torch.core import trace
from hypre_tpu_torch.ops.vector import dot as _vdot


class KrylovResult(NamedTuple):
    """What pcg, gmres and bicgstab return."""

    x: torch.Tensor
    iters: int
    relres: float


def _preconditioner(M) -> Callable[[torch.Tensor], torch.Tensor]:
    from hypre_tpu_torch.solvers.amg import AmgHierarchy, BoomerAMG, \
        amg_cycle

    if M is None:
        return lambda r: r
    if isinstance(M, BoomerAMG):
        h = M.hierarchy
        return lambda r: amg_cycle(h, r)
    if isinstance(M, AmgHierarchy):
        return lambda r: amg_cycle(M, r)
    return M


def reducers(dot=None, norm=None):
    """(dot, norm): the given ones, or the single-device defaults."""
    return dot or _vdot, norm or torch.linalg.vector_norm


def pcg(A, b, x0=None, M=None, tol: float = 1e-8,
        max_iter: int = 1000, atol: float = 0.0, dot=None,
        norm=None) -> KrylovResult:
    """Preconditioned conjugate gradients (ref: src/krylov/pcg.c:318).

    A: a SparseOp (ops/formats.py) or a callable x -> A@x
    b: right-hand side (tensor or array; moved to the configured device
       and dtype unless it is already a tensor there)
    M: a BoomerAMG object or AmgHierarchy (one V-cycle per
       application), a callable r -> z, or None for identity.
    """
    from hypre_tpu_torch.core.config import as_real
    from hypre_tpu_torch.ops.formats import matvec

    solve = trace.begin("pcg.solve") if trace.on else None
    b = b if isinstance(b, torch.Tensor) else as_real(b)
    x = torch.zeros_like(b) if x0 is None else as_real(x0, b.dtype)
    Aop = A if callable(A) else (lambda v: matvec(A, v))
    Mop = _preconditioner(M)
    dot, norm = reducers(dot, norm)

    bnorm = _traced_read(norm(b)) if trace.on else float(norm(b))
    safe_b = bnorm if bnorm > 0 else 1.0
    r = b - Aop(x)
    p = Mop(r)
    gamma = dot(r, p)
    rnorm = _traced_read(norm(r)) if trace.on else float(norm(r))
    it = 0
    # isfinite: the NaN/Inf guard of par_amg_solve.c:208 — stop
    # iterating instead of spinning to max_iter on a blown-up state
    while (it < max_iter and rnorm / safe_b > tol and rnorm > atol
           and math.isfinite(rnorm)):
        mark = _iter_begin() if trace.on else None
        s = Aop(p)
        alpha = gamma / dot(p, s)
        x = x + alpha * p
        r = r - alpha * s
        z = Mop(r)
        gamma_new = dot(r, z)
        beta = gamma_new / gamma
        p = z + beta * p
        gamma = gamma_new
        rnorm = _traced_read(norm(r)) if trace.on else float(norm(r))
        it += 1
        if mark is not None:
            _iter_end(mark)
    if solve is not None:
        trace.end(solve, iters=it)
    return KrylovResult(x=x, iters=it, relres=rnorm / safe_b)


def _traced_read(v: torch.Tensor) -> float:
    """float(v) inside a ``pcg.sync`` span: the host waits for the card."""
    tok = trace.begin("pcg.sync")
    out = float(v)
    trace.end(tok)
    return out


def _launches() -> tuple:
    from hypre_tpu_torch.ops.spmv import csr_spmv
    from hypre_tpu_torch.ops.stencil import stencil_matvec

    return stencil_matvec.launches, csr_spmv.launches


def _iter_begin():
    return trace.begin("pcg.iter"), _launches()


def _iter_end(mark) -> None:
    """Close a ``pcg.iter`` span with the K1 and K2 launches it made."""
    tok, (k1, k2) = mark
    n1, n2 = _launches()
    trace.end(tok, stencil_matvec=n1 - k1, csr_spmv=n2 - k2)
