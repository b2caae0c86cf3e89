"""Mixed-precision iterative refinement: f32 inner solves, f64 outer
residuals.

Port of hypre_tpu/solvers/refine.py (``stencil_apply_f64`` :33,
``ir_solve`` :56).  The inner solve runs in f32 (hypre's
--enable-single analog; on the card an f32 AMG-PCG) and bottoms out at
relative residuals ~1e-6/7; the classic refinement loop (Wilkinson
iterative refinement) closes the gap to f64 accuracy:

    x = 0
    repeat:  r  = b - A x        (f64, outer, host numpy)
             dx = inner_solve(r) (f32, on the configured device)
             x += dx             (f64)

The outer residual is exact f64: for stencil operators an analytic
numpy stencil application (no matrix); for general operators any
callable, e.g. a scipy f64 SpMV.  Each refinement step multiplies the
error by the f32 solve's convergence factor, so 2-3 outer rounds reach
true f64 1e-8 from a 1e-6 inner tolerance.  The inner solve may return
a numpy array or a torch tensor on any device.

Ref: hypre mixed-precision builds (configure --enable-single +
HYPRE_Real vs HYPRE_LongDouble plumbing, src/configure:1550-1730);
the refinement loop itself matches classic IR.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def stencil_apply_f64(shape, entries, x: np.ndarray) -> np.ndarray:
    """y = A @ x in f64 for a constant-stencil operator with Dirichlet
    truncation (the operator gen.laplacian builds, ref:
    src/parcsr_ls/par_laplace.c:63) — pure numpy slices, no matrix."""
    nx, ny, nz = shape
    X = np.asarray(x, np.float64).reshape(nz, ny, nx)
    Y = np.zeros_like(X)
    for (dx, dy, dz), v in entries:
        if v == 0.0:
            continue
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        for ax, d in ((2, dx), (1, dy), (0, dz)):
            if d > 0:
                dst[ax] = slice(0, -d)
                src[ax] = slice(d, None)
            elif d < 0:
                dst[ax] = slice(-d, None)
                src[ax] = slice(0, d)
        Y[tuple(dst)] += v * X[tuple(src)]
    return Y.reshape(-1)


def ir_solve(apply_f64, b: np.ndarray, inner_solve, tol: float = 1e-8,
             max_outer: int = 6):
    """Iterative refinement driver.

    apply_f64:   x_f64 -> A@x in f64 (host)
    inner_solve: r_f32 -> approximate A^{-1} r (f32, device); any
                 callable returning (dx, inner_iters)
    Returns dict(x, outer_iters, inner_iters_total, relres, wall_s).
    """
    t0 = time.time()
    b = np.asarray(b, np.float64)
    bn = np.linalg.norm(b)
    bn = bn if bn > 0 else 1.0
    x = np.zeros_like(b)
    r = b.copy()
    inner_total = 0
    outer = 0
    relres = 1.0
    for outer in range(1, max_outer + 1):
        # scale the residual to O(1) so the f32 inner solve keeps
        # full mantissa resolution regardless of how small r gets
        rn = np.linalg.norm(r)
        if rn == 0:
            break
        dx, it = inner_solve((r / rn).astype(np.float32))
        inner_total += int(it)
        x = x + rn * _host_f64(dx)
        r = b - apply_f64(x)
        relres = float(np.linalg.norm(r) / bn)
        if relres <= tol:
            break
    return {
        "x": x,
        "outer_iters": outer,
        "inner_iters_total": inner_total,
        "relres": relres,
        "wall_s": round(time.time() - t0, 3),
    }


def _host_f64(v) -> np.ndarray:
    """A correction as a host f64 array (a tensor is copied back)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)
