"""Batched dense solves that give jnp.linalg.solve's bits on the CPU.

The FSAI and ParaSails setups solve one small dense system a row.  The
reference solves them with ``jnp.linalg.solve`` (hypre_tpu/solvers/
fsai.py:89, parasails.py:91), whose CPU lowering runs LAPACK's getrf
on each system, permutes the right-hand side by the pivots and runs
BLAS's trsm twice (unit lower, then upper), with the routines of
scipy's LAPACK.  numpy's ``linalg.solve`` (gesv, another library's
kernels) parts from it in the last bits, and FSAI's adaptive pattern
ranks candidates by magnitudes that tie exactly on a Laplacian, so
those bits pick other entries.  ``batched_solve`` runs the same calls
on scipy's routines: natively (csrc/setup_kernels.cpp
``batched_lu_solve``, given the routines' pointers) or, with the native
setup off, system by system through scipy.linalg's wrappers.  Either
way the solutions equal the reference's bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.cache
def _routine_ptrs() -> tuple[int, int]:
    """The addresses of scipy's dgetrf and dtrsm (the Cython capsules
    that scipy.linalg.cython_lapack and cython_blas export)."""
    from scipy.linalg import cython_blas, cython_lapack

    api = ctypes.pythonapi
    api.PyCapsule_GetName.restype = ctypes.c_char_p
    api.PyCapsule_GetName.argtypes = [ctypes.py_object]
    api.PyCapsule_GetPointer.restype = ctypes.c_void_p
    api.PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]

    def ptr(capsule):
        return api.PyCapsule_GetPointer(capsule, api.PyCapsule_GetName(
            capsule))

    return (ptr(cython_lapack.__pyx_capi__["dgetrf"]),
            ptr(cython_blas.__pyx_capi__["dtrsm"]))


def _solve_each(mats: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """The same calls system by system through scipy.linalg's wrappers
    (the twin of the native loop; slow)."""
    from scipy.linalg import blas, lapack

    out = np.empty_like(rhs)
    for i in range(mats.shape[0]):
        lu, piv, _ = lapack.dgetrf(mats[i])
        x = rhs[i].copy()
        for j, p in enumerate(piv):
            x[j], x[p] = x[p], x[j]
        x = blas.dtrsm(1.0, lu, x[:, None], side=0, lower=1, diag=1)
        out[i] = blas.dtrsm(1.0, lu, x, side=0, lower=0, diag=0)[:, 0]
    return out


def batched_solve(mats: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """x[b] = mats[b]^-1 rhs[b] in f64 for mats (batch, k, k) and rhs
    (batch, k), bit for bit jnp.linalg.solve's on the CPU."""
    from hypre_tpu_torch.setup.utils import native_enabled

    mats = np.asarray(mats, dtype=np.float64)
    rhs = np.asarray(rhs, dtype=np.float64)
    if mats.shape[0] == 0:
        return rhs.copy()
    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        return native.batched_lu_solve(mats, rhs, *_routine_ptrs())[0]
    return _solve_each(mats, rhs)
