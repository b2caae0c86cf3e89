"""Shared helpers for host-side AMG setup: row-wise reductions over CSR
arrays and the deterministic PMIS measure hash."""
from __future__ import annotations

import os

import numpy as np


def native_enabled() -> bool:
    """Use the OpenMP C++ setup kernels (csrc/) when available.

    Disable with HYPRE_TPU_TORCH_NATIVE_SETUP=0 (the vectorized-numpy
    twins then run; tests exercise both paths).  A failed build also
    falls back to numpy silently, so a caller that needs the native
    path (chip_smoke.py) calls csrc.build.load() itself."""
    if os.environ.get("HYPRE_TPU_TORCH_NATIVE_SETUP", "1") == "0":
        return False
    try:
        from hypre_tpu_torch.csrc.build import load

        load()
        return True
    except Exception:
        return False


def row_reduce(data, indptr, op, empty):
    """Per-row reduction over CSR data: op in {'min','max','sum'}.

    Vectorized via ufunc.reduceat; empty rows get `empty`.
    """
    n = len(indptr) - 1
    out = np.full(n, empty, dtype=data.dtype if data.size else np.float64)
    nonempty = indptr[:-1] < indptr[1:]
    if not nonempty.any():
        return out
    ufunc = {"min": np.minimum, "max": np.maximum, "sum": np.add}[op]
    starts = indptr[:-1][nonempty]
    red = ufunc.reduceat(data, starts)
    out[nonempty] = red
    return out


def row_counts(indptr):
    return np.diff(indptr)


def expand_rows(indptr):
    """Row index for every CSR entry."""
    return np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))


def pmis_hash(global_ids: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic pseudo-random value in [0, 1) per global row id.

    hypre augments the PMIS measure with hypre_Rand() (sequential LCG,
    ref: src/utilities/random.c; the fixed-seed CF_init modes 7/9 exist
    to make this reproducible, ref: src/parcsr_ls/HYPRE_parcsr_ls.h:
    311-314).  A hash of the GLOBAL row id is the mesh-invariant
    equivalent: the coarsening is then identical regardless of how rows
    are sharded.  splitmix64 finalizer.
    """
    z = (global_ids.astype(np.uint64) + np.uint64(seed)) * np.uint64(
        0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)
