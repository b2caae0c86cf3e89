"""Matrix Market I/O (ref: src/utilities/mmio.c, matrix_matrix.c).

The port's numpy copy of hypre_tpu/mmio.py.

Reads/writes the MatrixMarket exchange format the reference's
utilities layer supports: `matrix coordinate real|integer|pattern
general|symmetric` and `matrix array real general` (dense vectors /
multivectors).  1-based indices on disk, 0-based in memory, like the
reference's readers.

scipy has its own mmread; this implementation exists so the framework
has no scipy-io dependency in the I/O path and matches the reference's
semantics for symmetric expansion and pattern matrices.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def mm_read(path):
    """Read a MatrixMarket file.

    Returns a scipy CSR matrix for coordinate files (symmetric storage
    expanded, like hypre_MatrixMarketRead), or a numpy array for array
    files (column-major fill per the MM spec)."""
    with open(path) as f:
        header = f.readline().split()
        if len(header) < 5 or header[0] != "%%MatrixMarket" \
                or header[1].lower() != "matrix":
            raise ValueError(f"{path}: not a MatrixMarket matrix file")
        fmt, field, symm = (header[2].lower(), header[3].lower(),
                            header[4].lower())
        if fmt not in ("coordinate", "array"):
            raise ValueError(f"{path}: unsupported format {fmt}")
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path}: unsupported field {field}")
        if symm not in ("general", "symmetric"):
            raise ValueError(f"{path}: unsupported symmetry {symm}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        if fmt == "array":
            nr, nc = int(dims[0]), int(dims[1])
            data = np.loadtxt(f, dtype=np.float64, max_rows=nr * nc)
            a = np.asarray(data, np.float64).reshape(nc, nr).T
            if symm == "symmetric":
                raise ValueError(f"{path}: symmetric array unsupported")
            return a if nc > 1 else a[:, 0]
        nr, nc, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        raw = np.loadtxt(f, ndmin=2, max_rows=nnz) if nnz else \
            np.zeros((0, 3))
        rows = raw[:, 0].astype(np.int64) - 1
        cols = raw[:, 1].astype(np.int64) - 1
        if field == "pattern":
            vals = np.ones(len(rows), np.float64)
        else:
            vals = raw[:, 2].astype(np.float64)
        if symm == "symmetric":
            off = rows != cols
            rows = np.concatenate([rows, cols[off]])
            cols = np.concatenate([cols, raw[:, 0].astype(np.int64)[off]
                                   - 1])
            vals = np.concatenate([vals, vals[off]])
        A = sp.csr_matrix((vals, (rows, cols)), shape=(nr, nc))
        A.sum_duplicates()
        A.sort_indices()
        return A


def mm_write(path, A, symmetric: bool = False):
    """Write a matrix/vector in MatrixMarket format.

    scipy sparse -> coordinate real; numpy 1D/2D -> array real.
    symmetric=True stores only the lower triangle (caller asserts the
    matrix is symmetric, matching hypre_MatrixMarketWrite)."""
    if sp.issparse(A):
        A = A.tocoo()
        symm = "symmetric" if symmetric else "general"
        with open(path, "w") as f:
            f.write(f"%%MatrixMarket matrix coordinate real {symm}\n")
            r, c, v = A.row, A.col, A.data
            if symmetric:
                keep = r >= c
                r, c, v = r[keep], c[keep], v[keep]
            f.write(f"{A.shape[0]} {A.shape[1]} {len(v)}\n")
            for i, j, x in zip(r, c, v):
                f.write(f"{i + 1} {j + 1} {x:.17g}\n")
        return
    a = np.atleast_2d(np.asarray(A, np.float64))
    if a.shape[0] == 1 and np.ndim(A) == 1:
        a = a.T
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix array real general\n")
        f.write(f"{a.shape[0]} {a.shape[1]}\n")
        for j in range(a.shape[1]):
            for i in range(a.shape[0]):
                f.write(f"{a[i, j]:.17g}\n")
