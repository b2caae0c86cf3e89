"""IJ assembly interface — linear-algebraic matrix/vector construction.

The port's numpy copy of hypre_tpu/ij.py (``IJMatrix`` :22,
``IJVector`` :126); ``to_sparse_op`` packs into the port's formats.

Analog of hypre's IJ layer (ref: src/IJ_mv/HYPRE_IJMatrix.c,
IJMatrix_parcsr.c:91 SetValues / assemble ~:91-152; device COO-stack
IJMatrix_parcsr_device.c:104-130).  The user API is the same shape:

    ij = IJMatrix(0, n-1, 0, n-1)
    ij.set_values(rows, cols, values)     # or add_to_values
    A = ij.assemble()                     # -> scipy CSR (host setup
                                          #    format)
    op = ij.to_sparse_op()                # -> the solve format

Like the reference's device path, set/add calls append to a COO stack;
assemble sorts and reduces it (last-set-wins for set, sum for add —
ref: aux_parcsr_matrix.h sora flag semantics).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class IJMatrix:
    def __init__(self, ilower: int, iupper: int, jlower: int, jupper: int):
        self.ilower, self.iupper = ilower, iupper
        self.jlower, self.jupper = jlower, jupper
        self._rows = []
        self._cols = []
        self._vals = []
        self._mode = []   # 1 = add, 0 = set
        self._assembled = None

    @property
    def shape(self):
        return (self.iupper - self.ilower + 1,
                self.jupper - self.jlower + 1)

    def set_values(self, rows, cols, values):
        """Insert entries; a later set to the same (i,j) wins."""
        self._push(rows, cols, values, 0)

    def add_to_values(self, rows, cols, values):
        """Accumulate entries (FEM-style assembly)."""
        self._push(rows, cols, values, 1)

    def _push(self, rows, cols, values, mode):
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        values = np.atleast_1d(np.asarray(values, dtype=np.float64))
        rows, cols, values = np.broadcast_arrays(rows, cols, values)
        if (rows < self.ilower).any() or (rows > self.iupper).any():
            from hypre_tpu_torch.core.errors import ArgumentError
            raise ArgumentError("row index out of this IJMatrix's range")
        self._rows.append(rows.ravel())
        self._cols.append(cols.ravel())
        self._vals.append(values.ravel())
        self._mode.append(np.full(rows.size, mode, dtype=np.int8))
        self._assembled = None

    def assemble(self) -> sp.csr_matrix:
        """Sort + reduce the COO stack (the device-assemble algorithm:
        stable-sort by (row, col, stack position), then per-duplicate
        group: value = sum of adds after the last set)."""
        if not self._rows:
            return sp.csr_matrix(self.shape)
        rows = np.concatenate(self._rows) - self.ilower
        cols = np.concatenate(self._cols) - self.jlower
        vals = np.concatenate(self._vals)
        mode = np.concatenate(self._mode)
        order = np.lexsort((np.arange(len(rows)), cols, rows))
        r, c, v, m = rows[order], cols[order], vals[order], mode[order]

        key = r * np.int64(self.shape[1]) + c
        grp_start = np.concatenate([[True], key[1:] != key[:-1]])
        gid = np.cumsum(grp_start) - 1
        n_grp = gid[-1] + 1

        # last "set" position within each group
        pos = np.arange(len(key))
        set_pos = np.where(m == 0, pos, -1)
        last_set = np.full(n_grp, -1, dtype=np.int64)
        np.maximum.at(last_set, gid, set_pos)  # small stacks: fine
        keep = pos >= last_set[gid]
        # value: (set value if any) + adds after it
        out = np.bincount(gid[keep], v[keep], minlength=n_grp)

        gr = r[grp_start]
        gc = c[grp_start]
        A = sp.coo_matrix((out, (gr, gc)), shape=self.shape).tocsr()
        A.sort_indices()
        self._assembled = A
        return A

    def to_sparse_op(self, **kw):
        from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

        A = self._assembled if self._assembled is not None else \
            self.assemble()
        return sparse_op_from_scipy(A, **kw)

    # -- I/O (checkpoint analog: HYPRE_IJMatrixPrint/Read) -----------

    def print_to(self, path: str):
        A = self.assemble().tocoo()
        with open(path, "w") as f:
            f.write(f"{self.ilower} {self.iupper} "
                    f"{self.jlower} {self.jupper}\n")
            for i, j, v in zip(A.row, A.col, A.data):
                f.write(f"{i + self.ilower} {j + self.jlower} {v:.15e}\n")

    @staticmethod
    def read_from(path: str) -> "IJMatrix":
        with open(path) as f:
            il, iu, jl, ju = map(int, f.readline().split())
            ij = IJMatrix(il, iu, jl, ju)
            rows, cols, vals = [], [], []
            for line in f:
                a, b, c = line.split()
                rows.append(int(a))
                cols.append(int(b))
                vals.append(float(c))
        if rows:
            ij.set_values(np.array(rows), np.array(cols), np.array(vals))
        return ij


class IJVector:
    def __init__(self, jlower: int, jupper: int):
        self.jlower, self.jupper = jlower, jupper
        self.n = jupper - jlower + 1
        self._data = np.zeros(self.n)

    def set_values(self, indices, values):
        self._data[np.asarray(indices) - self.jlower] = values

    def add_to_values(self, indices, values):
        np.add.at(self._data, np.asarray(indices) - self.jlower, values)

    def assemble(self) -> np.ndarray:
        return self._data.copy()

    def print_to(self, path: str):
        with open(path, "w") as f:
            f.write(f"{self.jlower} {self.jupper}\n")
            for i, v in enumerate(self._data):
                f.write(f"{i + self.jlower} {v:.15e}\n")

    @staticmethod
    def read_from(path: str) -> "IJVector":
        with open(path) as f:
            jl, ju = map(int, f.readline().split())
            vec = IJVector(jl, ju)
            for line in f:
                a, b = line.split()
                vec._data[int(a) - jl] = float(b)
        return vec
