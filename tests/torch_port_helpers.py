"""Shared helpers of the tests of the PyTorch port (tests/test_torch_*.py).

The port imports nothing of hypre_tpu, so a reference object crosses
over as numpy arrays: ``op_dict`` turns a hypre_tpu solve-format
operator into the dict that hypre_tpu_torch.convert takes, and
``hierarchy_dicts`` does so for a whole hypre_tpu AmgHierarchy.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

LAPLACE_7PT = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
               ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
               ((0, 0, -1), -1.0), ((0, 0, 1), -1.0)]
LAPLACE_27PT = [((dx, dy, dz), 26.0 if dx == dy == dz == 0 else -1.0)
                for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)]
NATIVE_ENV = ("HYPRE_TPU_NATIVE_SETUP", "HYPRE_TPU_TORCH_NATIVE_SETUP")


def set_native(monkeypatch, on: bool) -> None:
    """Turn the OpenMP setup kernels on or off in both packages."""
    for var in NATIVE_ENV:
        monkeypatch.setenv(var, "1" if on else "0")


def op_dict(op) -> dict:
    name = type(op).__name__
    if name == "StencilOp":
        return {"kind": "stencil", "grid": op.grid, "entries": op.entries}
    if name == "GstEllMatrix":
        return {"kind": "gstell", "base": np.asarray(op.base),
                "locs": np.asarray(op.locs), "vals": np.asarray(op.vals),
                "n_rows": op.n_rows, "n_cols": op.n_cols}
    if name == "EllMatrix":
        return {"kind": "ell", "cols": np.asarray(op.cols),
                "vals": np.asarray(op.vals), "n_cols": op.n_cols}
    if name == "DiaMatrix":
        return {"kind": "dia", "offsets": op.offsets,
                "vals": np.asarray(op.vals), "n_cols": op.n_cols}
    if name == "DenseMatrix":
        return {"kind": "dense", "vals": np.asarray(op.vals),
                "n_rows": op.n_rows, "n_cols": op.n_cols}
    raise TypeError(name)


def hierarchy_dicts(h) -> list[dict]:
    """The levels of a hypre_tpu AmgHierarchy as convert's dicts."""
    out = []
    for lvl in h.levels:
        out.append({
            "A": op_dict(lvl.A),
            "P": None if lvl.P is None else op_dict(lvl.P),
            "R": None if lvl.R is None else op_dict(lvl.R),
            "dinv": None if lvl.dinv is None else np.asarray(lvl.dinv)})
    return out


def assert_csr_equal(a, b) -> None:
    """Bit-for-bit equality of two scipy CSR matrices."""
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def rel_diff(x, y) -> float:
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))
