"""Multivector operations.

Counterpart of hypre_tpu/ops/multivector.py, the analog of the
mv_MultiVector interpreter vtable (ref: src/multivector/interpreter.h:
13-54: MultiInnerProd, MultiVecMat, MultiAxpy, masked variants).  A
multivector is an (n, m) tensor; every entry is a one-line torch
expression, so LOBPCG-style consumers have the surface the reference
exposes.
"""
from __future__ import annotations

import torch


def multi_inner_prod(X, Y):
    """Gram block X^T Y (MultiInnerProd)."""
    return X.T @ Y


def multi_inner_prod_diag(X, Y):
    """Columnwise dots diag(X^T Y) (MultiInnerProdDiag)."""
    return torch.sum(X * Y, dim=0)


def multi_vec_mat(X, G):
    """Y = X G (MatMultiVec)."""
    return X @ G


def multi_axpy(alpha, X, Y):
    return alpha * X + Y


def multi_scale(alpha_per_col, X):
    return X * alpha_per_col[None, :]


def multi_clear(X):
    return torch.zeros_like(X)
