"""Dense vector kernels.

Counterpart of hypre_tpu/ops/vector.py, the analog of hypre's seq_mv
vector ops (ref: src/seq_mv/vector.c, e.g. hypre_SeqVectorInnerProd at
vector.c:1070).  Each is one torch expression; they exist as named
functions so the Krylov layer (ref: src/krylov/pcg.h:49-70) has explicit
counterparts.
"""
from __future__ import annotations

import torch


def dot(x, y):
    """Inner product over every entry, as jnp.vdot: a (nz, ny, nx) grid
    vector is flattened (torch.dot takes 1-D tensors only)."""
    return torch.dot(x.reshape(-1), y.reshape(-1))


def norm2(x):
    return torch.sqrt(dot(x, x))


def axpy(alpha, x, y):
    """y <- alpha*x + y"""
    return alpha * x + y


def scale(alpha, x):
    return alpha * x


def copy(x):
    return x


def clear(x):
    return torch.zeros_like(x)
