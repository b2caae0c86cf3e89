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
    return torch.dot(x, y)


def norm2(x):
    return torch.sqrt(torch.dot(x, x))


def axpy(alpha, x, y):
    """y <- alpha*x + y"""
    return alpha * x + y


def scale(alpha, x):
    return alpha * x


def copy(x):
    return x


def clear(x):
    return torch.zeros_like(x)
