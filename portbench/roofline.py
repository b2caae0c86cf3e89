"""The yardstick of the kernels: the bytes each launch must move, the
card's published peaks, and a kernel's share of its bytes bound.

A launch's bound counts each input once and each output once: for K1
(``stencil_matvec``) x, y and the stencil's entries; for K2
(``csr_spmv``) the row pointers, column indices and values, the
entries of x that some row references, and y.  Both kernels are
bytes-bound (a K2 launch does 2 nnz operations on 12-16 nnz bytes).
"""
from __future__ import annotations

import torch

# Published memory bandwidth (bytes/s) of NVIDIA's data sheet, by the
# name torch.cuda.get_device_name() gives, at the full power limit: the
# H100 SXM (80GB HBM3) the cells run on.  Another card has no entry,
# and its rooflines are not read.
PEAK_BYTES_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

_TYPE = {torch.float64: "double", torch.float32: "float"}


def peak_bytes_s(device_name: str) -> float | None:
    return PEAK_BYTES_S.get(device_name)


def describe(op) -> dict | None:
    """The kernel an operator of the program runs on, its thread count
    a launch (None where one operator is all the kernel serves) and the
    bytes bound of one launch; None for an operator no declared kernel
    serves (dense levels)."""
    cls = type(op).__name__
    if cls == "StencilOp":
        item = torch.empty((), dtype=op.dtype).element_size()
        k = len(op.entries)
        return {"kernel": "stencil_matvec", "type_name": _TYPE[op.dtype],
                "threads": None,
                "bytes": 2 * op.n_rows * item + k * (3 * 4 + item)}
    if cls == "CsrMatrix":
        item = op.values.element_size()
        ref_cols = int(torch.unique(op.indices).numel()) if op.nnz else 0
        return {"kernel": "csr_spmv", "type_name": _TYPE[op.dtype],
                "threads": op.n_rows * op.group,
                "bytes": (op.n_rows + 1) * op.indptr.element_size()
                + op.nnz * (op.indices.element_size() + item)
                + (ref_cols + op.n_rows) * item}
    return None


def kernel_share(ctx: dict, kernel: str):
    """The kernel's share (%) of its bytes bound over the window: for
    each operator it serves, the launches the counters counted in the
    window (shared out as the traced launches are), times the mean
    device time of its traced launches, against the same launches'
    bytes over the card's bandwidth.  None where the trace holds too
    few launches of some operator, the window counted none, or the card
    has no published bandwidth here."""
    prof = ctx.get("profile")
    if prof is None:
        return None
    served = [s for s in prof["served"] if s["kernel"] == kernel]
    need = ctx["traffic"]["trace"]["min_launches_per_op"]
    traced = {s["key"]: prof["ops"].get(s["key"], {"traced": 0, "us": 0.0})
              for s in served}
    if not served or any(t["traced"] < need for t in traced.values()):
        return None
    counted = ctx["counts"][kernel]
    total = sum(t["traced"] for t in traced.values())
    if counted <= 0 or total <= 0:
        return None
    bw = peak_bytes_s(torch.cuda.get_device_name(ctx["device"]))
    if bw is None:
        return None
    bound_s = dev_s = 0.0
    for s in served:
        t = traced[s["key"]]
        n = counted * t["traced"] / total
        bound_s += n * s["bytes"] / bw
        dev_s += n * t["us"] / t["traced"] / 1e6
    return 100.0 * bound_s / dev_s
