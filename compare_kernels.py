#!/usr/bin/env python3
"""Time K1 (stencil_matvec), K3 (dia_matvec) and K2-NV (csr_spmm) of one
checkout of the port on one GPU, so that two checkouts can be compared
in one run.

    python3 compare_kernels.py [--root DIR] [--tag NAME]

imports ``hypre_tpu_torch`` from DIR (default: this script's directory),
builds that tree's kernels, and times them with chip_smoke.py's helpers
(from this script's directory): `ms`, the CUDA-event median of 20 calls
with the Python wrapper, and `kernel_ms`, the kernel's own device time
(torch.profiler, median of 20 back-to-back launches).  Cases: K1 at
256^3 (7-pt f64, the out.14 operator; 27-pt f64; 7-pt f32), each beside
the device time of a copy of x into y (`copy_kernel_ms`: the same bytes
moved, the practical floor of a kernel that reads x and writes y); K3 on the
100^3 7-pt operator as DIA (level 0 of the ij driver's -solver 1 run),
f64 and f32; K2-NV on the 128^3 7-pt operator as CSR (LOBPCG's A in
chip_smoke.py's ij_solvers (b)) at nv = 4, 8 and 12, f64 and f32, beside
torch.sparse.mm on the same block (`library_ms`); the wrapper's host
cost a call of K1 and K3 (1,000 calls on a 16^3 operator).  Each
kernel's result is held against its plain version (chip_smoke.py's
TOL), and its output's SHA-1 (`y_sha1`; the inputs come from fixed
seeds, so two trees whose kernels agree bit for bit print the same).
Prints one JSON line; exits 2 without a GPU.
To compare a parent with a change, unpack the parent (`git archive`)
into a directory that .gitignore lists and run parent, change, change,
parent on one card, in one command.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def wrapper_parts(D, x, calls: int = 10_000) -> dict:
    """Host µs a call of the steps a wrapper may take, each timed alone
    over `calls` calls (host clock; none waits for the card)."""
    import time

    import torch

    dev = x.device
    raw = torch._C._cuda_getCurrentRawStream
    parts = {
        "device_checks": lambda: (x.device.type == "cpu", x.is_cuda,
                                  x.device != D.vals.device),
        "tensor_checks": lambda: (x.dtype != D.dtype,
                                  x.shape != (D.n_cols,),
                                  x.is_contiguous(),
                                  D.vals.is_contiguous()),
        "torch.empty": lambda: torch.empty(D.n_rows, dtype=D.dtype,
                                           device=dev),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream": lambda: raw(dev.index),
        "data_ptr x3": lambda: (D.vals.data_ptr(), x.data_ptr(),
                                x.data_ptr()),
    }
    out = {}
    for label, fn in parts.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[label] = (time.perf_counter() - t0) / calls * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import hypre_tpu_torch

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from hypre_tpu_torch import Config, set_config
    from hypre_tpu_torch.csrc import build
    from hypre_tpu_torch.gen import laplacian
    from hypre_tpu_torch.ops.dia import (
        dia_from_scipy, dia_matvec, dia_matvec_plain,
    )
    from hypre_tpu_torch.ops.spmv import (
        csr_from_scipy, csr_spmm, csr_spmm_plain,
    )
    from hypre_tpu_torch.ops.stencil import (
        stencil_matvec, stencil_matvec_plain, stencil_op,
    )

    set_config(Config(device="cuda"))
    build.build_cuda()
    name = torch.cuda.get_device_name(0)
    peaks = cs.card_peaks(name)
    gen = torch.Generator(device="cuda").manual_seed(99)
    f64, f32 = torch.float64, torch.float32
    rows = []

    def row(kernel, case, kern, plain, op, abs_op, x, n_bytes, flops):
        """Time kern(op, x); hold it against plain first (TOL of max
        |A| |x|)."""
        y = kern(op, x)
        torch.cuda.synchronize()
        digest = hashlib.sha1(y.cpu().numpy().tobytes()).hexdigest()[:16]
        _, rel = cs.rel_err(y, plain(op, x), plain(abs_op, x.abs()))
        if not rel <= cs.TOL[x.dtype]:
            raise AssertionError(f"{kernel} {case}: rel err {rel:.3e}")
        t_ms = cs.time_ms(lambda: kern(op, x))
        t_kms = cs.kernel_ms(lambda: kern(op, x), kernel + "_")
        t_b, by = cs.bound_ms(peaks, n_bytes, flops, x.dtype)
        rows.append({"kernel": kernel, "case": case, "ms": t_ms,
                     "kernel_ms": t_kms, "bound_ms": t_b, "bound_by": by,
                     "share_of_bound": t_b / t_kms,
                     "share_of_bound_with_wrapper": t_b / t_ms,
                     "rel_err": rel, "y_sha1": digest})

    g = cs.GRID
    for ents, label, dtype in ((cs.LAPLACE_7PT, "7-pt", f64),
                               (cs.LAPLACE_27PT, "27-pt", f64),
                               (cs.LAPLACE_7PT, "7-pt", f32)):
        op = stencil_op((g, g, g), ents, dtype=dtype)
        abs_op = stencil_op((g, g, g), [(d, abs(v)) for d, v in ents],
                            dtype=dtype)
        x = torch.randn(op.n_rows, generator=gen, dtype=dtype, device="cuda")
        row("stencil_matvec", f"{g}^3 {label} {dtype}", stencil_matvec,
            stencil_matvec_plain, op, abs_op, x,
            2 * op.n_rows * x.element_size(), 2 * len(ents) * op.n_rows)
        y = torch.empty_like(x)
        rows[-1]["copy_kernel_ms"] = cs.kernel_ms(lambda: y.copy_(x),
                                                  "Memcpy DtoD")
        del op, abs_op, x, y
    n = cs.IJ_GRID
    A = laplacian(n, n, n)
    for dtype in (f64, f32):
        D = dia_from_scipy(A, dtype, torch.device("cuda"))
        x = torch.randn(D.n_cols, generator=gen, dtype=dtype, device="cuda")
        k, item = len(D.offsets), x.element_size()
        row("dia_matvec", f"{n}^3 7-pt {dtype}", dia_matvec,
            dia_matvec_plain, D, dataclasses.replace(D, vals=D.vals.abs()),
            x, (k + 2) * D.n_rows * item + k * 8, 2 * k * D.n_rows)
        del D, x
    n = cs.LOBPCG_GRID
    A = laplacian(n, n, n)
    for dtype in (f64, f32):
        M = csr_from_scipy(A, dtype, torch.device("cuda"))
        lib_M = torch.sparse_csr_tensor(
            M.indptr.to(torch.int32), M.indices, M.values, size=M.shape,
            check_invariants=False)
        for nv in (4, 8, 12):
            # a generator of its own, so the block is the same whatever
            # ran before
            X = torch.randn((M.n_cols, nv), dtype=dtype, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(nv))
            item = X.element_size()
            row("csr_spmm", f"{n}^3 7-pt nv={nv} {dtype}", csr_spmm,
                csr_spmm_plain, M,
                dataclasses.replace(M, values=M.values.abs()), X,
                (M.n_rows + 1) * 8 + M.nnz * (4 + item)
                + (M.n_cols + M.n_rows) * nv * item, 2 * M.nnz * nv)
            rows[-1]["library_ms"] = cs.time_ms(
                lambda: torch.sparse.mm(lib_M, X))
            del X
        del M, lib_M
    small = stencil_op((16, 16, 16), cs.LAPLACE_7PT, dtype=f64)
    xs = torch.randn(small.n_rows, generator=gen, dtype=f64, device="cuda")
    Ds = dia_from_scipy(laplacian(16, 16, 16), f64, torch.device("cuda"))
    wrap = {"stencil_matvec": cs.wrapper_us(
                lambda: stencil_matvec(small, xs)),
            "dia_matvec": cs.wrapper_us(lambda: dia_matvec(Ds, xs))}
    print(json.dumps({"tag": args.tag, "root": args.root,
                      "package": str(Path(hypre_tpu_torch.__file__).parent),
                      "device": name, "wrapper_us_16cubed": wrap,
                      "wrapper_parts_us": wrapper_parts(Ds, xs),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
