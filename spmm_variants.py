#!/usr/bin/env python3
"""Time design variants of K2-NV (csr_spmm) beside the committed kernel
on one GPU.

    python3 spmm_variants.py

Each variant is ``hypre_tpu_torch/csrc/csr_spmv.cu`` with a line of
K2-NV changed (VARIANTS: how many of K2's lanes one nonzero lane of
K2-NV does the work of, the blocks an SM, the walk),
built with build.py's nvcc flags into ``hypre_tpu_torch/_build/variants/``
and called through its C entry as ``ops/spmv.py`` calls the committed
one.  On the 128^3 7-pt A (LOBPCG's, chip_smoke.py ij_solvers (b)) at
nv = 4, 8, 12 and 16, f64 and f32, each variant's Y must equal the
committed kernel's bit for bit (every variant keeps K2's order of
summation), and its `kernel_ms` (chip_smoke.py's helper: torch.profiler,
median of 20 launches) is printed beside the bound (chip_smoke.py
spmm_timing's bytes).  Prints nvcc's register report and one JSON line;
exits 2 without a GPU.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# name: {text in csr_spmv.cu: its replacement}; the committed kernel
# stands for up to 4 of K2's lanes with one nonzero lane (kSlots), runs
# 4 blocks of 128 threads an SM in f64 and 5 in f32 (kMmMinBlocks) and
# keeps every SM full with a grid that walks the units, three in flight
# a thread
SLOTS = "constexpr int kSlots = 4;"
MIN_BLOCKS = "constexpr int kMmMinBlocks = sizeof(T) == 4 ? 5 : 4;"
GRID = "const int64_t blocks = need < cap ? need : cap;"
VARIANTS = {
    "kSlots 1 (K2's lanes, U 2)": {SLOTS: "constexpr int kSlots = 1;"},
    "kSlots 2 (U 4)": {SLOTS: "constexpr int kSlots = 2;"},
    "4 blocks an SM in f32": {MIN_BLOCKS: "constexpr int kMmMinBlocks = 4;"},
    "5 blocks an SM in f64": {MIN_BLOCKS: "constexpr int kMmMinBlocks = 5;"},
    "2 blocks an SM": {MIN_BLOCKS: "constexpr int kMmMinBlocks = 2;"},
    "one unit a thread (no walk)": {GRID: "const int64_t blocks = need;"},
}


def variant_source(src: str, edits: dict) -> str:
    for old, new in edits.items():
        if old not in src:
            raise RuntimeError(f"csr_spmv.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spmm_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from torch.utils.cpp_extension import CUDA_HOME

    from hypre_tpu_torch import Config, set_config
    from hypre_tpu_torch.csrc import build
    from hypre_tpu_torch.gen import laplacian
    from hypre_tpu_torch.ops.spmv import csr_from_scipy, csr_spmm

    set_config(Config(device="cuda"))
    out_dir = Path(build.BUILD_DIR) / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (Path(build.HERE) / "csr_spmv.cu").read_text()
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(variant_source(src, edits))
        procs[name] = (subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, str(cu), "-o", str(out_dir / f"v{i}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out_dir / f"v{i}.so")
    report = build.build_cuda()
    libs = {}
    ptxas = {"committed": [ln for ln in cs.ptxas_report(
        report.get("csr_spmv.cu", {}).get("log", "")) if "csr_spmm" in ln]}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{log}")
        ptxas[name] = [ln for ln in cs.ptxas_report(log)
                       if "csr_spmm" in ln]
        libs[name] = ctypes.CDLL(str(so))
    p, i64 = ctypes.c_void_p, ctypes.c_int64

    def entry(name, dtype):
        fn = getattr(libs[name], "csr_spmm_f64" if dtype == torch.float64
                     else "csr_spmm_f32")
        fn.argtypes = [i64, ctypes.c_int, ctypes.c_int, p, p, p, p, i64, p,
                       i64, p]
        fn.restype = ctypes.c_int
        return fn

    def call(fn, M, X):
        Y = torch.empty((M.n_rows, X.shape[1]), dtype=M.dtype,
                        device=X.device)
        err = fn(M.n_rows, M.group, X.shape[1], M.indptr.data_ptr(),
                 M.indices.data_ptr(), M.values.data_ptr(), X.data_ptr(),
                 X.shape[1], Y.data_ptr(), X.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA error {err}")
        return Y

    name = torch.cuda.get_device_name(0)
    peaks = cs.card_peaks(name)
    n = cs.LOBPCG_GRID
    A = laplacian(n, n, n)
    rows = []
    for dtype in (torch.float64, torch.float32):
        M = csr_from_scipy(A, dtype, torch.device("cuda"))
        for nv in (4, 8, 12, 16):
            X = torch.randn((M.n_cols, nv), dtype=dtype, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(nv))
            item = X.element_size()
            t_b, _ = cs.bound_ms(
                peaks, (M.n_rows + 1) * 8 + M.nnz * (4 + item)
                + (M.n_cols + M.n_rows) * nv * item, 2 * M.nnz * nv, dtype)
            Y = csr_spmm(M, X)
            t = cs.kernel_ms(lambda: csr_spmm(M, X), "csr_spmm_kernel")
            rows.append({"variant": "committed", "dtype": str(dtype),
                         "nv": nv, "group": M.group, "kernel_ms": t,
                         "bound_ms": t_b, "share_of_bound": t_b / t})
            for vname in VARIANTS:
                fn = entry(vname, dtype)
                same = torch.equal(call(fn, M, X), Y)
                t = cs.kernel_ms(lambda: call(fn, M, X), "csr_spmm_kernel")
                rows.append({"variant": vname, "dtype": str(dtype),
                             "nv": nv, "group": M.group, "kernel_ms": t,
                             "bound_ms": t_b, "share_of_bound": t_b / t,
                             "same_bits_as_committed": same})
                if not same:
                    raise AssertionError(f"{vname} nv={nv} {dtype}: Y "
                                         f"differs from the committed "
                                         f"kernel's")
            del X, Y
        del M
    print(json.dumps({"device": name, "ptxas": ptxas, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
