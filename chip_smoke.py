#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hypre_tpu_torch) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name; nvidia-smi's name and power limit.
2. build   — the CUDA kernels (nvcc, one process per source, started
             together) and the host OpenMP setup library (g++); fails
             unless native setup is on.
3. kernel_checks (synthetic) — K1 stencil_matvec and K2 csr_spmv against
             their plain PyTorch versions on the card, f32 and f64: K1 on
             7-pt and 27-pt stencils over odd grids and 256^3, K2 on
             random CSR at every thread-group size.
4. main_path — hypre's out.14 problem through the port's entry points:
             laplacian, BoomerAMG(AmgConfig(interp_type=6, relax_type=18))
             .setup(A, fine_stencil=...), one warm-up and three timed
             pcg(tol=1e-8) solves in f64 with b on the card.  Launch
             counts are zeroed just before and read just after.  Fails
             unless the level sizes and operator complexity match the
             reference's and the true relative residual is <= 1e-8.
5. kernel_checks (hierarchy) — K2 on the hierarchy's own operators
             (levels 1-4 A, P0, R0), f32 and f64.
6. kernel_timing — each kernel on its 256^3 operators: CUDA-event
             median of 20 launches, beside its plain version, one PyTorch
             library call computing the same function, and the bound
             (bytes moved over the card's memory rate).
7. profile — one more solve under torch.profiler: device time by kernel
             and by kind, and the device's busy share of the wall time.
8. small_input — the port at 24^3 on the card against the port's CPU
             path (the plain versions, held against hypre_tpu by the
             tests): same PCG iterations, x to rel 1e-10.

Then the kernels line, nvidia-smi's line, and the last line
{"ok": true, "device": {...}}.  Any failed check raises: nothing is
caught and carried on.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.csrc import build
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops.formats import CsrMatrix
from hypre_tpu_torch.ops.spmv import (
    csr_from_scipy, csr_spmv, csr_spmv_plain,
)
from hypre_tpu_torch.ops.stencil import (
    stencil_matvec, stencil_matvec_plain, stencil_op,
)
from hypre_tpu_torch.setup.utils import native_enabled
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg

LAPLACE_7PT = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
               ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
               ((0, 0, -1), -1.0), ((0, 0, 1), -1.0)]
LAPLACE_27PT = [((dx, dy, dz), 26.0 if dx == dy == dz == 0 else -1.0)
                for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)]
GRID = 256        # out.14: -n 256 256 256 (BASELINE.md:20), not cut
# BENCH_r05.json:19-31, the reference's host setup at 256^3
REF_LEVELS = [16777216, 5156632, 684520, 71646, 8141, 969, 183, 27, 5]
REF_OPERATOR_COMPLEXITY = 2.775
# tolerance of a kernel against its plain version: max |kernel - plain|
# over max(|A| |x|), the size of the terms summed (order of summation
# and FMA contraction differ between the two)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
F64 = torch.float64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str) -> dict:
    """Published peaks (NVIDIA data sheets) of the card's variant:
    memory bytes/s and non-tensor-core f64 and f32 FLOP/s."""
    if "H200" in name:
        return {"variant": "H200 SXM", "bytes_s": 4.8e12,
                "f64": 34e12, "f32": 67e12}
    if "PCIe" in name:
        return {"variant": "H100 PCIe", "bytes_s": 2.0e12,
                "f64": 26e12, "f32": 51e12}
    if "NVL" in name:
        return {"variant": "H100 NVL", "bytes_s": 3.9e12,
                "f64": 30e12, "f32": 60e12}
    return {"variant": "H100 SXM", "bytes_s": 3.35e12,
            "f64": 34e12, "f32": 67e12}


def bound_ms(peaks, n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / peaks["bytes_s"] * 1e3
    t_ops = flops / peaks["f64" if dtype == F64 else "f32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def reset_counts() -> None:
    stencil_matvec.launches = 0
    csr_spmv.launches = 0


def rel_err(y, y_ref, scale) -> tuple[float, float]:
    err = float((y - y_ref).abs().max())
    return err, err / max(float(scale.abs().max()), 1e-300)


def check_stencil(op, x) -> dict:
    y = stencil_matvec(op, x)
    torch.cuda.synchronize()
    y_ref = stencil_matvec_plain(op, x)
    scale = stencil_matvec_plain(
        dataclasses.replace(op, entries=tuple(
            (d, abs(v)) for d, v in op.entries)), x.abs())
    err, rel = rel_err(y, y_ref, scale)
    ok = rel <= TOL[op.dtype] and bool(torch.isfinite(y).all())
    if not ok:
        raise AssertionError(f"stencil_matvec {op.grid} {op.dtype}: "
                             f"rel err {rel:.3e} > {TOL[op.dtype]:g}")
    return {"grid": list(op.grid), "entries": len(op.entries),
            "dtype": str(op.dtype), "max_abs_err": err, "rel_err": rel}


def check_csr(A: CsrMatrix, x, label: str) -> dict:
    y = csr_spmv(A, x)
    torch.cuda.synchronize()
    y_ref = csr_spmv_plain(A, x)
    scale = csr_spmv_plain(dataclasses.replace(A, values=A.values.abs()),
                           x.abs())
    err, rel = rel_err(y, y_ref, scale)
    if not (rel <= TOL[A.dtype] and bool(torch.isfinite(y).all())):
        raise AssertionError(f"csr_spmv {label} {A.dtype}: rel err "
                             f"{rel:.3e} > {TOL[A.dtype]:g}")
    return {"op": label, "shape": list(A.shape), "nnz": A.nnz,
            "group": A.group, "dtype": str(A.dtype), "max_abs_err": err,
            "rel_err": rel}


def random_csr(n_rows, n_cols, max_row, band, rng):
    import scipy.sparse as sp

    counts = rng.integers(0, max_row + 1, size=n_rows)
    rows = np.repeat(np.arange(n_rows), counts)
    center = (rows * (n_cols / n_rows)).astype(np.int64)
    cols = np.clip(center + rng.integers(-band, band + 1, size=len(rows)),
                   0, n_cols - 1)
    vals = rng.standard_normal(len(rows))
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
    A.sum_duplicates()
    return A


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    peaks = card_peaks(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_used": peaks})
    return {"name": name, "smi": smi, "peaks": peaks}


def phase_build() -> None:
    t0 = time.perf_counter()
    report = build.build_cuda()
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.load()
    t_host = time.perf_counter() - t0
    native = native_enabled()
    ptxas = [ln.strip() for src in report.values()
             for ln in src["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "cuda_s": {s: r["seconds"]
                                       for s, r in report.items()},
          "cuda_total_s": t_cuda, "host_setup_kernels_s": t_host,
          "native_setup": native, "ptxas": ptxas[:16]})
    if not native:
        raise AssertionError("native setup did not run")


def phase_synthetic_checks(gen) -> None:
    dev = torch.device("cuda")
    results = []
    for dtype in (torch.float64, torch.float32):
        for grid in ((13, 9, 7), (31, 17, 5), (1, 1, 33), (256, 256, 256)):
            for ents in (LAPLACE_7PT, LAPLACE_27PT):
                op = stencil_op(grid, ents, dtype=dtype)
                x = torch.randn(op.n_rows, generator=gen, dtype=dtype,
                                device=dev)
                results.append(check_stencil(op, x))
        rng = np.random.default_rng(7)
        A = random_csr(100_003, 90_001, 70, 600, rng)
        base = csr_from_scipy(A, dtype, dev)
        x = torch.randn(A.shape[1], generator=gen, dtype=dtype, device=dev)
        for g in (2, 4, 8, 16, 32):
            results.append(check_csr(dataclasses.replace(base, group=g), x,
                                     f"random G={g}"))
        torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "set": "synthetic",
          "kernel_names": ["stencil_matvec", "csr_spmv"],
          "n_checks": len(results),
          "worst_rel_err": max(r["rel_err"] for r in results),
          "checks": results})


def phase_main_path() -> dict:
    set_config(Config(real_dtype=F64, device="cuda"))
    n = GRID
    t0 = time.perf_counter()
    A = laplacian(n, n, n)
    gen_s = time.perf_counter() - t0
    # print_level=1: per-level host-build and upload times on stderr
    cfg = AmgConfig(interp_type=6, relax_type=18, print_level=1)
    reset_counts()
    t0 = time.perf_counter()
    amg = BoomerAMG(cfg).setup(A, fine_stencil=((n, n, n), LAPLACE_7PT))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    op = amg.hierarchy.levels[0].A
    b = torch.ones(n ** 3, dtype=F64, device="cuda")
    warm = pcg(op, b, M=amg, tol=1e-8, max_iter=100)
    iters = [warm.iters]
    times, results = [], []
    for t in range(3):
        bt = b * (1.0 + 0.0137 * (t + 1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = pcg(op, bt, M=amg, tol=1e-8, max_iter=100)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        iters.append(res.iters)
        results.append((bt, res))
    launches = {"stencil_matvec": stencil_matvec.launches,
                "csr_spmv": csr_spmv.launches}
    bt, res = results[-1]
    x = res.x
    r_true = bt - stencil_matvec_plain(op, x)
    true_relres = float(torch.linalg.vector_norm(r_true)
                        / torch.linalg.vector_norm(bt))
    solve_s = statistics.median(times)
    out = {
        "phase": "main_path", "grid": [n, n, n],
        "dtype": "float64", "levels": amg.level_sizes,
        "operator_complexity": round(amg.operator_complexity, 3),
        "operator_complexity_raw": amg.operator_complexity,
        "level_formats": amg.level_formats, "iters": res.iters,
        "iters_all_solves": iters, "relres": res.relres,
        "true_relres": true_relres, "gen_s": gen_s, "setup_s": setup_s,
        "solve_s": solve_s, "solve_times_s": times,
        "per_iter_ms": solve_s / max(res.iters, 1) * 1e3,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "v100_reference": {"setup_s": 0.706, "solve_s": 0.580,
                           "iters": 20},
    }
    emit(out)
    if not bool(torch.isfinite(x).all()) or x.shape != (n ** 3,):
        raise AssertionError("solution is not finite or has a wrong shape")
    if true_relres > 1e-8:
        raise AssertionError(f"true relative residual {true_relres:.3e}")
    if amg.level_sizes != REF_LEVELS or round(
            amg.operator_complexity, 3) != REF_OPERATOR_COMPLEXITY:
        raise AssertionError("hierarchy differs from the reference's")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return {"amg": amg, "op": op, "launches": launches, "out": out}


def hierarchy_ops(amg) -> list[tuple[str, CsrMatrix]]:
    ops = []
    for l, lvl in enumerate(amg.hierarchy.levels):
        for name in ("A", "P", "R"):
            m = getattr(lvl, name)
            if isinstance(m, CsrMatrix):
                ops.append((f"{name}{l}", m))
    return ops


def phase_hierarchy_checks(amg, gen) -> float:
    results = []
    for label, A in hierarchy_ops(amg):
        for dtype in (torch.float64, torch.float32):
            Ad = A if dtype == A.dtype else A.to(dtype)
            x = torch.randn(A.n_cols, generator=gen, dtype=dtype,
                            device="cuda")
            results.append(check_csr(Ad, x, label))
            del Ad
    torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "set": "hierarchy",
          "kernel_names": ["csr_spmv"], "n_checks": len(results),
          "checks": results})
    return max(r["max_abs_err"] for r in results
               if r["dtype"] == str(torch.float64))


def launches_per_iter(amg, op) -> dict:
    """Kernel launches of one PCG iteration: one A·p plus one V-cycle."""
    r = torch.ones(op.n_rows, dtype=F64, device="cuda")
    reset_counts()
    amg.precondition(r)
    stencil_matvec(op, r)
    torch.cuda.synchronize()
    out = {"stencil_matvec": stencil_matvec.launches,
           "csr_spmv": csr_spmv.launches}
    reset_counts()
    return out


def phase_timing(amg, op, peaks, gen) -> dict:
    per_iter = launches_per_iter(amg, op)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = op.n_rows
    x = torch.randn(n, generator=gen, dtype=F64, device="cuda")
    # K1 at the main path's shape
    k1_ms = time_ms(lambda: stencil_matvec(op, x))
    k1_plain = time_ms(lambda: stencil_matvec_plain(op, x))
    w = torch.zeros((1, 1, 3, 3, 3), dtype=F64, device="cuda")
    for (dx, dy, dz), v in op.entries:
        w[0, 0, dz + 1, dy + 1, dx + 1] = v
    nx, ny, nz = op.grid
    x5 = x.reshape(1, 1, nz, ny, nx)
    conv = torch.nn.functional.conv3d
    y_conv = conv(x5, w, padding=1).reshape(-1)
    conv_err = float((y_conv - stencil_matvec(op, x)).abs().max())
    k1_lib = time_ms(lambda: conv(x5, w, padding=1))
    k1_bound, k1_by = bound_ms(peaks, 2 * n * 8, 2 * len(op.entries) * n,
                               F64)
    reset_counts()
    k1 = {"ms": k1_ms, "plain_ms": k1_plain, "library_ms": k1_lib,
          "library": "torch.nn.functional.conv3d (3x3x3, zero padding)",
          "library_max_abs_diff": conv_err, "bound_ms": k1_bound,
          "bound_by": k1_by, "per_pcg_iter": per_iter["stencil_matvec"]}
    # K2 on every CSR operator of one V-cycle: A twice, P and R once
    ops = []
    for label, A in hierarchy_ops(amg):
        per_cycle = 2 if label.startswith("A") else 1
        xa = torch.randn(A.n_cols, generator=gen, dtype=F64, device="cuda")
        crow = A.indptr.to(torch.int32)
        lib_A = torch.sparse_csr_tensor(crow, A.indices, A.values,
                                        size=A.shape, check_invariants=False)
        xa2 = xa.unsqueeze(1)
        lib_err = float((torch.sparse.mm(lib_A, xa2)[:, 0]
                         - csr_spmv(A, xa)).abs().max())
        t_k = time_ms(lambda: csr_spmv(A, xa))
        t_p = time_ms(lambda: csr_spmv_plain(A, xa))
        t_l = time_ms(lambda: torch.sparse.mm(lib_A, xa2))
        n_bytes = ((A.n_rows + 1) * 8 + A.nnz * (4 + 8)
                   + A.n_cols * 8 + A.n_rows * 8)
        t_b, by = bound_ms(peaks, n_bytes, 2 * A.nnz, F64)
        ops.append({"op": label, "shape": list(A.shape), "nnz": A.nnz,
                    "group": A.group, "per_cycle": per_cycle, "ms": t_k,
                    "plain_ms": t_p, "library_ms": t_l,
                    "library_max_abs_diff": lib_err, "bound_ms": t_b,
                    "bound_by": by})
        del lib_A, crow
    reset_counts()

    def cycle_sum(key):
        return sum(o[key] * o["per_cycle"] for o in ops)

    k2 = {"ms": cycle_sum("ms"), "plain_ms": cycle_sum("plain_ms"),
          "library_ms": cycle_sum("library_ms"),
          "library": "torch.sparse.mm on a sparse_csr tensor",
          "bound_ms": cycle_sum("bound_ms"),
          "bound_by": ("bytes" if all(o["bound_by"] == "bytes" for o in ops)
                       else "operations"),
          "per_pcg_iter": per_iter["csr_spmv"],
          "note": "sums over the CSR launches of one V-cycle"}
    emit({"phase": "kernel_timing", "dtype": "float64",
          "stencil_matvec": k1, "csr_spmv": k2, "csr_spmv_ops": ops})
    return {"stencil_matvec": k1, "csr_spmv": k2}


def _kind(name: str) -> str:
    if "stencil_matvec_kernel" in name:
        return "K1 stencil_matvec"
    if "csr_spmv_kernel" in name:
        return "K2 csr_spmv"
    if "gemv" in name or "gemm" in name or "getrs" in name \
            or "trsm" in name or "laswp" in name:
        return "dense (torch.mv, lu_solve)"
    if "reduce" in name.lower() or "dot" in name.lower():
        return "reductions (dot, norm)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    return "elementwise"


def phase_profile(amg, op) -> None:
    """One solve under torch.profiler: device time by kernel and kind,
    and the device's busy share of the (profiled) wall time."""
    from torch.profiler import ProfilerActivity, profile

    b = torch.ones(op.n_rows, dtype=F64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = pcg(op, b, M=amg, tol=1e-8, max_iter=100)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            rows.append({"kernel": evt.key[:90], "ms": us / 1e3,
                         "count": evt.count, "kind": _kind(evt.key)})
    rows.sort(key=lambda r: -r["ms"])
    by_kind = {}
    for r in rows:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["ms"]
    busy = sum(r["ms"] for r in rows)
    emit({"phase": "profile", "iters": res.iters, "wall_ms": wall_ms,
          "device_busy_ms": busy,
          "device_busy_share": busy / wall_ms if wall_ms else None,
          "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
          "top": rows[:12]})


def phase_small_input() -> None:
    n = 24
    out = {}
    for device in ("cuda", "cpu"):
        set_config(Config(real_dtype=F64, device=device))
        A = laplacian(n, n, n)
        amg = BoomerAMG(AmgConfig(interp_type=6, relax_type=18)).setup(
            A, fine_stencil=((n, n, n), LAPLACE_7PT))
        res = pcg(amg.hierarchy.levels[0].A, np.ones(n ** 3), M=amg,
                  tol=1e-8)
        out[device] = (res.iters, res.x.cpu())
    set_config(Config(real_dtype=F64, device="cuda"))
    (it_g, x_g), (it_c, x_c) = out["cuda"], out["cpu"]
    rel = float(torch.linalg.vector_norm(x_g - x_c)
                / torch.linalg.vector_norm(x_c))
    emit({"phase": "small_input", "grid": [n, n, n], "iters_cuda": it_g,
          "iters_cpu": it_c, "x_rel_diff": rel})
    if it_g != it_c or not rel <= 1e-10:
        raise AssertionError("card and CPU paths disagree at 24^3")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    card = phase_device()
    phase_build()
    phase_synthetic_checks(gen)
    main_path = phase_main_path()
    k2_err = phase_hierarchy_checks(main_path["amg"], gen)
    timing = phase_timing(main_path["amg"], main_path["op"], card["peaks"],
                          gen)
    op = main_path["op"]
    x = torch.randn(op.n_rows, generator=gen, dtype=F64, device="cuda")
    k1_err = check_stencil(op, x)["max_abs_err"]
    phase_profile(main_path["amg"], op)
    phase_small_input()
    kernels = []
    for name, route_src, replaces, err in (
            ("stencil_matvec", "hypre_tpu_torch/csrc/stencil_matvec.cu",
             "hypre_tpu/ops/stencil_pallas.py:123", k1_err),
            ("csr_spmv", "hypre_tpu_torch/csrc/csr_spmv.cu",
             "hypre_tpu/ops/gstell.py:719", k2_err)):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": main_path["launches"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "launches_per_pcg_iter": t["per_pcg_iter"]})
    emit({"kernels": kernels})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(card["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
