"""Build and load the port's native code.

Two kinds of native code live in this directory, both compiled at first
use into ``hypre_tpu_torch/_build/`` (listed in ``.gitignore``) and
loaded with ctypes:

* ``setup_kernels.cpp`` — host OpenMP C++ for the setup phase's graph
  algorithms, built with g++.  Every function has a vectorized-numpy
  twin in ``hypre_tpu_torch/setup/``.
* ``*.cu`` — the hand-written Hopper kernels (the solve phase's matvecs
  and the device setup's gather), built
  with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into one shared
  library per source, each with a plain C interface (pointers and the
  stream passed as ``void*``; every entry returns ``cudaGetLastError()``
  after its launch).  They build only where the CUDA toolkit is.

A build writes to a per-process temporary name and renames it into
place, so concurrent test workers never load a half-written library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
CUDA_SOURCES = ("stencil_matvec.cu", "csr_spmv.cu", "dia_matvec.cu",
                "btake.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
_cuda_libs: dict[str, ctypes.CDLL] = {}

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _stale(so: str, src: str) -> bool:
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src))


def _compile(cmd: list[str], so: str) -> subprocess.Popen:
    """Start one compiler process writing to a temporary name."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    return subprocess.Popen(cmd + ["-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, so: str) -> str:
    """Wait for a compiler process; install its output or raise."""
    out, _ = proc.communicate()
    tmp = f"{so}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"build of {os.path.basename(so)} failed "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)
    return out


def load():
    """The host setup library (g++ -O3 -fopenmp), built on demand."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = os.path.join(HERE, "setup_kernels.cpp")
        so = os.path.join(BUILD_DIR, "libsetup_kernels.so")
        if _stale(so, src):
            _finish(_compile(["g++", "-O3", "-march=native", "-fopenmp",
                              "-shared", "-fPIC", "-std=c++17", src], so),
                    so)
        lib = ctypes.CDLL(so)
        lib.rs_first_pass.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _i64p, _i32p, _i32p]
        lib.strength_mask.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _f64p,
            ctypes.c_double, ctypes.c_double, ctypes.c_int32, _u8p]
        lib.pmis.argtypes = [ctypes.c_int64, _i64p, _i32p, _f64p, _i32p]
        lib.cljp.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _f64p, _i32p, ctypes.c_int32]
        lib.rs_second_pass.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _i32p]
        lib.direct_interp.argtypes = [
            ctypes.c_int64, ctypes.c_int32, _i64p, _i32p, _f64p, _u8p,
            _i32p, _i32p, _i64p, _i32p, _f64p]
        lib.extpi_interp.argtypes = [
            ctypes.c_int64, ctypes.c_int32, _i64p, _i32p, _f64p, _u8p,
            _i32p, _i32p, _f64p, _i64p, _i32p, _f64p]
        lib.lr_interp.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _i64p, _i32p, _f64p, _u8p,
            _i32p, _i32p, _f64p, _i64p, _i32p, _f64p]
        lib.truncate_interp.argtypes = [
            ctypes.c_int64, ctypes.c_int32, _i64p, _i32p, _f64p,
            ctypes.c_double, ctypes.c_int64, _i64p, _i32p, _f64p]
        lib.spgemm.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _i64p, _i32p, _f64p, _i64p, _i32p, _f64p,
            _i64p, _i32p, _f64p]
        lib.l1_norms.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _i64p, _i32p, ctypes.c_void_p, _u8p, _f64p]
        lib.pmis_measure.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _i32p, _i64p,
            ctypes.c_int64, _f64p]
        lib.mask_to_csr.argtypes = [
            ctypes.c_int64, ctypes.c_int32, _i64p, _i32p, _u8p,
            _i64p, _i32p]
        lib.stencil_csr.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, _i32p, _i32p, _i32p, _f64p,
            _i64p, _i32p, _f64p]
        lib.csr_transpose.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, _f64p,
            _i64p, _i32p, _f64p]
        lib.gs_wavefronts.argtypes = [
            ctypes.c_int64, ctypes.c_int32, _i64p, _i32p, _i32p]
        lib.ilu_factor.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _f64p,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            _i64p, _i32p, _f64p, _i64p, _i32p, _f64p]
        lib.ilu_refactor.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _f64p,
            _i64p, _i32p, _i64p, _i32p,
            _f64p, _f64p, _f64p]
        lib.batched_lu_solve.argtypes = [
            ctypes.c_int64, ctypes.c_int32, _f64p, _f64p, _i32p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.csr_lookup.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _f64p, _i64p, _i64p, _f64p]
        for fn in ("rs_first_pass", "strength_mask", "pmis",
                   "direct_interp", "extpi_interp", "truncate_interp",
                   "spgemm", "csr_transpose", "stencil_csr",
                   "mask_to_csr", "l1_norms", "pmis_measure",
                   "gs_wavefronts", "cljp", "rs_second_pass",
                   "lr_interp", "ilu_factor", "ilu_refactor",
                   "batched_lu_solve", "csr_lookup"):
            getattr(lib, fn).restype = None
        _lib = lib
        return lib


def build_cuda() -> dict[str, dict]:
    """Compile every stale ``*.cu`` source, all nvcc processes at once.

    Returns {source: {"seconds": wall, "log": nvcc output}} for the
    sources that were compiled (ptxas' register and spill report is in
    the log).  Raises on the first failed build."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); the CUDA "
                           "kernels build only where it is installed")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    with _lock:
        t0 = time.perf_counter()
        procs = {}
        for src in CUDA_SOURCES:
            path = os.path.join(HERE, src)
            so = _cuda_so(src)
            if _stale(so, path):
                procs[src] = (_compile([nvcc, *NVCC_FLAGS, path], so), so)
        report = {}
        for src, (proc, so) in procs.items():
            log = _finish(proc, so)
            report[src] = {"seconds": time.perf_counter() - t0, "log": log}
        return report


# torch's raw accessor of the current stream, where the build has one
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device) -> int:
    """The raw cudaStream_t of `device`'s current stream, for a C entry:
    through the raw accessor where there is one (building a Stream
    object costs a few µs a call), else the Stream's own handle."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _cuda_so(src: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(src)[0]}.so")


def load_cuda(src: str) -> ctypes.CDLL:
    """The shared library of one ``.cu`` source, built if stale."""
    lib = _cuda_libs.get(src)
    if lib is not None:
        return lib
    build_cuda()
    with _lock:
        if src not in _cuda_libs:
            _cuda_libs[src] = ctypes.CDLL(_cuda_so(src))
        return _cuda_libs[src]


def _p(a, t):
    return a.ctypes.data_as(t)


def _csr_arrays(A):
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    return indptr, indices, data


def rs_first_pass(S, ST):
    """Run the native Ruge-Stüben first pass on scipy CSR S and S^T."""
    lib = load()
    n = S.shape[0]
    s_indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    s_indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    st_indptr = np.ascontiguousarray(ST.indptr, dtype=np.int64)
    st_indices = np.ascontiguousarray(ST.indices, dtype=np.int32)
    cf = np.zeros(n, dtype=np.int32)
    lib.rs_first_pass(
        n, _p(s_indptr, _i64p), _p(s_indices, _i32p),
        _p(st_indptr, _i64p), _p(st_indices, _i32p), _p(cf, _i32p))
    return cf


def strength_mask(A, theta: float, max_row_sum: float,
                  abs_soc: bool = False) -> np.ndarray:
    """Per-entry strong-connection mask over (sorted) CSR A."""
    lib = load()
    indptr, indices, data = _csr_arrays(A)
    strong = np.zeros(len(indices), dtype=np.uint8)
    lib.strength_mask(A.shape[0], _p(indptr, _i64p), _p(indices, _i32p),
                      _p(data, _f64p), float(theta), float(max_row_sum),
                      int(abs_soc), _p(strong, _u8p))
    return strong.view(bool)


def pmis(S, measure: np.ndarray) -> np.ndarray:
    lib = load()
    n = S.shape[0]
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    meas = np.ascontiguousarray(measure, dtype=np.float64).copy()
    cf = np.zeros(n, dtype=np.int32)
    lib.pmis(n, _p(indptr, _i64p), _p(indices, _i32p),
             _p(meas, _f64p), _p(cf, _i32p))
    return cf


def cljp(S, measure, cf_init_marker=None):
    """CLJP coarsening (cf_init_marker: existing C/F seed = Falgout)."""
    lib = load()
    n = S.shape[0]
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    meas = np.ascontiguousarray(measure, dtype=np.float64).copy()
    if cf_init_marker is None:
        cf = np.zeros(n, dtype=np.int32)
        init = 0
    else:
        cf = np.ascontiguousarray(cf_init_marker, dtype=np.int32).copy()
        init = 1
    lib.cljp(n, _p(indptr, _i64p), _p(indices, _i32p),
             _p(meas, _f64p), _p(cf, _i32p), init)
    return cf


def rs_second_pass(S, cf):
    """Classical RS second pass (F-F common-C enforcement), in place
    on a copy."""
    lib = load()
    n = S.shape[0]
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    out = np.ascontiguousarray(cf, dtype=np.int32).copy()
    lib.rs_second_pass(n, _p(indptr, _i64p), _p(indices, _i32p),
                       _p(out, _i32p))
    return out


def _interp_two_pass(fn_name, A, strong, cf, cmap, extra=(), lead=()):
    import scipy.sparse as sp

    lib = load()
    fn = getattr(lib, fn_name)
    n = A.shape[0]
    indptr, indices, data = _csr_arrays(A)
    strong_u8 = np.ascontiguousarray(strong, dtype=np.uint8)
    cf32 = np.ascontiguousarray(cf, dtype=np.int32)
    cmap32 = np.ascontiguousarray(cmap, dtype=np.int32)
    p_indptr = np.zeros(n + 1, dtype=np.int64)
    args0 = [n, 0, *lead, _p(indptr, _i64p), _p(indices, _i32p),
             _p(data, _f64p), _p(strong_u8, _u8p), _p(cf32, _i32p),
             _p(cmap32, _i32p), *extra, _p(p_indptr, _i64p),
             _i32p(), _f64p()]
    fn(*args0)
    nnz = int(p_indptr[n])
    p_indices = np.zeros(nnz, dtype=np.int32)
    p_data = np.zeros(nnz, dtype=np.float64)
    args1 = [n, 1, *lead, _p(indptr, _i64p), _p(indices, _i32p),
             _p(data, _f64p), _p(strong_u8, _u8p), _p(cf32, _i32p),
             _p(cmap32, _i32p), *extra, _p(p_indptr, _i64p),
             _p(p_indices, _i32p), _p(p_data, _f64p)]
    fn(*args1)
    n_coarse = int((np.asarray(cf) == 1).sum())
    return sp.csr_matrix((p_data, p_indices, p_indptr),
                         shape=(n, n_coarse))


def direct_interp(A, strong, cf, cmap):
    return _interp_two_pass("direct_interp", A, strong, cf, cmap)


def extpi_interp(A, strong, cf, cmap):
    diag = np.ascontiguousarray(A.diagonal(), dtype=np.float64)
    return _interp_two_pass("extpi_interp", A, strong, cf, cmap,
                            extra=(_p(diag, _f64p),))


def lr_interp(A, strong, cf, cmap, variant: int):
    """Classical (0) / extended (14) / standard (8, 9=sep_weight)."""
    diag = np.ascontiguousarray(A.diagonal(), dtype=np.float64)
    return _interp_two_pass("lr_interp", A, strong, cf, cmap,
                            extra=(_p(diag, _f64p),),
                            lead=(variant,))


def truncate_interp(P, trunc_factor: float, max_elmts: int):
    import scipy.sparse as sp

    lib = load()
    n = P.shape[0]
    indptr, indices, data = _csr_arrays(P)
    t_indptr = np.zeros(n + 1, dtype=np.int64)
    lib.truncate_interp(n, 0, _p(indptr, _i64p), _p(indices, _i32p),
                        _p(data, _f64p), float(trunc_factor),
                        int(max_elmts), _p(t_indptr, _i64p),
                        _i32p(), _f64p())
    nnz = int(t_indptr[n])
    if nnz == len(indices):
        return P
    t_indices = np.zeros(nnz, dtype=np.int32)
    t_data = np.zeros(nnz, dtype=np.float64)
    lib.truncate_interp(n, 1, _p(indptr, _i64p), _p(indices, _i32p),
                        _p(data, _f64p), float(trunc_factor),
                        int(max_elmts), _p(t_indptr, _i64p),
                        _p(t_indices, _i32p), _p(t_data, _f64p))
    return sp.csr_matrix((t_data, t_indices, t_indptr), shape=P.shape)


def spgemm(A, B):
    """C = A @ B (row-parallel, deterministic per-row accumulation)."""
    import scipy.sparse as sp

    lib = load()
    n, k = A.shape
    k2, m = B.shape
    if k != k2:
        raise ValueError(f"spgemm shapes {A.shape} and {B.shape}")
    a_indptr, a_indices, a_data = _csr_arrays(A)
    b_indptr, b_indices, b_data = _csr_arrays(B)
    c_indptr = np.zeros(n + 1, dtype=np.int64)
    lib.spgemm(n, m, 0, _p(a_indptr, _i64p), _p(a_indices, _i32p),
               _p(a_data, _f64p), _p(b_indptr, _i64p),
               _p(b_indices, _i32p), _p(b_data, _f64p),
               _p(c_indptr, _i64p), _i32p(), _f64p())
    nnz = int(c_indptr[n])
    c_indices = np.zeros(nnz, dtype=np.int32)
    c_data = np.zeros(nnz, dtype=np.float64)
    lib.spgemm(n, m, 1, _p(a_indptr, _i64p), _p(a_indices, _i32p),
               _p(a_data, _f64p), _p(b_indptr, _i64p),
               _p(b_indices, _i32p), _p(b_data, _f64p),
               _p(c_indptr, _i64p), _p(c_indices, _i32p),
               _p(c_data, _f64p))
    return sp.csr_matrix((c_data, c_indices, c_indptr), shape=(n, m))


def csr_transpose(A):
    import scipy.sparse as sp

    lib = load()
    n, m = A.shape
    indptr, indices, data = _csr_arrays(A)
    t_indptr = np.zeros(m + 1, dtype=np.int64)
    t_indices = np.zeros(len(indices), dtype=np.int32)
    t_data = np.zeros(len(indices), dtype=np.float64)
    lib.csr_transpose(n, m, _p(indptr, _i64p), _p(indices, _i32p),
                      _p(data, _f64p), _p(t_indptr, _i64p),
                      _p(t_indices, _i32p), _p(t_data, _f64p))
    return sp.csr_matrix((t_data, t_indices, t_indptr), shape=(m, n))


def stencil_csr(shape, entries, dtype):
    """CSR stencil-matrix generator (see stencil_matrix in gen/)."""
    import scipy.sparse as sp

    lib = load()
    nx, ny, nz = (int(s) for s in shape)
    n = nx * ny * nz
    ents = sorted(((d, v) for d, v in entries if v != 0.0),
                  key=lambda e: e[0][0] + nx * (e[0][1] + ny * e[0][2]))
    dx = np.ascontiguousarray([e[0][0] for e in ents], dtype=np.int32)
    dy = np.ascontiguousarray([e[0][1] for e in ents], dtype=np.int32)
    dz = np.ascontiguousarray([e[0][2] for e in ents], dtype=np.int32)
    vv = np.ascontiguousarray([e[1] for e in ents], dtype=np.float64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    lib.stencil_csr(nx, ny, nz, len(ents), 0, _p(dx, _i32p), _p(dy, _i32p),
                    _p(dz, _i32p), _p(vv, _f64p), _p(indptr, _i64p),
                    _i32p(), _f64p())
    nnz = int(indptr[n])
    indices = np.empty(nnz, dtype=np.int32)
    data = np.empty(nnz, dtype=np.float64)
    lib.stencil_csr(nx, ny, nz, len(ents), 1, _p(dx, _i32p), _p(dy, _i32p),
                    _p(dz, _i32p), _p(vv, _f64p), _p(indptr, _i64p),
                    _p(indices, _i32p), _p(data, _f64p))
    return sp.csr_matrix((data.astype(dtype, copy=False), indices, indptr),
                         shape=(n, n))


def mask_to_csr(A, mask):
    """Strength pattern S from the per-entry strong mask (data = 1)."""
    import scipy.sparse as sp

    lib = load()
    n = A.shape[0]
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    mask_u8 = np.ascontiguousarray(mask, dtype=np.uint8)
    s_indptr = np.zeros(n + 1, dtype=np.int64)
    lib.mask_to_csr(n, 0, _p(indptr, _i64p), _p(indices, _i32p),
                    _p(mask_u8, _u8p), _p(s_indptr, _i64p), _i32p())
    nnz = int(s_indptr[n])
    s_indices = np.empty(nnz, dtype=np.int32)
    lib.mask_to_csr(n, 1, _p(indptr, _i64p), _p(indices, _i32p),
                    _p(mask_u8, _u8p), _p(s_indptr, _i64p),
                    _p(s_indices, _i32p))
    # uint8 data: S is a pattern; callers use only indptr/indices
    return sp.csr_matrix((np.ones(nnz, dtype=np.uint8), s_indices,
                          s_indptr), shape=A.shape)


def l1_norms(A, option: int, offproc_mask=None):
    """Native smoother l1 row norms (f32 data handled without a copy)."""
    lib = load()
    n = A.shape[0]
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data)
    if data.dtype == np.float32:
        is_f32 = 1
    else:
        data = data.astype(np.float64, copy=False)
        is_f32 = 0
    mask_p = _u8p()
    if offproc_mask is not None:
        mask_u8 = np.ascontiguousarray(offproc_mask, dtype=np.uint8)
        mask_p = _p(mask_u8, _u8p)
    d = np.empty(n, dtype=np.float64)
    lib.l1_norms(n, option, is_f32, _p(indptr, _i64p),
                 _p(indices, _i32p),
                 data.ctypes.data_as(ctypes.c_void_p), mask_p,
                 _p(d, _f64p))
    return d


def pmis_measure(S, global_ids, seed: int):
    lib = load()
    n = S.shape[0]
    indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    gids = np.ascontiguousarray(global_ids, dtype=np.int64)
    measure = np.empty(n, dtype=np.float64)
    lib.pmis_measure(n, len(indices), _p(indices, _i32p),
                     _p(gids, _i64p), seed, _p(measure, _f64p))
    return measure


def gs_wavefronts(A, backward: bool = False):
    """Wavefront depth per row for a (l1-)GS sweep over CSR A."""
    lib = load()
    n = A.shape[0]
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    depth = np.zeros(n, dtype=np.int32)
    lib.gs_wavefronts(n, int(backward), _p(indptr, _i64p),
                      _p(indices, _i32p), _p(depth, _i32p))
    return depth


def batched_lu_solve(mats, rhs, getrf_ptr: int, trsm_ptr: int):
    """Solve mats[b] x[b] = rhs[b] for a (batch, k, k) stack: LAPACK
    getrf, the row swaps, BLAS trsm (unit lower, then upper) on each,
    through the given routine pointers (setup/lapack.py)."""
    lib = load()
    mats = np.ascontiguousarray(mats, dtype=np.float64)
    x = np.array(rhs, dtype=np.float64, order="C", copy=True)
    batch, k = x.shape
    if mats.shape != (batch, k, k):
        raise ValueError(f"batched_lu_solve: mats {mats.shape} and rhs "
                         f"{x.shape} do not match")
    info = np.zeros(batch, dtype=np.int32)
    lib.batched_lu_solve(batch, k, _p(mats, _f64p), _p(x, _f64p),
                         _p(info, _i32p), getrf_ptr, trsm_ptr)
    return x, info


def csr_lookup(A, rows, cols):
    """A[rows[q], cols[q]] for each query (0 where A holds no entry);
    A is a canonical scipy CSR (sorted columns, no duplicates)."""
    lib = load()
    n = A.shape[0]
    indptr, indices, data = _csr_arrays(A)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    if rows.shape != cols.shape or (rows.size and (
            rows.min() < 0 or rows.max() >= n)):
        raise ValueError("csr_lookup: rows out of range or shapes differ")
    out = np.empty(rows.shape, dtype=np.float64)
    lib.csr_lookup(rows.size, _p(indptr, _i64p), _p(indices, _i32p),
                   _p(data, _f64p), _p(rows, _i64p), _p(cols, _i64p),
                   _p(out, _f64p))
    return out


_ilu_lock = threading.Lock()


def ilu_factor(A, fill_k: int = 0, drop_tol: float = 0.0,
               max_keep: int = 1000, is_ilut: bool = False):
    """ILU(k) / ILUT factorization of CSR A (ref: src/parcsr_ls/
    par_ilu_setup.c hypre_ILUSetupILUK / hypre_ILUSetupILUT).

    Returns (L, udiag, U): L strict-lower CSR (unit diagonal implied),
    udiag the pivot array, U strict-upper CSR."""
    import scipy.sparse as sp

    lib = load()
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    indptr, indices, data = _csr_arrays(A)
    l_indptr = np.zeros(n + 1, dtype=np.int64)
    u_indptr = np.zeros(n + 1, dtype=np.int64)
    with _ilu_lock:
        lib.ilu_factor(n, _p(indptr, _i64p), _p(indices, _i32p),
                       _p(data, _f64p), fill_k, drop_tol, max_keep,
                       1 if is_ilut else 0, 0,
                       _p(l_indptr, _i64p), _i32p(), _f64p(),
                       _p(u_indptr, _i64p), _i32p(), _f64p())
        l_nnz = int(l_indptr[n])
        u_nnz = int(u_indptr[n])
        l_indices = np.zeros(l_nnz, dtype=np.int32)
        l_data = np.zeros(l_nnz, dtype=np.float64)
        u_indices = np.zeros(u_nnz, dtype=np.int32)
        u_data = np.zeros(u_nnz, dtype=np.float64)
        lib.ilu_factor(n, _p(indptr, _i64p), _p(indices, _i32p),
                       _p(data, _f64p), fill_k, drop_tol, max_keep,
                       1 if is_ilut else 0, 1,
                       _p(l_indptr, _i64p), _p(l_indices, _i32p),
                       _p(l_data, _f64p), _p(u_indptr, _i64p),
                       _p(u_indices, _i32p), _p(u_data, _f64p))
    L = sp.csr_matrix((l_data, l_indices, l_indptr), shape=(n, n))
    # U rows store the pivot first, then the sorted strict upper part
    udiag = u_data[u_indptr[:-1]].copy()
    keep = np.ones(u_nnz, dtype=bool)
    keep[u_indptr[:-1]] = False
    su_indptr = (u_indptr - np.arange(n + 1)).astype(np.int64)
    U = sp.csr_matrix((u_data[keep], u_indices[keep], su_indptr),
                      shape=(n, n))
    return L, udiag, U


def ilu_refactor(A, L, U):
    """Level-scheduled PARALLEL numeric ILU factorization on the fixed
    pattern (L strict-lower, U strict-upper, both column-sorted) —
    Euclid's parallel-elimination design point (ref: src/
    distributed_ls/Euclid/Euclid_dh.c:127) and hypre's setup-reuse.
    Returns (L', udiag', U') with identical patterns.  With
    L/U = tril/triu(A) this IS a parallel exact ILU(0) (bit-identical
    to the serial factorization).  On an ILU(k>0) pattern it computes
    the STATIC-PATTERN factorization: dropped fill intermediates do
    not participate (Saad's ILU(k) lets them act within their own
    row), so values can differ slightly from a fresh ILU(k) — the
    standard behavior of pattern-reusing refactorization."""
    import scipy.sparse as sp

    lib = load()
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    L = L.tocsr()
    L.sort_indices()
    U = U.tocsr()
    U.sort_indices()
    a_indptr, a_indices, a_data = _csr_arrays(A)
    l_indptr = L.indptr.astype(np.int64)
    l_indices = L.indices.astype(np.int32)
    u_indptr = U.indptr.astype(np.int64)
    u_indices = U.indices.astype(np.int32)
    l_data = np.zeros(L.nnz, dtype=np.float64)
    u_data = np.zeros(U.nnz, dtype=np.float64)
    udiag = np.zeros(n, dtype=np.float64)
    lib.ilu_refactor(n, _p(a_indptr, _i64p), _p(a_indices, _i32p),
                     _p(a_data, _f64p), _p(l_indptr, _i64p),
                     _p(l_indices, _i32p), _p(u_indptr, _i64p),
                     _p(u_indices, _i32p), _p(l_data, _f64p),
                     _p(udiag, _f64p), _p(u_data, _f64p))
    L2 = sp.csr_matrix((l_data, l_indices.copy(), l_indptr.copy()),
                       shape=(n, n))
    U2 = sp.csr_matrix((u_data, u_indices.copy(), u_indptr.copy()),
                       shape=(n, n))
    return L2, udiag, U2
