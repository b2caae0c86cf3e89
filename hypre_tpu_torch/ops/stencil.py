"""Analytic constant-coefficient stencil matvec: zero operator traffic.

Counterpart of hypre_tpu/ops/stencil_pallas.py.  The fine level of a
generated stencil problem (gen/laplace.py, ref:
src/parcsr_ls/par_laplace.c:63) is a constant-coefficient operator with
Dirichlet truncation: every value is a stencil constant or zero at a
boundary.  Storing it costs ~12 bytes per nonzero (1.4 GB per matvec at
256^3 in f64) to carry what the row index already says, so the setup is
told the stencil (``BoomerAMG.setup(fine_stencil=...)``) and level 0
applies it analytically: kernel K1 in ``csrc/stencil_matvec.cu`` reads
only x and writes only y.

The TPU kernel's gate (power-of-two nx and ny, n % 1024 == 0) is not
carried over: the CUDA kernel takes any grid.  It has two instances,
picked by ``kernel_instance`` from the stencil's reach and the grid:
"tile" (reach 1: x-y tiles staged in shared memory, marching along z)
and "row" (any reach: one thread a row).

``stencil_matvec`` launches the kernel for a CUDA tensor and runs the
plain version ``stencil_matvec_plain`` for a CPU tensor; there is no
fallback between the two.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing

import numpy as np
import torch

from hypre_tpu_torch.core.errors import HypreTpuError
from hypre_tpu_torch.csrc.build import stream_ptr

_NP_REAL = {torch.float64: np.float64, torch.float32: np.float32}
MAX_ENTRIES = 27   # kMaxEntries of csrc/stencil_matvec.cu
TILE_Y = 16        # kTy * kRows: y rows of a tile kernel's block
MAX_GRID = 65535   # kMaxGrid: the tile kernel's gridDim.y


class K1Args(typing.NamedTuple):
    """instance: "tile" or "row" (kernel_instance); dxyz: int32 (k, 3)
    offsets and vals: (k,) values, both in the entries' order (one zero
    row when k = 0); the two arrays' addresses, for ctypes."""

    instance: str
    dxyz: np.ndarray
    vals: np.ndarray
    dxyz_ptr: int
    vals_ptr: int


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """grid: (nx, ny, nz) x-fastest; entries: (((dx,dy,dz), v), ...)."""

    grid: tuple
    entries: tuple
    dtype: torch.dtype = torch.float64

    @property
    def n_rows(self) -> int:
        nx, ny, nz = self.grid
        return nx * ny * nz

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def shape(self):
        return (self.n_rows, self.n_rows)

    @property
    def reach(self) -> int:
        """The largest |component| of the entries' offsets."""
        return max((abs(c) for d, _ in self.entries for c in d), default=0)

    @functools.cached_property
    def launch_args(self) -> K1Args:
        """K1's argument, packed once per op."""
        k = len(self.entries)
        dxyz = np.zeros((max(k, 1), 3), dtype=np.int32)
        vals = np.zeros(max(k, 1), dtype=_NP_REAL[self.dtype])
        for i, (d, v) in enumerate(self.entries):
            dxyz[i], vals[i] = d, v
        return K1Args(kernel_instance(self), dxyz, vals, dxyz.ctypes.data,
                      vals.ctypes.data)

    @property
    def nnz(self) -> int:
        nx, ny, nz = self.grid
        t = 0
        for (dx, dy, dz), v in self.entries:
            if v != 0.0:
                t += max(nx - abs(dx), 0) * max(ny - abs(dy), 0) \
                    * max(nz - abs(dz), 0)
        return t


def kernel_instance(op: StencilOp) -> str:
    """K1's instance for `op`: "tile" for a stencil of reach 1 on a grid
    whose x-y plane has fewer than 2^31 cells and whose y fits the
    tile kernel's launch grid (32-bit indices within a plane), else
    "row"."""
    nx, ny, nz = op.grid
    if op.reach <= 1 and nx * ny < 2 ** 31 and nz < 2 ** 31 \
            and -(-ny // TILE_Y) <= MAX_GRID:
        return "tile"
    return "row"


def stencil_op(shape, entries, dtype=None) -> StencilOp:
    if dtype is None:
        from hypre_tpu_torch.core.config import get_config

        dtype = get_config().real_dtype
    ents = tuple((tuple(int(c) for c in d), float(v))
                 for d, v in entries if v != 0.0)
    if len(ents) > MAX_ENTRIES:
        raise HypreTpuError(f"StencilOp takes at most {MAX_ENTRIES} "
                            f"entries, got {len(ents)}")
    return StencilOp(grid=tuple(int(s) for s in shape), entries=ents,
                     dtype=dtype)


def _shift(s: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """out[i] = s[i + d] along `dim`, zero where i + d leaves the grid."""
    n = s.shape[dim]
    if abs(d) >= n:
        return torch.zeros_like(s)
    zeros = torch.zeros_like(s.narrow(dim, 0, abs(d)))
    if d > 0:
        return torch.cat([s.narrow(dim, d, n - d), zeros], dim)
    return torch.cat([zeros, s.narrow(dim, 0, n + d)], dim)


def stencil_matvec_plain(op: StencilOp, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: shifted-slice FMAs on the 3D grid,
    entry by entry (the semantics of stencil_matvec_reference)."""
    nx, ny, nz = op.grid
    u = x.to(op.dtype).reshape(nz, ny, nx)
    y = torch.zeros_like(u)
    for (dx, dy, dz), v in op.entries:
        s = u
        for dim, d in ((2, dx), (1, dy), (0, dz)):
            if d:
                s = _shift(s, d, dim)
        y = y + v * s
    return y.reshape(-1)



@functools.cache
def _kernel(dtype: torch.dtype):
    """The C entry of K1 for `dtype`, built and loaded on first use."""
    from hypre_tpu_torch.csrc.build import load_cuda

    if dtype not in _NP_REAL:
        raise HypreTpuError(f"stencil_matvec: unsupported {dtype}")
    lib = load_cuda("stencil_matvec.cu")
    fn = getattr(lib, "stencil_matvec_f64" if dtype == torch.float64
                 else "stencil_matvec_f32")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, p, i64, i64, i64, i32, i32, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def stencil_matvec(op: StencilOp, x: torch.Tensor) -> torch.Tensor:
    """y = A x: kernel K1 for a CUDA tensor, the plain version for a
    CPU tensor.  ``stencil_matvec.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return stencil_matvec_plain(op, x)
    if not x.is_cuda:
        raise HypreTpuError(f"stencil_matvec: no kernel for {x.device}")
    if x.dtype != op.dtype or x.shape != (op.n_cols,) \
            or not x.is_contiguous():
        raise HypreTpuError(
            f"stencil_matvec: x must be contiguous {op.dtype} of shape "
            f"({op.n_cols},), got {x.dtype} {tuple(x.shape)}")
    fn = _kernel(op.dtype)
    args = op.launch_args
    y = torch.empty_like(x)
    nx, ny, nz = op.grid
    err = fn(x.data_ptr(), y.data_ptr(), nx, ny, nz, args.instance == "tile",
             len(op.entries), args.dxyz_ptr, args.vals_ptr,
             stream_ptr(x.device))
    if err != 0:
        raise HypreTpuError(f"stencil_matvec kernel launch failed: "
                            f"CUDA error {err}")
    stencil_matvec.launches += 1
    return y


stencil_matvec.launches = 0
