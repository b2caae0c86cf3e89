"""SMG — semicoarsening multigrid with line/plane smoothing.

Port of hypre_tpu/struct/smg.py, the analog of hypre's SMG (ref:
src/struct_ls/smg_setup.c:17, smg_solve.c, smg_relax.c):

* 2D: coarsen y; relaxation is zebra line smoothing — all x-lines
  solved as batched tridiagonal systems by cyclic reduction
  (ops/tridiag.py), the even-y lines kept, then the odd-y lines.
* 3D: coarsen z; plane relaxation solves each xy-plane approximately
  with one V-cycle of a nested batched-2D SMG hierarchy, one zebra
  color of z-planes at a time.

Interpolation uses PFMG's collapsed-stencil weights and transfers.  The
setup is the reference's numpy on the host; each level is uploaded once.

Two departures from the reference, on purpose, for the size of the
coarsest systems (the operators are the same):

* a nested plane hierarchy's coarsest operator has only off[0] == 0
  entries, so its dense matrix is block-diagonal by z-plane; the port
  stores the inverse as per-plane blocks (nz, m, m), inverted with one
  batched ``torch.linalg.inv`` and applied with a batched product, where
  the reference inverts the whole (nz*m)^2 matrix with numpy;
* the top-level coarsest operator's dense matrix is assembled and
  inverted on the configured device, not with numpy on the host (at
  128^3 it is 32768^2: 8.6 GB in f64).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import as_real, get_device
from hypre_tpu_torch.ops.tridiag import tridiag_solve
from hypre_tpu_torch.struct.grid import StructMatrix, np_real, struct_matvec
from hypre_tpu_torch.struct.pfmg import (
    _dense_index, _interp_apply, _interp_weights, _restrict_apply,
    _semicoarsen_rap, mg_solve,
)


@dataclasses.dataclass
class SmgConfig:
    max_levels: int = 25
    max_coarse_size: int = 64
    num_pre_relax: int = 1
    num_post_relax: int = 1
    tol: float = 1e-6
    max_iter: int = 100


@dataclasses.dataclass(frozen=True)
class SmgLevel:
    A: StructMatrix
    wm: Optional[torch.Tensor]
    wp: Optional[torch.Tensor]
    line_a: torch.Tensor         # x-line coefficients (west)
    line_b: torch.Tensor         # center
    line_c: torch.Tensor         # east
    plane2d: object              # nested 2D hierarchy for 3D levels
    cdir: int
    fine_shape: tuple
    coarse_shape: tuple


@dataclasses.dataclass(frozen=True)
class SmgHierarchy:
    levels: tuple
    c_dense_inv: torch.Tensor    # (n, n), or (nz, m, m) per-plane blocks
    n_pre: int
    n_post: int
    dim: int                     # 2 or 3


class SMG:
    def __init__(self, config: SmgConfig | None = None):
        self.config = config or SmgConfig()
        self.hierarchy: SmgHierarchy | None = None

    def setup(self, A: StructMatrix) -> "SMG":
        device = get_device()
        real = np_real()
        Ad = {off: A.coefs[k].cpu().numpy().astype(real, copy=False)
              for k, off in enumerate(A.offsets)}
        shape = tuple(A.shape)
        dim = 3 if shape[0] > 1 else 2
        self.hierarchy = _smg_build(Ad, shape, dim, self.config, real,
                                    device, nested=False)
        return self

    @property
    def level_shapes(self) -> list:
        return [lvl.fine_shape for lvl in self.hierarchy.levels]

    def solve(self, b, x0=None, tol=None, max_iter=None):
        """Standalone SMG iteration; returns (x, iterations, relres)."""
        cfg = self.config
        h = self.hierarchy
        A0 = h.levels[0].A
        return mg_solve(
            lambda u: struct_matvec(A0, u), lambda r: smg_cycle(h, r),
            as_real(b, A0.coefs.dtype), x0,
            float(tol if tol is not None else cfg.tol),
            int(max_iter or cfg.max_iter))

    def precondition(self, r):
        return smg_cycle(self.hierarchy, r)


def _line_coefs(Ad, shape, real):
    """Extract x-line (west, center, east) coefficient arrays."""
    z = np.zeros(shape, dtype=real)
    a = Ad.get((0, 0, -1), z).copy()
    c = Ad.get((0, 0, 1), z).copy()
    b = Ad.get((0, 0, 0), np.ones(shape, dtype=real)).copy()
    return a, b, c


def _smg_build(Ad, shape, dim, cfg, real, device, nested) -> SmgHierarchy:
    """The level loop of the reference's ``_smg_build``; ``nested``
    marks a plane hierarchy (its coarsest inverse is per-plane)."""
    cdir = 0 if dim == 3 else 1     # coarsen z in 3D, y in 2D
    levels = []
    for _ in range(cfg.max_levels - 1):
        if int(np.prod(shape)) <= cfg.max_coarse_size \
                or shape[cdir] < 3:
            break
        wm, wp = _interp_weights(Ad, shape, cdir, real)
        Ac, cshape = _semicoarsen_rap(Ad, wm, wp, cdir, shape)
        levels.append(_smg_level(Ad, shape, cdir, wm, wp, cshape, real,
                                 dim, cfg, device))
        Ad, shape = Ac, cshape
    levels.append(_smg_level(Ad, shape, -1, None, None, shape, real,
                             dim, cfg, device))
    dtype = torch.float64 if real == np.float64 else torch.float32
    c_inv = (_plane_blocks_inv if nested else _dense_inv)(
        Ad, shape, dtype, device)
    return SmgHierarchy(levels=tuple(levels), c_dense_inv=c_inv,
                        n_pre=cfg.num_pre_relax, n_post=cfg.num_post_relax,
                        dim=dim)


def _dense_inv(Ad, shape, dtype, device):
    """Inverse of the stencil's dense matrix, assembled and inverted on
    the device."""
    n = int(np.prod(shape))
    dense = torch.zeros((n, n), dtype=dtype, device=device)
    for off, c in Ad.items():
        src, tgt, win = _dense_index(off, shape)
        dense[torch.as_tensor(src, device=device),
              torch.as_tensor(tgt, device=device)] += torch.as_tensor(
                  c[win].ravel(), dtype=dtype, device=device)
    return torch.linalg.inv(dense)


def _plane_blocks_inv(Ad, shape, dtype, device):
    """Per-plane inverses (nz, m, m), m = ny*nx, of a stencil with
    off[0] == 0 only: the diagonal blocks of its dense matrix's inverse,
    which has no other entries."""
    nz, ny, nx = shape
    m = ny * nx
    blocks = torch.zeros((nz, m, m), dtype=dtype, device=device)
    for off, c in Ad.items():
        src, tgt, (_, ys, xs) = _dense_index(off, (1, ny, nx))
        blocks[:, torch.as_tensor(src, device=device),
               torch.as_tensor(tgt, device=device)] += torch.as_tensor(
                   c[:, ys, xs].reshape(nz, -1), dtype=dtype, device=device)
    return torch.linalg.inv(blocks)


def _smg_level(Ad, shape, cdir, wm, wp, cshape, real, dim, cfg, device):
    offs = tuple(sorted(Ad.keys()))
    coefs = np.stack([Ad[o] for o in offs]).astype(real)
    la, lb, lc = _line_coefs(Ad, shape, real)
    lb = np.where(lb != 0, lb, 1.0)

    plane2d = None
    if dim == 3 and shape[0] > 1:
        # nested batched-2D hierarchy over z-planes for plane smoothing
        Ad2 = {off: c for off, c in Ad.items() if off[0] == 0}
        cfg2 = dataclasses.replace(cfg, max_coarse_size=max(
            cfg.max_coarse_size // 4, 16))
        plane2d = _smg_build(dict(Ad2), shape, 2, cfg2, real, device,
                             nested=True)

    def up(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a.astype(real, copy=False)), device=device)

    return SmgLevel(
        A=StructMatrix(coefs=up(coefs), offsets=offs, shape=tuple(shape)),
        wm=up(wm), wp=up(wp), line_a=up(la), line_b=up(lb), line_c=up(lc),
        plane2d=plane2d,
        cdir=cdir, fine_shape=tuple(shape), coarse_shape=tuple(cshape))


# ---------------------------------------------------------------------------
# relaxation
# ---------------------------------------------------------------------------

def _line_matvec(lvl: SmgLevel, u):
    """Apply only the x-line part of the stencil."""
    y = lvl.line_b * u
    y[..., 1:].addcmul_(lvl.line_a[..., 1:], u[..., :-1])
    y[..., :-1].addcmul_(lvl.line_c[..., :-1], u[..., 1:])
    return y


def _zebra_line_relax(lvl: SmgLevel, f, u, sweeps, up=False):
    """Zebra (red-black line) smoothing along y: all x-lines solved as
    batched tridiagonal systems, the even-y ones kept, then the odd-y
    ones.  The up-sweep reverses the color order so pre+post relaxation
    is a symmetric operation (as the reference's symmetric SMG cycle)."""
    if u is None:
        u = torch.zeros_like(f)
    colors = (1, 0) if up else (0, 1)
    rows = torch.arange(f.shape[1], device=f.device)
    for _ in range(sweeps):
        for parity in colors:
            r = f - struct_matvec(lvl.A, u) + _line_matvec(lvl, u)
            sol = tridiag_solve(lvl.line_a, lvl.line_b, lvl.line_c, r)
            mask = (rows % 2 == parity)[None, :, None]
            u = torch.where(mask, sol, u)
    return u


def _plane_relax(lvl: SmgLevel, f, u, sweeps, up=False):
    """3D plane smoothing: one batched-2D SMG V-cycle per zebra color
    of z-planes (color order reversed on the up sweep)."""
    if u is None:
        u = torch.zeros_like(f)
    colors = (1, 0) if up else (0, 1)
    planes = torch.arange(f.shape[0], device=f.device)
    for _ in range(sweeps):
        for parity in colors:
            r = f - struct_matvec(lvl.A, u)
            e = smg_cycle(lvl.plane2d, r)
            mask = (planes % 2 == parity)[:, None, None]
            u = torch.where(mask, u + e, u)
    return u


def _smg_relax(h: SmgHierarchy, lvl: SmgLevel, f, u, sweeps, up=False):
    if h.dim == 3 and lvl.plane2d is not None:
        return _plane_relax(lvl, f, u, sweeps, up)
    return _zebra_line_relax(lvl, f, u, sweeps, up)


# ---------------------------------------------------------------------------
# cycle
# ---------------------------------------------------------------------------

def coarse_apply(c_inv, b, shape):
    """u = A_c^-1 b on the coarsest grid: a dense product, or one
    product a z-plane with per-plane blocks."""
    if c_inv.dim() == 3:
        return torch.bmm(c_inv, b.reshape(shape[0], -1, 1)).reshape(shape)
    return (c_inv @ b.reshape(-1)).reshape(shape)


def smg_cycle(h: SmgHierarchy, b):
    levels = h.levels
    nl = len(levels)
    us, bs = [], [b]
    for l in range(nl - 1):
        lvl = levels[l]
        u = _smg_relax(h, lvl, bs[l], None, h.n_pre, up=False)
        r = bs[l] - struct_matvec(lvl.A, u)
        bs.append(_restrict_apply(lvl, r))
        us.append(u)

    uc = coarse_apply(h.c_dense_inv, bs[-1], levels[-1].fine_shape)

    for l in range(nl - 2, -1, -1):
        lvl = levels[l]
        u = us[l] + _interp_apply(lvl, uc)
        u = _smg_relax(h, lvl, bs[l], u, h.n_post, up=True)
        uc = u
    return uc
