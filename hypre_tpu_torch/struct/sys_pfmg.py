"""SysPFMG — system (multi-variable) semicoarsening multigrid.

Port of hypre_tpu/struct/sys_pfmg.py, the analog of hypre's SysPFMG
(ref: src/sstruct_ls/sys_pfmg_setup.c:35, sys_pfmg_solve.c,
sys_semi_interp.c): several variables per grid point, all on the same
structured grid, coupled through inter-variable stencils.

The operator is an nvars x nvars block matrix of stencils,
A[vi][vj] coupling variable vj into variable vi's equation.  SysPFMG
is PFMG where
  * interpolation is block-diagonal: P_v is the collapsed-stencil
    semicoarsening interp of the diagonal block A[v][v]
    (ref: sys_pfmg_setup_interp.c),
  * the Galerkin product runs over every block,
    Ac[vi][vj] = R_vi A[vi][vj] P_vj (``_semicoarsen_rap_rect``,
    ref: sys_pfmg_setup_rap.c), and
  * relaxation is variable-wise weighted Jacobi / RB-GS on the diagonal
    blocks with the off-diagonal blocks folded into the residual
    (ref: sys_pfmg_relax.c).

The setup is the reference's numpy on the host, each level uploaded
once; vectors are (nvars, nz, ny, nx) tensors and the cycle is torch
on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.core.config import as_real, get_device
from hypre_tpu_torch.struct.grid import StructMatrix, np_real, struct_matvec
from hypre_tpu_torch.struct.pfmg import (
    PfmgConfig, _interp_weights, _pick_cdir, _semicoarsen_rap_rect,
    _stencil_to_dense, interp_semi, mg_solve, restrict_semi,
)


@dataclasses.dataclass(frozen=True)
class SysPfmgLevel:
    blocks: tuple       # len nvars*nvars of StructMatrix | None
    wm: tuple           # per-variable interp weights (None on coarsest)
    wp: tuple
    dinv: torch.Tensor  # (nvars, *shape) 1/diag of A[v][v]
    rb_mask: torch.Tensor
    nvars: int
    cdir: int
    fine_shape: tuple
    coarse_shape: tuple


@dataclasses.dataclass(frozen=True)
class SysPfmgHierarchy:
    levels: tuple
    c_dense_inv: torch.Tensor
    relax_type: int
    weight: float
    n_pre: int
    n_post: int


def _sys_matvec(lvl: SysPfmgLevel, u):
    """(nvars, *shape) block stencil matvec."""
    nv = lvl.nvars
    outs = []
    for vi in range(nv):
        acc = None
        for vj in range(nv):
            blk = lvl.blocks[vi * nv + vj]
            if blk is None:
                continue
            t = struct_matvec(blk, u[vj])
            acc = t if acc is None else acc + t
        outs.append(acc if acc is not None
                    else torch.zeros(lvl.fine_shape, dtype=u.dtype,
                                     device=u.device))
    return torch.stack(outs)


class SysPFMG:
    """Create/Setup/Solve object for block-stencil systems.

    blocks: {(vi, vj): StructMatrix} on a common (nz, ny, nx) grid — the
    sstruct matrix restricted to one part, all variables cell-centered
    (hypre's SysPFMG setup collapses variable types the same way,
    sys_pfmg_setup.c:200+).
    """

    def __init__(self, config: PfmgConfig | None = None):
        self.config = config or PfmgConfig()
        self.hierarchy: SysPfmgHierarchy | None = None
        self.level_shapes: list[tuple] = []

    def setup(self, blocks, nvars: int, shape) -> "SysPFMG":
        cfg = self.config
        device = get_device()
        real = np_real()
        shape = tuple(shape)
        Ab = {}
        for (vi, vj), M in blocks.items():
            Ab[(vi, vj)] = {off: M.coefs[k].cpu().numpy().astype(
                real, copy=False) for k, off in enumerate(M.offsets)}

        levels = []
        for _ in range(cfg.max_levels - 1):
            if int(np.prod(shape)) * nvars <= cfg.max_coarse_size:
                break
            # coarsening direction from the combined diagonal blocks
            comb = {}
            for v in range(nvars):
                for off, c in Ab.get((v, v), {}).items():
                    comb[off] = comb.get(off, 0) + np.abs(c)
            cdir = _pick_cdir(comb, shape)
            if cdir is None or shape[cdir] < 3:
                break
            wms, wps = [], []
            for v in range(nvars):
                wm, wp = _interp_weights(Ab[(v, v)], shape, cdir, real)
                wms.append(wm)
                wps.append(wp)
            Ac = {}
            cshape = None
            for (vi, vj), Ad in Ab.items():
                acc, cshape = _semicoarsen_rap_rect(
                    Ad, wms[vi], wps[vi], wms[vj], wps[vj], cdir, shape)
                if acc:
                    Ac[(vi, vj)] = acc
            levels.append(_device_level(Ab, nvars, shape, cdir, wms, wps,
                                        cshape, real, device))
            Ab, shape = Ac, cshape

        levels.append(_device_level(Ab, nvars, shape, -1, None, None, shape,
                                    real, device))
        n = int(np.prod(shape))
        dense = np.zeros((nvars * n, nvars * n), dtype=real)
        for (vi, vj), Ad in Ab.items():
            dense[vi * n:(vi + 1) * n, vj * n:(vj + 1) * n] = \
                _stencil_to_dense(Ad, shape, real)
        c_inv = torch.as_tensor(np.linalg.inv(dense).astype(real),
                                device=device)

        self.hierarchy = SysPfmgHierarchy(
            levels=tuple(levels), c_dense_inv=c_inv,
            relax_type=cfg.relax_type, weight=cfg.jacobi_weight,
            n_pre=cfg.num_pre_relax, n_post=cfg.num_post_relax)
        self.level_shapes = [lvl.fine_shape for lvl in levels]
        return self

    # -- solve ----------------------------------------------------------

    def solve(self, b, x0=None, tol=None, max_iter=None):
        """b: (nvars, nz, ny, nx).  Returns (x, iterations, relres)."""
        cfg = self.config
        h = self.hierarchy
        lvl0 = h.levels[0]
        return mg_solve(
            lambda u: _sys_matvec(lvl0, u), lambda r: sys_pfmg_cycle(h, r),
            as_real(b, lvl0.dinv.dtype), x0,
            float(tol if tol is not None else cfg.tol),
            int(max_iter or cfg.max_iter))

    def precondition(self, r):
        return sys_pfmg_cycle(self.hierarchy, r)


def _device_level(Ab, nvars, shape, cdir, wms, wps, cshape, real, device):
    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a.astype(real)),
                               device=device)

    blocks = []
    for vi in range(nvars):
        for vj in range(nvars):
            Ad = Ab.get((vi, vj))
            if not Ad:
                blocks.append(None)
                continue
            offs = tuple(sorted(Ad.keys()))
            coefs = np.stack([Ad[o] for o in offs]).astype(real)
            blocks.append(StructMatrix(coefs=up(coefs), offsets=offs,
                                       shape=shape))
    dinv = np.ones((nvars,) + shape, dtype=real)
    for v in range(nvars):
        diag = Ab.get((v, v), {}).get((0, 0, 0))
        if diag is not None:
            dinv[v] = 1.0 / np.where(diag != 0, diag, 1.0)
    zz, yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                             np.arange(shape[2]), indexing="ij")
    rb = ((zz + yy + xx) % 2 == 0)
    return SysPfmgLevel(
        blocks=tuple(blocks),
        wm=None if wms is None else tuple(up(w) for w in wms),
        wp=None if wps is None else tuple(up(w) for w in wps),
        dinv=up(dinv), rb_mask=torch.as_tensor(rb, device=device),
        nvars=nvars, cdir=cdir, fine_shape=tuple(shape),
        coarse_shape=tuple(cshape if cshape else shape))


def _sys_relax(lvl: SysPfmgLevel, relax_type, weight, b, u, sweeps):
    for _ in range(sweeps):
        if relax_type in (0, 1):
            w = 1.0 if relax_type == 0 else weight
            if u is None:
                u = w * lvl.dinv * b
            else:
                u = u + w * lvl.dinv * (b - _sys_matvec(lvl, u))
        else:  # red-black GS over grid points (all vars per color)
            if u is None:
                u = torch.zeros_like(b)
            for color in (True, False):
                mask = lvl.rb_mask == color
                upd = u + lvl.dinv * (b - _sys_matvec(lvl, u))
                u = torch.where(mask[None], upd, u)
    return u


def _sys_interp(lvl: SysPfmgLevel, uc):
    d = lvl.cdir
    return torch.stack([interp_semi(uc[v], lvl.wm[v], lvl.wp[v], d,
                                    lvl.fine_shape[d])
                        for v in range(lvl.nvars)])


def _sys_restrict(lvl: SysPfmgLevel, rf):
    d = lvl.cdir
    return torch.stack([restrict_semi(rf[v], lvl.wm[v], lvl.wp[v], d,
                                      lvl.coarse_shape[d])
                        for v in range(lvl.nvars)])


def sys_pfmg_cycle(h: SysPfmgHierarchy, b):
    levels = h.levels
    nl = len(levels)
    us, bs = [], [b]
    for l in range(nl - 1):
        lvl = levels[l]
        u = _sys_relax(lvl, h.relax_type, h.weight, bs[l], None, h.n_pre)
        r = bs[l] - _sys_matvec(lvl, u)
        bs.append(_sys_restrict(lvl, r))
        us.append(u)

    lvl = levels[-1]
    bc = bs[-1].reshape(-1)
    uc = (h.c_dense_inv @ bc).reshape((lvl.nvars,) + lvl.fine_shape)

    for l in range(nl - 2, -1, -1):
        lvl = levels[l]
        u = us[l] + _sys_interp(lvl, uc)
        u = _sys_relax(lvl, h.relax_type, h.weight, bs[l], u, h.n_post)
        uc = u
    return uc
