"""PFMG — semicoarsening geometric multigrid on structured grids.

Port of hypre_tpu/struct/pfmg.py, the analog of hypre's PFMG (ref:
src/struct_ls/pfmg_setup.c:63, pfmg_solve.c:31).

Setup runs on the host in numpy, as the reference's does, with copies
of its helpers (``_pick_cdir``, ``_interp_weights``, ``_sample``,
``_semicoarsen_rap``, ``_stencil_to_dense``): per level the direction
of strongest coupling, coarsening by 2 (coarse planes at even fine
indices), collapsed-stencil interpolation weights
(w_minus = -(sum of coefs with off_d < 0) / (sum with off_d = 0)), and
the Galerkin coarse stencil.  Each level is uploaded once to the
configured device; the coarsest operator's dense inverse too.

The cycle is torch on the device: weighted Jacobi (hypre's default
relax_type 1, ref: pfmg.c:33) or red-black Gauss-Seidel, the
semicoarsening interpolation and its transpose, the dense coarsest
solve.  ``PFMG.solve`` is a host loop with one residual-norm sync an
iteration, in place of the reference's jitted while_loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import as_real, get_device
from hypre_tpu_torch.struct.grid import (
    StructMatrix, _np_shift, np_real, struct_matvec,
)


@dataclasses.dataclass
class PfmgConfig:
    max_levels: int = 25
    max_coarse_size: int = 32     # stop when total points fall below
    relax_type: int = 1           # 0 Jacobi, 1 wJacobi, 2 RB-GS
    jacobi_weight: float = 2.0 / 3.0
    num_pre_relax: int = 1
    num_post_relax: int = 1
    skip_relax: bool = False
    tol: float = 1e-6
    max_iter: int = 100


@dataclasses.dataclass(frozen=True)
class PfmgLevel:
    A: StructMatrix
    wm: Optional[torch.Tensor]  # interp weights at odd planes (fine grid)
    wp: Optional[torch.Tensor]
    dinv: torch.Tensor          # 1 / diagonal
    rb_mask: torch.Tensor       # checkerboard mask for RB-GS (bool)
    cdir: int                   # coarsening axis (0=z,1=y,2=x); -1 coarsest
    fine_shape: tuple
    coarse_shape: tuple


@dataclasses.dataclass(frozen=True)
class PfmgHierarchy:
    levels: tuple
    c_dense_inv: torch.Tensor   # dense inverse of coarsest operator
    relax_type: int
    weight: float
    n_pre: int
    n_post: int


class PFMG:
    def __init__(self, config: PfmgConfig | None = None):
        self.config = config or PfmgConfig()
        self.hierarchy: PfmgHierarchy | None = None
        self.level_shapes: list[tuple] = []

    # -- setup --------------------------------------------------------

    def setup(self, A: StructMatrix) -> "PFMG":
        cfg = self.config
        device = get_device()
        real = np_real()
        Ad = {off: A.coefs[k].cpu().numpy().astype(real, copy=False)
              for k, off in enumerate(A.offsets)}
        shape = tuple(A.shape)

        levels = []
        for _ in range(cfg.max_levels - 1):
            if int(np.prod(shape)) <= cfg.max_coarse_size:
                break
            cdir = _pick_cdir(Ad, shape)
            if cdir is None or shape[cdir] < 3:
                break
            wm, wp = _interp_weights(Ad, shape, cdir, real)
            Ac, cshape = _semicoarsen_rap(Ad, wm, wp, cdir, shape)
            levels.append(_device_level(Ad, shape, cdir, wm, wp, cshape,
                                        real, device))
            Ad, shape = Ac, cshape

        levels.append(_device_level(Ad, shape, -1, None, None, shape, real,
                                    device))
        dense = _stencil_to_dense(Ad, shape, real)
        c_inv = torch.as_tensor(np.linalg.inv(dense).astype(real),
                                device=device)

        self.hierarchy = PfmgHierarchy(
            levels=tuple(levels), c_dense_inv=c_inv,
            relax_type=cfg.relax_type, weight=cfg.jacobi_weight,
            n_pre=cfg.num_pre_relax, n_post=cfg.num_post_relax)
        self.level_shapes = [lvl.fine_shape for lvl in levels]
        return self

    # -- solve --------------------------------------------------------

    def solve(self, b, x0=None, tol=None, max_iter=None):
        """Standalone PFMG iteration; returns (x, iterations, relres)."""
        cfg = self.config
        h = self.hierarchy
        A0 = h.levels[0].A
        return mg_solve(
            lambda u: struct_matvec(A0, u), lambda r: pfmg_cycle(h, r),
            as_real(b, A0.coefs.dtype), x0,
            float(tol if tol is not None else cfg.tol),
            int(max_iter or cfg.max_iter))

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        return pfmg_cycle(self.hierarchy, r)


def mg_solve(Aop, cycle, b, x0, tol: float, max_iter: int):
    """x += cycle(b - A x) until ||b - A x|| / ||b|| <= tol: the
    reference's ``_pfmg_solve_jit`` loop (pfmg.py:390-409) on the host,
    one norm sync an iteration.  Returns (x, iterations, relres)."""
    x = torch.zeros_like(b) if x0 is None else as_real(x0, b.dtype)
    bnorm = float(torch.linalg.vector_norm(b))
    safe_b = bnorm if bnorm > 0 else 1.0
    r = b - Aop(x)
    rnorm = float(torch.linalg.vector_norm(r))
    it = 0
    while it < max_iter and rnorm / safe_b > tol:
        x = x + cycle(r)
        r = b - Aop(x)
        rnorm = float(torch.linalg.vector_norm(r))
        it += 1
    return x, it, rnorm / safe_b


def _device_level(Ad, shape, cdir, wm, wp, cshape, real, device):
    """One level's operator, weights, inverse diagonal and red-black
    mask, uploaded to the device."""
    offs = tuple(sorted(Ad.keys()))
    coefs = np.stack([Ad[o] for o in offs]).astype(real)
    diag = Ad.get((0, 0, 0))
    dinv = 1.0 / np.where(diag != 0, diag, 1.0)
    zz, yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                             np.arange(shape[2]), indexing="ij")
    rb = ((zz + yy + xx) % 2 == 0)

    def up(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a.astype(real)), device=device)

    return PfmgLevel(
        A=StructMatrix(coefs=up(coefs), offsets=offs, shape=tuple(shape)),
        wm=up(wm), wp=up(wp), dinv=up(dinv),
        rb_mask=torch.as_tensor(rb, device=device),
        cdir=cdir, fine_shape=tuple(shape), coarse_shape=tuple(cshape))


# ---------------------------------------------------------------------------
# setup helpers (host)
# ---------------------------------------------------------------------------

def _pick_cdir(Ad, shape):
    """Direction of strongest coupling (smallest effective grid
    spacing; ref: pfmg_setup.c:216-300 dxyz logic)."""
    strengths = []
    for d in range(3):
        if shape[d] < 3:
            strengths.append(-np.inf)
            continue
        s = 0.0
        for off, c in Ad.items():
            if off[d] != 0 and all(off[e] == 0 for e in range(3) if e != d):
                s += float(np.abs(c).mean())
        strengths.append(s)
    best = int(np.argmax(strengths))
    if strengths[best] <= 0:
        return None
    return best


def _interp_weights(Ad, shape, d, real):
    """Collapsed-stencil interpolation weights at every grid point
    (used at odd planes): w_m = -sum(off_d<0)/sum(off_d==0)."""
    neg = np.zeros(shape, dtype=real)
    pos = np.zeros(shape, dtype=real)
    mid = np.zeros(shape, dtype=real)
    for off, c in Ad.items():
        if off[d] < 0:
            neg += c
        elif off[d] > 0:
            pos += c
        else:
            mid += c
    mid = np.where(mid != 0, mid, 1.0)
    return (-neg / mid).astype(real), (-pos / mid).astype(real)


def _sample(arr, d, delta, off_perp, fine_shape, coarse_n):
    """array over the coarse grid: arr at fine pos (2I + delta) along
    axis d, shifted by off_perp (a 3-tuple, 0 in axis d) elsewhere."""
    a = _np_shift(arr, off_perp, fine_shape)
    n_f = fine_shape[d]
    out_shape = list(fine_shape)
    out_shape[d] = coarse_n
    out = np.zeros(out_shape, dtype=arr.dtype)
    # fine index f = 2I + delta must satisfy 0 <= f < n_f
    i_min = max(0, (-delta + 1) // 2)
    i_max = min(coarse_n, (n_f - delta + 1) // 2)
    if i_max <= i_min:
        return out
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    src[d] = slice(2 * i_min + delta, 2 * (i_max - 1) + delta + 1, 2)
    dst[d] = slice(i_min, i_max)
    out[tuple(dst)] = a[tuple(src)]
    return out


def _semicoarsen_rap(Ad, wm, wp, d, shape):
    """Galerkin coarse stencil for semicoarsening by 2 along axis d.

    Ac[I] entries from Ac = R A P with
      (P u_c)[f] = u_c[f/2]                       (f_d even)
                 = wm(f) u_c[(f-1)/2] + wp(f) u_c[(f+1)/2]   (odd)
      (R r)[I]   = r[2I] + wm(2I+1) r[2I+1] + wp(2I-1) r[2I-1]
    """
    return _semicoarsen_rap_rect(Ad, wm, wp, wm, wp, d, shape)


def _semicoarsen_rap_rect(Ad, wmR, wpR, wmP, wpP, d, shape):
    """Galerkin coarse stencil Ac = R A P for semicoarsening along d,
    with the restriction (row variable) and prolongation (column
    variable) weights given apart — SysPFMG's off-diagonal blocks (ref:
    sys_pfmg_setup_rap.c); ``_semicoarsen_rap`` when they are one."""
    n_f = shape[d]
    n_c = (n_f + 1) // 2
    cshape = list(shape)
    cshape[d] = n_c
    cshape = tuple(cshape)

    ones = np.ones(shape, dtype=next(iter(Ad.values())).dtype)
    # R terms: (t, weight array on fine grid)
    r_terms = [(0, ones), (1, wmR), (-1, wpR)]
    # P terms at fine index f: (s, weight at f) with coarse index
    # (f + s)/2; s chosen by parity of f
    out = {}
    for t, rw in r_terms:
        for off, ac in Ad.items():
            o_d = off[d]
            for s, pw in [(0, None), (-1, wmP), (1, wpP)]:
                tot = t + o_d + s
                if tot % 2 != 0:
                    continue
                # s=0 requires f'' = 2I+t+o_d even (t+o_d even); s=±1
                # requires it odd
                if (s == 0) != ((t + o_d) % 2 == 0):
                    continue
                O_d = tot // 2
                # contribution at coarse I:
                #   rw(2I+t) * A[off](2I+t) * pw(2I+t+off)
                c1 = _sample(rw * ac, d, t, (0, 0, 0), shape, n_c)
                if pw is None:
                    c2 = 1.0
                else:
                    shift_vec = tuple(off[e] if e != d else 0
                                      for e in range(3))
                    c2 = _sample(pw, d, t + o_d, shift_vec, shape, n_c)
                term = c1 * c2
                oc = tuple(O_d if e == d else off[e] for e in range(3))
                if oc in out:
                    out[oc] += term
                else:
                    out[oc] = term
    out = {o: c for o, c in out.items() if np.any(c)}
    return out, cshape


def _dense_index(off, shape):
    """The rows and columns of offset off's entries in the dense matrix
    of a stencil on shape, and the window (z, y, x slices) of the
    points that hold them."""
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    dz, dy, dx = off
    zs = slice(max(0, -dz), shape[0] - max(0, dz))
    ys = slice(max(0, -dy), shape[1] - max(0, dy))
    xs = slice(max(0, -dx), shape[2] - max(0, dx))
    src = idx[zs, ys, xs].ravel()
    tgt = idx[slice(max(0, dz), shape[0] + min(0, dz)),
              slice(max(0, dy), shape[1] + min(0, dy)),
              slice(max(0, dx), shape[2] + min(0, dx))].ravel()
    return src, tgt, (zs, ys, xs)


def _stencil_to_dense(Ad, shape, real):
    n = int(np.prod(shape))
    dense = np.zeros((n, n), dtype=real)
    for off, c in Ad.items():
        src, tgt, win = _dense_index(off, shape)
        dense[src, tgt] += c[win].ravel()
    return dense


# ---------------------------------------------------------------------------
# solve-phase kernels (torch on the device)
# ---------------------------------------------------------------------------

def _pfmg_relax(lvl: PfmgLevel, relax_type, weight, b, u, sweeps):
    for _ in range(sweeps):
        if relax_type in (0, 1):
            w = 1.0 if relax_type == 0 else weight
            if u is None:
                u = w * lvl.dinv * b
            else:
                u = u + w * lvl.dinv * (b - struct_matvec(lvl.A, u))
        else:  # red-black Gauss-Seidel (ref: red_black_gs.c)
            if u is None:
                u = torch.zeros_like(b)
            for color in (True, False):
                mask = lvl.rb_mask == color
                upd = u + lvl.dinv * (b - struct_matvec(lvl.A, u))
                u = torch.where(mask, upd, u)
    return u


def _axis(d, s):
    """Index tuple taking slice s along axis d, everything elsewhere."""
    out = [slice(None)] * 3
    out[d] = s
    return tuple(out)


def interp_semi(uc, wm, wp, d: int, n_f: int):
    """u_f = P u_c for semicoarsening along axis d: even planes take
    u_c, odd plane 2I+1 takes wm*u_c[I] + wp*u_c[I+1] (no u_c[I+1]
    past the last coarse plane)."""
    n_c = uc.shape[d]
    n_odd = n_f // 2
    n_hi = min(n_odd, n_c - 1)
    od = _axis(d, slice(1, n_f, 2))
    wm_o, wp_o = wm[od], wp[od]
    odd = wm_o * uc[_axis(d, slice(0, n_odd))]
    odd[_axis(d, slice(0, n_hi))].addcmul_(
        wp_o[_axis(d, slice(0, n_hi))], uc[_axis(d, slice(1, n_hi + 1))])
    shape = list(uc.shape)
    shape[d] = n_f
    uf = torch.empty(shape, dtype=uc.dtype, device=uc.device)
    uf[_axis(d, slice(0, n_f, 2))] = uc
    uf[od] = odd
    return uf


def restrict_semi(rf, wm, wp, d: int, n_c: int):
    """r_c = P^T r_f: r_c[J] = r_f[2J] + wm(2J+1) r_f[2J+1]
    + wp(2J-1) r_f[2J-1]."""
    n_f = rf.shape[d]
    od = _axis(d, slice(1, n_f, 2))
    r_odd = rf[od]
    n_odd = r_odd.shape[d]
    rc = rf[_axis(d, slice(0, n_f, 2))].clone()
    # wm(2J+1)*r(2J+1) adds to coarse J
    take = min(n_odd, n_c)
    rc[_axis(d, slice(0, take))] += (wm[od] * r_odd)[_axis(d, slice(0, take))]
    # wp(2J+1)*r(2J+1) adds to coarse J+1
    take2 = min(n_odd, n_c - 1)
    rc[_axis(d, slice(1, 1 + take2))] += \
        (wp[od] * r_odd)[_axis(d, slice(0, take2))]
    return rc


def _interp_apply(lvl, uc):
    """u_f = P u_c for semicoarsening along lvl.cdir (any level with
    wm, wp, cdir and fine_shape: PFMG's, SMG's)."""
    return interp_semi(uc, lvl.wm, lvl.wp, lvl.cdir,
                       lvl.fine_shape[lvl.cdir])


def _restrict_apply(lvl, rf):
    """r_c = P^T r_f."""
    return restrict_semi(rf, lvl.wm, lvl.wp, lvl.cdir,
                         lvl.coarse_shape[lvl.cdir])


def pfmg_cycle(h: PfmgHierarchy, b):
    """One V-cycle, zero initial guess."""
    levels = h.levels
    nl = len(levels)
    us, bs = [], [b]
    for l in range(nl - 1):
        lvl = levels[l]
        u = _pfmg_relax(lvl, h.relax_type, h.weight, bs[l], None, h.n_pre)
        r = bs[l] - struct_matvec(lvl.A, u)
        bs.append(_restrict_apply(lvl, r))
        us.append(u)

    lvl = levels[-1]
    uc = (h.c_dense_inv @ bs[-1].reshape(-1)).reshape(lvl.fine_shape)

    for l in range(nl - 2, -1, -1):
        lvl = levels[l]
        u = us[l] + _interp_apply(lvl, uc)
        u = _pfmg_relax(lvl, h.relax_type, h.weight, bs[l], u, h.n_post)
        uc = u
    return uc
