"""Distributed struct solvers: ParPFMG, ParSMG, ParSysPFMG on z-slabs.

Port of hypre_tpu/struct/par_struct.py (``ParPFMG`` :42, ``ParSMG``
:205, ``ParSysPFMG`` :245, ``par_struct_pcg`` :268).  hypre distributes
a struct grid by boxes and exchanges their ghost layers (ref:
src/struct_mv/struct_communication.h:80; pfmg_setup.c:63).  The
reference shards the z axis of each (nz, ny, nx) array and lets XLA's
partitioner write the ±1-plane halo exchanges (par_struct.py:1-16).
The port makes them explicit:

* a level vector is stacked as z-slabs, ``nzl`` planes a shard, here
  laid out variable-major as ``(nvars, n_shards nzl, ny, nx)`` (the
  slabs one after another on the z axis; PFMG and SMG have one
  variable);
* an operation that couples planes (``struct_matvec``, restriction and
  interpolation along z) runs on the halo-extended slabs: one exchange
  brings each shard its neighbours' boundary planes, each slab becomes
  the block ``[0, lower halo, nzl planes, upper halo, 0]``, and the
  single-device function runs once on all blocks laid end to end, its
  level arrays cut the same way (true values in the halo planes, zero in
  the pad planes); each shard keeps its own planes;
* plane relaxation (SMG) and the x/y transfers act per plane, on the
  slabs as they are, with no exchange;
* levels whose z extent falls below the shard count are replicated (as
  in the reference, par_struct.py:34-40): the restriction into the first
  of them is gathered once (an all_gather of that coarse level), those
  levels run the single-device cycle, and the correction is cut back
  into slabs.

Every sharded level's slab height halves where the level coarsens z, so
the finest level's ``nzl`` is rounded up to a multiple of 2^k (k such
coarsenings above the replicated levels); the pad planes past nz hold
zero coefficients, weights and vectors, which the single-device
semantics give too.  The setups are the single-device ones (PFMG, SMG,
SysPFMG: the reference's numpy on the host), so the cycles compute the
single-device cycles' values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.parallel.comm import CommPkg, StackedComm, edge_halo_pkg
from hypre_tpu_torch.struct.grid import StructMatrix
from hypre_tpu_torch.struct.pfmg import (
    PFMG, PfmgConfig, interp_semi, restrict_semi,
)
from hypre_tpu_torch.struct.sys_pfmg import (
    SysPFMG, SysPfmgHierarchy, SysPfmgLevel, _sys_matvec, sys_pfmg_cycle,
)


def plane_halo_pkg(n_shards: int, nv: int, nzl: int, plane: int) -> CommPkg:
    """The ±1-plane halo of slabs stored (nv, nzl, plane) a shard: the
    previous shard's last plane and the next shard's first, of every
    variable."""
    v, j = np.divmod(np.arange(nv * plane), plane)
    return edge_halo_pkg(n_shards, v * nzl * plane + (nzl - 1) * plane + j,
                         v * nzl * plane + j)


@dataclasses.dataclass(frozen=True)
class Slabs:
    """The z-slab layout of one sharded level."""

    communicator: object
    nz: int
    nzl: int
    nv: int
    plane: tuple                    # (ny, nx)
    halo: CommPkg

    @property
    def nh(self) -> int:
        return self.communicator.n_held

    def _z(self, k0: int, k1: int, shift: int):
        """Global plane of block position k in [k0, k1) of each held
        shard (block k = plane p nzl + k - shift), -1 outside [0, nz)."""
        p = torch.arange(self.communicator.shards.start,
                         self.communicator.shards.start + self.nh)
        z = p[:, None] * self.nzl + torch.arange(k0, k1)[None, :] - shift
        return torch.where((z >= 0) & (z < self.nz), z, -1).reshape(-1)

    def cut(self, a: torch.Tensor, zaxis: int, ext: bool) -> torch.Tensor:
        """A global level array (true nz along zaxis) cut into the held
        slabs laid end to end: the halo blocks [pad, lo, nzl planes, hi,
        pad] (ext) or the bare slabs; zero past the grid and in the
        pad planes."""
        if ext:
            z = self._z(0, self.nzl + 4, 2)
            k = torch.arange(self.nzl + 4).repeat(self.nh)
            z = torch.where((k >= 1) & (k <= self.nzl + 2), z, -1)
        else:
            z = self._z(0, self.nzl, 0)
        z = z.to(a.device)
        out = a.index_select(zaxis, z.clamp(min=0))
        shape = [1] * a.dim()
        shape[zaxis] = -1
        return torch.where((z >= 0).reshape(shape), out, 0)

    def ext(self, x: torch.Tensor) -> torch.Tensor:
        """Slab vector (nv, nh nzl, ny, nx) -> halo blocks (nv, nh
        (nzl + 4), ny, nx): one exchange."""
        nv, nh, nzl = self.nv, self.nh, self.nzl
        ny, nx = self.plane
        xs = x.reshape(nv, nh, nzl, ny, nx).transpose(0, 1)
        g = self.communicator.exchange(xs.reshape(nh, -1), self.halo)
        m = nv * ny * nx
        lo = g[:, :m].reshape(nh, nv, 1, ny, nx)
        hi = g[:, m:2 * m].reshape(nh, nv, 1, ny, nx)
        z = torch.zeros_like(lo)
        e = torch.cat([z, lo, xs, hi, z], dim=2)
        return e.transpose(0, 1).reshape(nv, nh * (nzl + 4), ny, nx)

    def own(self, y_ext: torch.Tensor, width: int, lead: int,
            count: int) -> torch.Tensor:
        """Planes [lead, lead + count) of each block, the blocks `width`
        planes tall laid end to end: (nv, nh count, ...)."""
        nv = y_ext.shape[0]
        rest = tuple(y_ext.shape[2:])
        y = y_ext.reshape((nv, self.nh, width) + rest)[:, :, lead:lead + count]
        return y.reshape((nv, self.nh * count) + rest)

    def by_shard(self, x: torch.Tensor) -> torch.Tensor:
        """(nv, nh nzl, ny, nx) -> (nh, nv nzl ny nx): a shard's entries
        in one row, for the communicator's reductions."""
        return x.reshape(x.shape[0], self.nh, -1).transpose(0, 1)

    def scatter(self, v: torch.Tensor) -> torch.Tensor:
        """A replicated level vector (nv, nz, ny, nx) as held slabs."""
        return self.cut(v, 1, ext=False)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Held slabs -> the replicated vector (nv, nz, ny, nx)."""
        nv, nh, nzl = self.nv, self.nh, self.nzl
        ny, nx = self.plane
        xs = x.reshape(nv, nh, nzl * ny * nx).transpose(0, 1).contiguous()
        full = self.communicator.all_gather(xs)
        full = full.reshape(self.communicator.n_shards, nv, nzl, ny, nx)
        full = full.transpose(0, 1).reshape(nv, -1, ny, nx)
        return full[:, :self.nz]


def _cut_level(lvl: SysPfmgLevel, sl: Slabs, ext: bool) -> SysPfmgLevel:
    """A level's arrays cut into slabs (ext: halo blocks)."""
    def blk(M):
        if M is None:
            return None
        c = sl.cut(M.coefs, 1, ext)
        return StructMatrix(coefs=c, offsets=M.offsets,
                            shape=tuple(c.shape[1:]), periodic=M.periodic)

    def ws(t):
        return None if t is None else tuple(sl.cut(w, 0, ext) for w in t)

    d = sl.cut(lvl.dinv, 1, ext)
    shape = tuple(d.shape[1:])
    cshape = list(lvl.coarse_shape)
    if lvl.cdir > 0:
        cshape[0] = shape[0]
    return dataclasses.replace(
        lvl, blocks=tuple(blk(M) for M in lvl.blocks), wm=ws(lvl.wm),
        wp=ws(lvl.wp), dinv=d, rb_mask=sl.cut(lvl.rb_mask, 0, ext),
        fine_shape=shape, coarse_shape=tuple(cshape))


@dataclasses.dataclass(frozen=True)
class ParLevel:
    level: SysPfmgLevel             # the single-device level
    slabs: Slabs | None             # None: replicated
    ext: SysPfmgLevel | None        # cut into halo blocks
    loc: SysPfmgLevel | None        # cut into bare slabs
    extra: object = None            # ParSMG: the restacked plane cycle


def slab_layout(levels, n_shards: int) -> list:
    """Slab height of each level, None where replicated (z extent below
    the shard count, and the coarsest level, whose dense solve is
    replicated): the finest level's rounded up so that it halves
    exactly at every z-coarsening above the replicated levels."""
    sharded = [lvl.fine_shape[0] >= n_shards for lvl in levels[:-1]] \
        + [False]
    k = sum(1 for lvl, s in zip(levels, sharded) if s and lvl.cdir == 0)
    if not sharded[0]:
        return [None] * len(levels)
    q = 1 << k
    nzl = -(-(-(-levels[0].fine_shape[0] // n_shards)) // q) * q
    out = []
    for lvl, s in zip(levels, sharded):
        out.append(nzl if s else None)
        if s and lvl.cdir == 0:
            nzl //= 2
    return out


class _ParStructBase:
    """The slab engine shared by ParPFMG, ParSMG and ParSysPFMG: the
    level list (sys form), the sharded transfers and the solve loop."""

    def __init__(self, comm):
        self.comm = StackedComm(comm) if isinstance(comm, int) else comm
        self.levels: list[ParLevel] = []

    @property
    def n_shards(self) -> int:
        return self.comm.n_shards

    def _build(self, sys_levels):
        layout = slab_layout(sys_levels, self.n_shards)
        self.levels = []
        for lvl, nzl in zip(sys_levels, layout):
            if nzl is None:
                self.levels.append(ParLevel(lvl, None, None, None))
                continue
            _, ny, nx = lvl.fine_shape
            sl = Slabs(self.comm, lvl.fine_shape[0], nzl, lvl.nvars,
                       (ny, nx), plane_halo_pkg(self.n_shards, lvl.nvars,
                                                nzl, ny * nx))
            self.levels.append(ParLevel(lvl, sl, _cut_level(lvl, sl, True),
                                        _cut_level(lvl, sl, False)))
        self.n_sharded = sum(1 for p in self.levels if p.slabs is not None)

    # -- level operations (sharded level l) ----------------------------

    def matvec(self, l: int, u: torch.Tensor) -> torch.Tensor:
        pl = self.levels[l]
        if pl.slabs is None:
            return _sys_matvec(pl.level, u)
        y = _sys_matvec(pl.ext, pl.slabs.ext(u))
        return pl.slabs.own(y, pl.slabs.nzl + 4, 2, pl.slabs.nzl)

    def restrict(self, l: int, r: torch.Tensor) -> torch.Tensor:
        pl = self.levels[l]
        d = pl.level.cdir
        if d == 0:
            e = pl.slabs.ext(r)
            n_c = e.shape[1] // 2
            rc = torch.stack([restrict_semi(e[v], pl.ext.wm[v], pl.ext.wp[v],
                                            0, n_c)
                              for v in range(pl.level.nvars)])
            rc = pl.slabs.own(rc, pl.slabs.nzl // 2 + 2, 1,
                              pl.slabs.nzl // 2)
        else:
            rc = torch.stack([restrict_semi(r[v], pl.loc.wm[v], pl.loc.wp[v],
                                            d, pl.level.coarse_shape[d])
                              for v in range(pl.level.nvars)])
        nxt = self.levels[l + 1]
        if nxt.slabs is None:
            # into the replicated levels: gather the coarse level once
            return self._coarse_slabs(l).gather(rc)
        return rc

    def _coarse_slabs(self, l: int) -> Slabs:
        """Level l+1 in level l's slabs (its layout when it is sharded;
        for a replicated level, the slabs l's transfers produce)."""
        pl = self.levels[l]
        c = pl.level.coarse_shape
        return dataclasses.replace(
            pl.slabs, nz=c[0], plane=tuple(c[1:]),
            nzl=pl.slabs.nzl // 2 if pl.level.cdir == 0 else pl.slabs.nzl)

    def interp(self, l: int, uc: torch.Tensor) -> torch.Tensor:
        pl = self.levels[l]
        d = pl.level.cdir
        nxt = self.levels[l + 1]
        if d != 0:
            if nxt.slabs is None:
                uc = self._coarse_slabs(l).scatter(uc)
            return torch.stack([interp_semi(uc[v], pl.loc.wm[v], pl.loc.wp[v],
                                            d, pl.level.fine_shape[d])
                                for v in range(pl.level.nvars)])
        nzc = pl.slabs.nzl // 2
        if nxt.slabs is None:
            # blocks [lo, nzl/2 planes, hi] straight from the replicated uc
            half = self._coarse_slabs(l)
            ce = torch.stack([half.cut(uc[v], 0, ext=True) for v in
                              range(uc.shape[0])])
            ce = ce.reshape((uc.shape[0], pl.slabs.nh, nzc + 4)
                            + tuple(uc.shape[2:]))[:, :, 1:nzc + 3]
        else:
            ce = nxt.slabs.ext(uc).reshape(
                (uc.shape[0], pl.slabs.nh, nzc + 4)
                + tuple(uc.shape[2:]))[:, :, 1:nzc + 3]
        ce = ce.reshape((uc.shape[0], -1) + tuple(uc.shape[2:]))
        n_f = pl.slabs.nh * (pl.slabs.nzl + 4)
        uf = torch.stack([interp_semi(ce[v], pl.ext.wm[v], pl.ext.wp[v], 0,
                                      n_f) for v in range(uc.shape[0])])
        return pl.slabs.own(uf, pl.slabs.nzl + 4, 2, pl.slabs.nzl)

    # -- vectors and the solve loop ------------------------------------

    def to_level0(self, b) -> torch.Tensor:
        """A global (nv, nz, ny, nx) vector in level 0's layout."""
        sl = self.levels[0].slabs
        return b if sl is None else sl.scatter(b)

    def from_level0(self, x) -> torch.Tensor:
        sl = self.levels[0].slabs
        return x if sl is None else sl.gather(x)

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        """The global 2-norm of a level-0 vector: per shard, then over
        shards (a replicated level 0 is summed once)."""
        sl = self.levels[0].slabs
        if sl is None:
            return torch.linalg.vector_norm(x)
        return self.comm.norm(sl.by_shard(x))

    def solve_sys(self, b, tol, max_iter):
        """x += cycle(b - A x) until ||b - A x|| / ||b|| <= tol (the
        reference's loop, par_struct.py:139-160); b, x in level 0's
        layout.  Returns (x, iterations, relres)."""
        norm = self.norm
        x = torch.zeros_like(b)
        bnorm = float(norm(b))
        safe_b = bnorm if bnorm > 0 else 1.0
        rnorm = float(norm(b - self.matvec(0, x)))
        it = 0
        while it < max_iter and rnorm / safe_b > tol:
            x = x + self.cycle(b - self.matvec(0, x))
            rnorm = float(norm(b - self.matvec(0, x)))
            it += 1
        return x, it, rnorm / safe_b


def _pfmg_as_sys(lvl) -> SysPfmgLevel:
    """A PFMG (or SMG) level as a one-variable SysPFMG level."""
    one = None if lvl.wm is None else (lvl.wm,)
    return SysPfmgLevel(
        blocks=(lvl.A,), wm=one, wp=None if lvl.wp is None else (lvl.wp,),
        dinv=getattr(lvl, "dinv", torch.ones_like(lvl.A.coefs[0]))[None],
        rb_mask=getattr(lvl, "rb_mask", torch.ones(
            lvl.fine_shape, dtype=torch.bool, device=lvl.A.coefs.device)),
        nvars=1, cdir=lvl.cdir, fine_shape=tuple(lvl.fine_shape),
        coarse_shape=tuple(lvl.coarse_shape))


class _PfmgCycle(_ParStructBase):
    """The PFMG / SysPFMG V-cycle (pfmg_cycle, sys_pfmg_cycle) on
    slabs: relaxation, transfers and the coarsest solve as there."""

    def _relax(self, l, b, u, sweeps):
        pl = self.levels[l]
        h = self.sys_h
        for _ in range(sweeps):
            if h.relax_type in (0, 1):
                w = 1.0 if h.relax_type == 0 else h.weight
                lvl = pl.loc if pl.slabs is not None else pl.level
                if u is None:
                    u = w * lvl.dinv * b
                else:
                    u = u + w * lvl.dinv * (b - self.matvec(l, u))
            else:
                lvl = pl.loc if pl.slabs is not None else pl.level
                if u is None:
                    u = torch.zeros_like(b)
                for color in (True, False):
                    mask = lvl.rb_mask == color
                    upd = u + lvl.dinv * (b - self.matvec(l, u))
                    u = torch.where(mask[None], upd, u)
        return u

    def cycle(self, b: torch.Tensor) -> torch.Tensor:
        h = self.sys_h
        L = self.n_sharded
        us, bs = [], [b]
        for l in range(min(L, len(self.levels) - 1)):
            u = self._relax(l, bs[l], None, h.n_pre)
            r = bs[l] - self.matvec(l, u)
            bs.append(self.restrict(l, r))
            us.append(u)
        uc = sys_pfmg_cycle(dataclasses.replace(
            h, levels=h.levels[L:]), bs[-1]) if L < len(self.levels) \
            else None
        for l in range(len(us) - 1, -1, -1):
            u = us[l] + self.interp(l, uc)
            uc = self._relax(l, bs[l], u, h.n_post)
        return uc


class ParPFMG(_PfmgCycle):
    """Distributed PFMG: the host geometric setup of PFMG, each level cut
    into z-slabs (par_struct.py:42)."""

    def __init__(self, comm, config: PfmgConfig | None = None):
        super().__init__(comm)
        self.inner = PFMG(config)

    @property
    def hierarchy(self):
        return self.inner.hierarchy

    def setup(self, A: StructMatrix) -> "ParPFMG":
        h = self.inner.setup(A).hierarchy
        self.sys_h = SysPfmgHierarchy(
            levels=tuple(_pfmg_as_sys(lvl) for lvl in h.levels),
            c_dense_inv=h.c_dense_inv, relax_type=h.relax_type,
            weight=h.weight, n_pre=h.n_pre, n_post=h.n_post)
        self._build(self.sys_h.levels)
        return self

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        return self.cycle(r[None])[0]

    def solve(self, b, x0=None, tol=None, max_iter=None):
        """b: global (nz, ny, nx).  Returns (x global, iters, relres)."""
        from hypre_tpu_torch.core.config import as_real

        cfg = self.inner.config
        if x0 is not None:
            raise ValueError("ParPFMG.solve starts from x0 = 0")
        b = self.to_level0(as_real(b)[None])
        x, it, rel = self.solve_sys(
            b, float(tol if tol is not None else cfg.tol),
            int(max_iter or cfg.max_iter))
        return self.from_level0(x)[0], it, rel


class ParSysPFMG(_PfmgCycle):
    """Distributed SysPFMG (par_struct.py:245): the block-stencil
    hierarchy cut into z-slabs, all variables of a plane in one
    exchange."""

    def __init__(self, comm, config: PfmgConfig | None = None):
        super().__init__(comm)
        self.inner = SysPFMG(config)

    def setup(self, blocks, nvars: int, shape) -> "ParSysPFMG":
        self.sys_h = self.inner.setup(blocks, nvars, shape).hierarchy
        self._build(self.sys_h.levels)
        return self

    def solve(self, b, x0=None, tol=None, max_iter=None):
        """b: global (nvars, nz, ny, nx)."""
        from hypre_tpu_torch.core.config import as_real

        cfg = self.inner.config
        if x0 is not None:
            raise ValueError("ParSysPFMG.solve starts from x0 = 0")
        x, it, rel = self.solve_sys(
            self.to_level0(as_real(b)),
            float(tol if tol is not None else cfg.tol),
            int(max_iter or cfg.max_iter))
        return self.from_level0(x), it, rel


def _restack_planes(h, sl: Slabs):
    """A nested plane hierarchy (SMG's batched 2-D cycle over a level's
    nz planes) with every array's plane axis cut into the held slabs:
    the same per-plane cycle on the slab planes.  Pad planes get a unit
    line diagonal and zero elsewhere, so their solves stay zero."""
    def cut(a, axis, fill_one=False):
        if a is None:
            return None
        c = sl.cut(a, axis, ext=False)
        if fill_one:
            pad = sl.cut(torch.ones_like(a), axis, ext=False) == 0
            c = torch.where(pad, torch.ones_like(c), c)
        return c

    levels = []
    for lvl in h.levels:
        A = lvl.A
        coefs = cut(A.coefs, 1)
        shape = (coefs.shape[1],) + tuple(lvl.fine_shape[1:])
        levels.append(dataclasses.replace(
            lvl, A=StructMatrix(coefs=coefs, offsets=A.offsets, shape=shape,
                                periodic=A.periodic),
            wm=cut(lvl.wm, 0), wp=cut(lvl.wp, 0), line_a=cut(lvl.line_a, 0),
            line_b=cut(lvl.line_b, 0, fill_one=True),
            line_c=cut(lvl.line_c, 0), fine_shape=shape,
            coarse_shape=(shape[0],) + tuple(lvl.coarse_shape[1:])))
    c = h.c_dense_inv
    c = cut(c, 0) if c.dim() == 3 else c
    return dataclasses.replace(h, levels=tuple(levels), c_dense_inv=c)


class ParSMG(_ParStructBase):
    """Distributed SMG (par_struct.py:205): 3-D SMG's plane relaxation
    solves each slab's own planes (one nested 2-D cycle over all of them,
    no exchange); the residual before each zebra colour and the z
    transfers take their halos by exchange."""

    def __init__(self, comm, config=None):
        from hypre_tpu_torch.struct.smg import SMG

        super().__init__(comm)
        self.inner = SMG(config)

    def setup(self, A: StructMatrix) -> "ParSMG":
        h = self.inner.setup(A).hierarchy
        self.smg_h = h
        self._build([_pfmg_as_sys(lvl) for lvl in h.levels])
        for l, pl in enumerate(self.levels):
            lvl = h.levels[l]
            if pl.slabs is not None and lvl.plane2d is not None:
                self.levels[l] = dataclasses.replace(
                    pl, extra=_restack_planes(lvl.plane2d, pl.slabs))
        return self

    def _relax(self, l, f, u, sweeps, up):
        """3-D plane smoothing on slabs (smg._plane_relax): per zebra
        colour, the residual (one exchange) and one nested cycle."""
        from hypre_tpu_torch.struct.smg import smg_cycle

        pl = self.levels[l]
        if u is None:
            u = torch.zeros_like(f)
        colors = (1, 0) if up else (0, 1)
        sl = pl.slabs
        z = sl._z(0, sl.nzl, 0).to(f.device)
        for _ in range(sweeps):
            for parity in colors:
                r = f - self.matvec(l, u)
                e = smg_cycle(pl.extra, r[0])[None]
                mask = ((z >= 0) & (z % 2 == parity))[None, :, None, None]
                u = torch.where(mask, u + e, u)
        return u

    def cycle(self, b: torch.Tensor) -> torch.Tensor:
        from hypre_tpu_torch.struct.smg import smg_cycle

        h = self.smg_h
        L = self.n_sharded
        us, bs = [], [b]
        for l in range(min(L, len(self.levels) - 1)):
            u = self._relax(l, bs[l], None, h.n_pre, up=False)
            r = bs[l] - self.matvec(l, u)
            bs.append(self.restrict(l, r))
            us.append(u)
        uc = smg_cycle(dataclasses.replace(h, levels=h.levels[L:]),
                       bs[-1][0])[None] if L < len(self.levels) else None
        for l in range(len(us) - 1, -1, -1):
            u = us[l] + self.interp(l, uc)
            uc = self._relax(l, bs[l], u, h.n_post, up=True)
        return uc

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        return self.cycle(r[None])[0]

    def solve(self, b, x0=None, tol=None, max_iter=None):
        from hypre_tpu_torch.core.config import as_real

        cfg = self.inner.config
        if x0 is not None:
            raise ValueError("ParSMG.solve starts from x0 = 0")
        x, it, rel = self.solve_sys(
            self.to_level0(as_real(b)[None]),
            float(tol if tol is not None else cfg.tol),
            int(max_iter or cfg.max_iter))
        return self.from_level0(x)[0], it, rel


def par_struct_pcg(par: _ParStructBase, b, tol: float = 1e-7,
                   max_iter: int = 200):
    """CG preconditioned by the distributed cycle (the struct driver's
    solver 10/11 over shards, par_struct.py:268); x comes back global."""
    from hypre_tpu_torch.core.config import as_real
    from hypre_tpu_torch.solvers.krylov import KrylovResult, pcg

    b0 = par.to_level0(as_real(b)[None])
    shape = b0.shape
    sl = par.levels[0].slabs
    if sl is None:
        def put(v):
            return v.reshape(shape)

        def take(v):
            return v
        dot = norm = None
    else:
        def put(v):
            return v.reshape(sl.nh, 1, -1).transpose(0, 1).reshape(shape)

        take = sl.by_shard
        dot, norm = par.comm.dot, par.comm.norm
    res = pcg(lambda v: take(par.matvec(0, put(v))), take(b0),
              M=lambda r: take(par.cycle(put(r))), tol=tol,
              max_iter=max_iter, dot=dot, norm=norm)
    return KrylovResult(x=par.from_level0(put(res.x))[0], iters=res.iters,
                        relres=res.relres)
