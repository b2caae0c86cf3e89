"""Box calculus, multi-box StructGrid, and BoxManager.

Port of hypre_tpu/struct/boxes.py (numpy, copied; ``matrix_from_stencil``
returns the port's StructMatrix on the configured device).  The analog
of hypre's box machinery (ref: src/struct_mv/box.h:
20-60 hypre_Box, box_algebra.c hypre_SubtractBoxes/hypre_IntersectBoxes
/hypre_UnionBoxes, struct_grid.h:21-50 hypre_StructGrid with BoxArray +
periodic, box_manager.c hypre_BoxManager owner lookup).

Design: boxes and their algebra are host-side integer metadata, as in
hypre (they describe the problem, not the data path).  The device form
of a multi-box grid is its bounding box embedded as one dense array plus
an active-cell mask; inactive cells are carried as identity rows so
every struct operation (matvec, relax, PFMG RAP and cycles) runs
unchanged on the union domain.  hypre instead BoxLoops per box.

Index convention matches struct/grid.py: (z, y, x), inclusive bounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.core.config import get_device
from hypre_tpu_torch.struct.grid import StructMatrix


@dataclasses.dataclass(frozen=True)
class Box:
    """Inclusive index box [imin, imax] (hypre_Box, box.h:20)."""

    imin: tuple
    imax: tuple

    def __post_init__(self):
        object.__setattr__(self, "imin", tuple(int(v) for v in self.imin))
        object.__setattr__(self, "imax", tuple(int(v) for v in self.imax))

    @property
    def shape(self):
        return tuple(self.imax[d] - self.imin[d] + 1 for d in range(3))

    @property
    def volume(self):
        v = 1
        for d in range(3):
            e = self.imax[d] - self.imin[d] + 1
            if e <= 0:
                return 0
            v *= e
        return v

    def contains(self, idx) -> bool:
        return all(self.imin[d] <= idx[d] <= self.imax[d]
                   for d in range(3))

    def intersect(self, o: "Box") -> "Box | None":
        """hypre_IntersectBoxes (box_algebra.c)."""
        lo = tuple(max(self.imin[d], o.imin[d]) for d in range(3))
        hi = tuple(min(self.imax[d], o.imax[d]) for d in range(3))
        if any(lo[d] > hi[d] for d in range(3)):
            return None
        return Box(lo, hi)

    def subtract(self, o: "Box") -> list:
        """self minus o as disjoint boxes (hypre_SubtractBoxes): peel
        up to two slabs per axis outside the overlap."""
        ov = self.intersect(o)
        if ov is None:
            return [self]
        out = []
        rem = self
        for d in range(3):
            if rem.imin[d] < ov.imin[d]:
                hi = list(rem.imax)
                hi[d] = ov.imin[d] - 1
                out.append(Box(rem.imin, tuple(hi)))
            if rem.imax[d] > ov.imax[d]:
                lo = list(rem.imin)
                lo[d] = ov.imax[d] + 1
                out.append(Box(tuple(lo), rem.imax))
            lo = list(rem.imin)
            hi = list(rem.imax)
            lo[d] = ov.imin[d]
            hi[d] = ov.imax[d]
            rem = Box(tuple(lo), tuple(hi))
        return out


class BoxArray:
    """Ordered list of boxes with union semantics (hypre_BoxArray)."""

    def __init__(self, boxes=()):
        self.boxes = [b if isinstance(b, Box) else Box(*b)
                      for b in boxes]

    def __len__(self):
        return len(self.boxes)

    def __iter__(self):
        return iter(self.boxes)

    def append(self, b: Box):
        self.boxes.append(b)

    def union_disjoint(self) -> "BoxArray":
        """Disjoint cover of the union (hypre_UnionBoxes): subtract
        each earlier box from each later one."""
        out: list[Box] = []
        for b in self.boxes:
            frags = [b]
            for prev in out:
                frags = [p for f in frags for p in f.subtract(prev)]
            out.extend(f for f in frags if f.volume > 0)
        return BoxArray(out)

    def intersect(self, other: "BoxArray") -> "BoxArray":
        out = []
        for a in self.boxes:
            for b in other.boxes:
                iv = a.intersect(b)
                if iv is not None:
                    out.append(iv)
        return BoxArray(out)

    def subtract(self, other: "BoxArray") -> "BoxArray":
        frags = list(self.union_disjoint().boxes)
        for o in other.boxes:
            frags = [p for f in frags for p in f.subtract(o)
                     if p.volume > 0]
        return BoxArray(frags)

    @property
    def volume(self):
        return sum(b.volume for b in self.union_disjoint().boxes)

    def bounding_box(self) -> Box:
        lo = tuple(min(b.imin[d] for b in self.boxes) for d in range(3))
        hi = tuple(max(b.imax[d] for b in self.boxes) for d in range(3))
        return Box(lo, hi)


class BoxManager:
    """Owner lookup: index -> (entry id, box) (hypre_BoxManager,
    box_manager.c hypre_BoxManIntersect).  Entries are (box, owner)
    pairs; lookup is a vectorized numpy containment test — the
    reference builds sorted index tables for the same O(entries) scan
    per query batch."""

    def __init__(self):
        self._boxes: list[Box] = []
        self._owners: list[int] = []

    def add_entry(self, box: Box, owner: int):
        self._boxes.append(box)
        self._owners.append(owner)

    def gather(self, idx) -> list:
        """All (owner, box) whose box contains idx."""
        return [(o, b) for b, o in zip(self._boxes, self._owners)
                if b.contains(idx)]

    def owners_of(self, idx_array: np.ndarray) -> np.ndarray:
        """Vectorized first-owner per query row (-1 if none).
        idx_array: (m, 3)."""
        q = np.asarray(idx_array)
        out = np.full(len(q), -1, dtype=np.int64)
        for b, o in zip(reversed(self._boxes), reversed(self._owners)):
            lo = np.array(b.imin)
            hi = np.array(b.imax)
            inside = np.all((q >= lo) & (q <= hi), axis=1)
            out = np.where(inside, o, out)
        return out

    def intersect(self, box: Box) -> list:
        """All entries intersecting box (hypre_BoxManIntersect)."""
        out = []
        for b, o in zip(self._boxes, self._owners):
            iv = b.intersect(box)
            if iv is not None:
                out.append((o, iv))
        return out


class StructGrid:
    """Multi-box structured grid (hypre_StructGrid: BoxArray +
    periodic).  Device form: bounding box + active mask."""

    def __init__(self, boxes, periodic=(0, 0, 0)):
        self.boxes = boxes if isinstance(boxes, BoxArray) \
            else BoxArray(boxes)
        if len(self.boxes) == 0:
            raise ValueError("StructGrid needs at least one box")
        self.periodic = tuple(int(p) for p in periodic)
        bb = self.boxes.bounding_box()
        self.origin = bb.imin
        self.shape = bb.shape
        mask = np.zeros(self.shape, dtype=bool)
        for b in self.boxes:
            sl = tuple(slice(b.imin[d] - self.origin[d],
                             b.imax[d] - self.origin[d] + 1)
                       for d in range(3))
            mask[sl] = True
        self.mask = mask
        self.manager = BoxManager()
        for i, b in enumerate(self.boxes):
            self.manager.add_entry(b, i)

    @property
    def local_size(self):
        return int(self.mask.sum())

    def matrix_from_stencil(self, entries, dtype=np.float64,
                            variable=None):
        """Stencil operator on the box union: coefficients masked so
        every connection stays inside active cells (Dirichlet on the
        union boundary, wrap on periodic axes); inactive cells become
        identity rows so all struct kernels run unchanged on the
        embedding."""
        shape = self.shape
        offsets = tuple(off for off, _ in entries)
        coefs = np.zeros((len(entries),) + shape, dtype=dtype)
        act = self.mask
        for k, (off, v) in enumerate(entries):
            c = np.asarray(variable[off], dtype=dtype) if (
                variable and off in variable) else np.full(
                    shape, v, dtype=dtype)
            # neighbor activity at index+off (wrap on periodic axes)
            nb = act
            for d in range(3):
                if off[d] == 0:
                    continue
                if self.periodic[d]:
                    nb = np.roll(nb, -off[d], axis=d)
                else:
                    nb = _np_shift_bool(nb, d, off[d])
            coefs[k] = np.where(act & nb, c, 0.0)
        # identity rows on inactive cells
        for k, off in enumerate(offsets):
            if off == (0, 0, 0):
                coefs[k] = np.where(act, coefs[k], 1.0)
        return StructMatrix(coefs=torch.as_tensor(coefs, device=get_device()),
                            offsets=offsets, shape=tuple(shape),
                            periodic=self.periodic)

    def vector(self, fill=1.0, dtype=np.float64):
        """Grid vector: `fill` on active cells, 0 outside."""
        return np.where(self.mask, np.asarray(fill, dtype=dtype), 0.0)


def _np_shift_bool(m, axis, off):
    """m evaluated at index+off along axis, False outside."""
    out = np.zeros_like(m)
    n = m.shape[axis]
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    if off >= 0:
        src[axis] = slice(off, n)
        dst[axis] = slice(0, n - off)
    else:
        src[axis] = slice(0, n + off)
        dst[axis] = slice(-off, n)
    out[tuple(dst)] = m[tuple(src)]
    return out
