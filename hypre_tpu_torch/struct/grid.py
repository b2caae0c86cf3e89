"""Structured-grid matrix/vector machinery.

Port of hypre_tpu/struct/grid.py, the analog of hypre's struct_mv
(ref: src/struct_mv/struct_matrix.h:21-60, struct_matvec.c:96).  A
structured vector is a 3-D tensor (nz, ny, nx); a structured matrix is
a stencil: coefficient arrays over the grid, one per offset (dz, dy,
dx).  Arrays are indexed [z, y, x], x the unit-stride axis.

``struct_matvec`` adds one term an offset, in the reference's order,
into the slice of y whose neighbour lies inside the grid:
``y[dst] += c[k][dst] * u[src]`` (one ``addcmul_`` launch an offset,
no padded copy of u); a periodic axis is wrapped with ``torch.roll``
as the reference's ``jnp.roll`` does.

The host helpers (``host_coefs``, ``_np_shift``, ``stencil_multiply``)
are numpy copies of the reference's: the struct setup runs on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.core.config import get_config, get_device


@dataclasses.dataclass(frozen=True)
class StructMatrix:
    """coefs: real[n_offsets, nz, ny, nx]; offsets: tuple[(dz,dy,dx)].

    coefs[k][z,y,x] multiplies u[z+dz, y+dy, x+dx]; entries reaching
    outside the grid must have zero coefficients (setup enforces it).
    periodic[d] != 0 makes axis d wrap (hypre StructGridSetPeriodic):
    shifts along that axis become circular rolls.
    """

    coefs: torch.Tensor
    offsets: tuple
    shape: tuple  # (nz, ny, nx)
    periodic: tuple = (0, 0, 0)

    @property
    def n_rows(self):
        nz, ny, nx = self.shape
        return nz * ny * nx


def _window(off, shape):
    """(dst, src) slices: y[dst] takes u[src], the neighbour at +off,
    over the points whose neighbour lies inside the grid."""
    dst, src = [], []
    for d, n in zip(off, shape):
        dst.append(slice(max(0, -d), n - max(0, d)))
        src.append(slice(max(0, d), n + min(0, d)))
    return tuple(dst), tuple(src)


def struct_matvec(A: StructMatrix, u: torch.Tensor) -> torch.Tensor:
    """y = A u (hypre_StructMatvecCompute analog)."""
    per = A.periodic
    y = torch.zeros_like(u)
    for k, off in enumerate(A.offsets):
        per_axes = [d for d in range(3) if per[d] and off[d]]
        v = u
        if per_axes:
            v = torch.roll(u, shifts=[-off[d] for d in per_axes],
                           dims=per_axes)
            off = tuple(0 if d in per_axes else off[d] for d in range(3))
        dst, src = _window(off, A.shape)
        y[dst].addcmul_(A.coefs[k][dst], v[src])
    return y


def struct_matrix_from_stencil(shape, entries, dtype=None,
                               variable=None) -> StructMatrix:
    """A constant-coefficient stencil matrix with Dirichlet truncation
    (entries reaching outside get zero coefficient), on the configured
    device.

    entries: [((dz,dy,dx), value)]; variable: optional dict of
    offset -> ndarray overriding constants.  dtype: a numpy dtype of the
    host build (the configured one by default).
    """
    device = get_device()
    dtype = dtype or np_real()
    nz, ny, nx = shape
    offsets = tuple(off for off, _ in entries)
    coefs = np.zeros((len(entries), nz, ny, nx), dtype=dtype)
    for k, (off, v) in enumerate(entries):
        if variable and off in variable:
            c = np.asarray(variable[off], dtype=dtype)
        else:
            c = np.full(shape, v, dtype=dtype)
        dz, dy, dx = off
        # zero out coefficients whose target leaves the grid
        zs = slice(max(0, -dz), nz - max(0, dz))
        ys = slice(max(0, -dy), ny - max(0, dy))
        xs = slice(max(0, -dx), nx - max(0, dx))
        mask = np.zeros(shape, dtype=bool)
        mask[zs, ys, xs] = True
        coefs[k] = np.where(mask, c, 0.0)
    return StructMatrix(coefs=torch.as_tensor(coefs, device=device),
                        offsets=offsets, shape=tuple(shape))


def struct_laplacian(nz, ny, nx, cz=1.0, cy=1.0, cx=1.0,
                     dtype=None) -> StructMatrix:
    """7-pt (or lower-D) struct Laplacian matching gen.laplacian."""
    diag = 0.0
    entries = []
    if nx > 1:
        diag += 2.0 * cx
        entries += [((0, 0, -1), -cx), ((0, 0, 1), -cx)]
    if ny > 1:
        diag += 2.0 * cy
        entries += [((0, -1, 0), -cy), ((0, 1, 0), -cy)]
    if nz > 1:
        diag += 2.0 * cz
        entries += [((-1, 0, 0), -cz), ((1, 0, 0), -cz)]
    entries.append(((0, 0, 0), diag))
    return struct_matrix_from_stencil((nz, ny, nx), entries, dtype)


# ---------------------------------------------------------------------------
# host-side stencil algebra (setup phase)
# ---------------------------------------------------------------------------

def np_real() -> type:
    """The numpy dtype of the configured real dtype (the host setup's)."""
    return np.float64 if get_config().real_dtype == torch.float64 \
        else np.float32


def host_coefs(A: StructMatrix):
    return {off: A.coefs[k].cpu().numpy() for k, off in enumerate(A.offsets)}


def _np_shift(c, off, shape):
    """numpy twin of a zero-filled shift, for host-side stencil
    products."""
    dz, dy, dx = off
    out = np.zeros(shape, dtype=c.dtype)
    src = []
    dst = []
    for d, n in zip((dz, dy, dx), shape):
        if d >= 0:
            src.append(slice(d, n))
            dst.append(slice(0, n - d))
        else:
            src.append(slice(0, n + d))
            dst.append(slice(-d, n))
    out[tuple(dst)] = c[tuple(src)]
    return out


def stencil_multiply(A: dict, B: dict, shape) -> dict:
    """C = A·B on stencil dicts: C[oa+ob][i] += A[oa][i]·B[ob][i+oa]
    (variable-coefficient stencil composition; host numpy).

    The struct analog of the fused stencil RAP computations (ref:
    src/struct_ls/pfmg3_setup_rap.c) in general form.
    """
    out = {}
    for oa, ca in A.items():
        for ob, cb in B.items():
            oc = tuple(x + y for x, y in zip(oa, ob))
            term = ca * _np_shift(cb, oa, shape)
            if oc in out:
                out[oc] = out[oc] + term
            else:
                out[oc] = term
    return {o: c for o, c in out.items() if np.any(c)}
