"""Structured-grid problem generators (host side).

Re-implementation of the semantics of hypre's test-problem generators
(ref: src/parcsr_ls/par_laplace.c:63 GenerateLaplacian,
par_laplace_9pt.c, par_laplace_27pt.c, par_difconv.c) used by the ij
driver and its benchmark suite:

* `-n nx ny nz` is the GLOBAL grid; grid points are ordered x-fastest.
* Dirichlet boundaries by stencil truncation: neighbor entries outside
  the grid are dropped while the diagonal stays constant, so rows at
  the boundary are strictly diagonally dominant (SPD M-matrix).
* 7-pt:  diag 2(cx+cy+cz) (terms included only for dims > 1),
  offdiag -cx/-cy/-cz        (ref: src/test/ij.c:9703-9718).
* 9-pt (2D): all 8 neighbors -1, diag 8 (fewer on lower-dim grids).
* 27-pt: all 26 neighbors -1, diag 26.
* difconv: 7-pt convection-diffusion with upwind/centered convection
  terms (ref: src/test/ij.c:10184-10303, src/parcsr_ls/par_difconv.c).

Matrices are returned as scipy CSR in the library's host setup format;
device operators are derived via ops.formats conversions.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def stencil_matrix(shape, entries, dtype=np.float64) -> sp.csr_matrix:
    """Build a matrix from stencil `entries` = [((dx,dy,dz), value), ...]
    on a grid of `shape` = (nx, ny, nz), x-fastest ordering, Dirichlet
    truncation at the boundary.

    Constructs CSR directly (no COO sort): stencil offsets are sorted
    by linear displacement, so concatenating each row's valid offsets
    in that order yields sorted column indices by construction."""
    nx, ny, nz = shape
    n = nx * ny * nz

    from hypre_tpu_torch.setup.utils import native_enabled

    if native_enabled():
        from hypre_tpu_torch.csrc import build as native

        return native.stencil_csr(shape, entries, dtype)

    ents = sorted(((d, v) for d, v in entries if v != 0.0),
                  key=lambda e: e[0][0] + nx * (e[0][1] + ny * e[0][2]))
    K = len(ents)
    # valid[k] as a separable product of 1D masks; built at 3D grid
    # shape (nz, ny, nx) C-order = x-fastest linear order
    valid = np.empty((K, nz, ny, nx), dtype=bool)
    disp = np.empty(K, dtype=np.int64)
    val_k = np.empty(K, dtype=dtype)
    ax = np.arange(nx)
    ay = np.arange(ny)
    az = np.arange(nz)
    for k, ((dx, dy, dz), v) in enumerate(ents):
        mx = (ax + dx >= 0) & (ax + dx < nx)
        my = (ay + dy >= 0) & (ay + dy < ny)
        mz = (az + dz >= 0) & (az + dz < nz)
        valid[k] = mz[:, None, None] & my[None, :, None] & mx[None, None, :]
        disp[k] = dx + nx * (dy + ny * dz)
        val_k[k] = v
    vflat = valid.reshape(K, n)
    counts = vflat.sum(axis=0, dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    # position of entry (k, i): indptr[i] + (#valid offsets < k at i)
    rank = np.cumsum(vflat, axis=0, dtype=np.int64) - 1
    pos = (indptr[:-1][None, :] + rank)[vflat]
    nnz = int(indptr[-1])
    indices = np.empty(nnz, dtype=np.int32)
    data = np.empty(nnz, dtype=dtype)
    lin = np.arange(n, dtype=np.int64)
    src_cols = (lin[None, :] + disp[:, None])[vflat]
    src_vals = np.broadcast_to(val_k[:, None], (K, n))[vflat]
    indices[pos] = src_cols
    data[pos] = src_vals
    A = sp.csr_matrix((data, indices, indptr), shape=(n, n), dtype=dtype)
    return A


def laplacian(nx, ny=1, nz=1, cx=1.0, cy=1.0, cz=1.0,
              dtype=np.float64) -> sp.csr_matrix:
    """5/7-point Laplacian (2D when nz==1, 1D when ny==nz==1)."""
    diag = 0.0
    entries = []
    if nx > 1:
        diag += 2.0 * cx
        entries += [((-1, 0, 0), -cx), ((1, 0, 0), -cx)]
    if ny > 1:
        diag += 2.0 * cy
        entries += [((0, -1, 0), -cy), ((0, 1, 0), -cy)]
    if nz > 1:
        diag += 2.0 * cz
        entries += [((0, 0, -1), -cz), ((0, 0, 1), -cz)]
    entries.append(((0, 0, 0), diag))
    return stencil_matrix((nx, ny, nz), entries, dtype)


def laplacian_9pt(nx, ny, dtype=np.float64) -> sp.csr_matrix:
    """2D 9-point Laplacian: 8 neighbors of -1, diagonal balances them."""
    entries = []
    diag = 0.0
    if nx > 1:
        diag += 2.0
    if ny > 1:
        diag += 2.0
    if nx > 1 and ny > 1:
        diag += 4.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            entries.append(((dx, dy, 0), -1.0))
    entries.append(((0, 0, 0), diag))
    return stencil_matrix((nx, ny, 1), entries, dtype)


def laplacian_27pt(nx, ny, nz, dtype=np.float64) -> sp.csr_matrix:
    """3D 27-point Laplacian: 26 neighbors of -1, diag 26
    (ref: src/parcsr_ls/par_laplace_27pt.c; 26 when all dims > 1)."""
    if nx > 1 and ny > 1 and nz > 1:
        diag = 26.0
    elif nx == 1 and ny == 1 or ny == 1 and nz == 1 or nx == 1 and nz == 1:
        diag = 2.0
    else:
        diag = 8.0
    entries = [((0, 0, 0), diag)]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                entries.append(((dx, dy, dz), -1.0))
    return stencil_matrix((nx, ny, nz), entries, dtype)


def difconv(nx, ny, nz, cx=1.0, cy=1.0, cz=1.0,
            ax=0.0, ay=0.0, az=0.0, atype=0,
            dtype=np.float64) -> sp.csr_matrix:
    """7-pt convection-diffusion operator.

    atype 0: forward scheme for convection (conditionally stable);
    atype 3: centered differences — matching ij driver -atype semantics
    (ref: src/test/ij.c:10184+).  Grid spacing h = 1/(n+1) per dim.
    """
    hx, hy, hz = 1.0 / (nx + 1), 1.0 / (ny + 1), 1.0 / (nz + 1)
    dcx, dcy, dcz = cx / hx**2, cy / hy**2, cz / hz**2
    if atype == 0:  # forward/upwind
        w = -dcx - ax / hx   # west  (x-1)
        e = -dcx             # east  (x+1)
        s = -dcy - ay / hy
        n_ = -dcy
        b = -dcz - az / hz
        u = -dcz
        diag = (2 * dcx + ax / hx) + (2 * dcy + ay / hy) + (2 * dcz + az / hz)
    else:  # centered
        w = -dcx - ax / (2 * hx)
        e = -dcx + ax / (2 * hx)
        s = -dcy - ay / (2 * hy)
        n_ = -dcy + ay / (2 * hy)
        b = -dcz - az / (2 * hz)
        u = -dcz + az / (2 * hz)
        diag = 2 * dcx + 2 * dcy + 2 * dcz
    entries = [((0, 0, 0), diag)]
    if nx > 1:
        entries += [((-1, 0, 0), w), ((1, 0, 0), e)]
    if ny > 1:
        entries += [((0, -1, 0), s), ((0, 1, 0), n_)]
    if nz > 1:
        entries += [((0, 0, -1), b), ((0, 0, 1), u)]
    return stencil_matrix((nx, ny, nz), entries, dtype)


def rotate_7pt(nx, ny, alpha_deg, eps, dtype=np.float64) -> sp.csr_matrix:
    """2D rotated anisotropic 7-point operator
    (ref: src/parcsr_ls/par_rotate_7pt.c:63-73): diffusion rotated by
    alpha degrees with anisotropy ratio eps."""
    x = np.pi * alpha_deg / 180.0
    s, c = np.sin(x), np.cos(x)
    ac = -(c * c + eps * s * s)
    bc = 2.0 * (1.0 - eps) * s * c
    cc = -(s * s + eps * c * c)
    diag = -2 * (2 * ac + bc + 2 * cc)
    vx = 2 * ac + bc
    vy = bc + 2 * cc
    vd = -bc
    entries = [((0, 0, 0), diag),
               ((-1, 0, 0), vx), ((1, 0, 0), vx),
               ((0, -1, 0), vy), ((0, 1, 0), vy),
               ((-1, -1, 0), vd), ((1, 1, 0), vd)]
    return stencil_matrix((nx, ny, 1), entries, dtype)


def vardifconv(nx, ny, nz, contrast=1e3, seed=7, dtype=np.float64):
    """Variable-coefficient diffusion: checkerboard jumps of magnitude
    `contrast` (the hypre -vardifconv problem class,
    ref: src/parcsr_ls/par_vardifconv.c — coefficient field differs but
    exercises the same variable-coefficient code paths)."""
    rng = np.random.RandomState(seed)
    # coefficient per cell block (4^3 blocks)
    bx = np.maximum(nx // 4, 1)
    kz = rng.rand((nz + bx - 1) // bx + 1, (ny + bx - 1) // bx + 1,
                  (nx + bx - 1) // bx + 1) > 0.5
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    coef = np.where(kz[iz // bx, iy // bx, ix // bx], contrast, 1.0)
    coef = coef.astype(dtype)  # (nx, ny, nz) x-fastest ordering fields

    n = nx * ny * nz
    lin = (ix + nx * (iy + ny * iz)).ravel()
    rows, cols, vals = [], [], []
    diag_acc = np.zeros((nx, ny, nz), dtype=dtype)
    for (dx, dy, dz) in [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                         (0, 0, -1), (0, 0, 1)]:
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
              & (jz >= 0) & (jz < nz))
        # harmonic mean of the two cells' coefficients
        cj = coef[np.clip(jx, 0, nx - 1), np.clip(jy, 0, ny - 1),
                  np.clip(jz, 0, nz - 1)]
        w = 2.0 * coef * cj / (coef + cj)
        w = np.where(ok, w, coef)   # boundary: one-sided
        diag_acc += w
        okf = ok.ravel()
        tgt = (np.clip(jx, 0, nx - 1)
               + nx * (np.clip(jy, 0, ny - 1)
                       + ny * np.clip(jz, 0, nz - 1))).ravel()
        rows.append(lin[okf])
        cols.append(tgt[okf])
        vals.append(-w.ravel()[okf])
    rows.append(lin)
    cols.append(lin)
    vals.append(diag_acc.ravel())
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    A.sort_indices()
    return A
