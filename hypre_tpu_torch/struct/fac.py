"""FAC — fast adaptive composite-grid solver for structured AMR.

Port of hypre_tpu/struct/fac.py, the analog of hypre's sstruct FAC
(ref: src/sstruct_ls/fac_setup2.c:19 composite-matrix setup,
fac_solve3.c cycle, fac_restrict2.c / fac_interp2.c transfers; the
algorithm is McCormick's FAC).

The COMPOSITE grid of a 2-level AMR pair = the coarse cells outside
the refined patch plus the fine cells inside it.  Setup assembles the
composite operator explicitly, in scipy on the host as the reference
does:

  * coarse row, coarse neighbor: the coarse stencil coefficient
  * coarse row, neighbor under the patch: the coefficient distributed
    over that coarse cell's 2^d fine children (constant interpolation
    across the interface — hypre's fac_cf ident/interp stencils)
  * fine row, fine neighbor: the fine stencil coefficient
  * fine row, ghost outside the patch: the coefficient lands on the
    coarse cell containing the ghost

One FAC cycle on the composite system: smooth the FINE block (patch
relaxation), coarse-grid correction e = A_c^{-1} R r with the Galerkin
coarse operator (R = identity outside the patch, 2^d-cell averaging
inside; P = constant prolongation), smooth the fine block again.  The
coarse correction is one cycle of the port's BoomerAMG.  The composite
operator, R and P are uploaded to the configured device once
(``sparse_op_from_scipy``), so the cycle runs on the device; vectors
are tensors there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.core.config import as_real
from hypre_tpu_torch.ops.formats import matvec, sparse_op_from_scipy
from hypre_tpu_torch.struct.grid import StructMatrix


@dataclasses.dataclass
class FacConfig:
    n_pre: int = 3
    n_post: int = 3
    jacobi_weight: float = 0.8
    tol: float = 1e-8
    max_iter: int = 100


class FAC:
    """Two-level composite FAC solver (the AMR pair building block)."""

    def __init__(self, Ac: StructMatrix, fine_entries,
                 patch_lo: tuple, patch_hi: tuple,
                 config: FacConfig | None = None):
        """fine_entries: the UNtruncated fine stencil
        [((dz,dy,dx), value)] — arms crossing the patch boundary
        couple to the underlying coarse cells (a pre-truncated
        StructMatrix would have lost those coefficients)."""
        self.config = config or FacConfig()
        self.Ac = Ac
        self.fine_entries = [(tuple(o), float(v))
                             for o, v in fine_entries]
        self.lo = tuple(patch_lo)
        self.hi = tuple(patch_hi)
        self._setup()

    # -- composite assembly (fac_setup2.c analog) ----------------------

    def _setup(self):
        Ac = self.Ac
        lo, hi = self.lo, self.hi
        cs = Ac.shape                       # coarse grid shape
        ref = tuple(2 if cs[d] > 1 else 1 for d in range(3))
        fs = tuple((hi[d] - lo[d]) * ref[d] for d in range(3))
        self.fine_shape = fs

        cidx = -np.ones(cs, dtype=np.int64)
        inside = np.zeros(cs, dtype=bool)
        inside[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
        n_cout = int((~inside).sum())
        cidx[~inside] = np.arange(n_cout)
        fidx = np.arange(np.prod(fs)).reshape(fs) + n_cout
        n_comp = n_cout + int(np.prod(fs))
        nchild = int(np.prod(ref))

        rows, cols, vals = [], [], []
        Acn = Ac.coefs.cpu().numpy()
        cz, cy, cx = np.meshgrid(*[np.arange(s) for s in cs],
                                 indexing="ij")

        def children(z, y, x):
            """fine ids of coarse cell (z,y,x) inside the patch."""
            base = ((z - lo[0]) * ref[0], (y - lo[1]) * ref[1],
                    (x - lo[2]) * ref[2])
            out = []
            for dz in range(ref[0]):
                for dy in range(ref[1]):
                    for dx in range(ref[2]):
                        out.append(fidx[base[0] + dz, base[1] + dy,
                                        base[2] + dx])
            return out

        # coarse rows
        for k, off in enumerate(Ac.offsets):
            nz2 = cz + off[0]
            ny2 = cy + off[1]
            nx2 = cx + off[2]
            ok = ((~inside) & (nz2 >= 0) & (nz2 < cs[0]) & (ny2 >= 0)
                  & (ny2 < cs[1]) & (nx2 >= 0) & (nx2 < cs[2]))
            src = cidx[cz[ok], cy[ok], cx[ok]]
            tz, ty, tx = nz2[ok], ny2[ok], nx2[ok]
            t_in = inside[tz, ty, tx]
            c = Acn[k][cz[ok], cy[ok], cx[ok]]
            # neighbor outside the patch: coarse-coarse entry
            rows.append(src[~t_in])
            cols.append(cidx[tz[~t_in], ty[~t_in], tx[~t_in]])
            vals.append(c[~t_in])
            # neighbor under the patch: distribute over the children
            if t_in.any():
                for zi, yi, xi, si, ci in zip(tz[t_in], ty[t_in],
                                              tx[t_in], src[t_in],
                                              c[t_in]):
                    ch = children(zi, yi, xi)
                    rows.append(np.full(nchild, si))
                    cols.append(np.asarray(ch))
                    vals.append(np.full(nchild, ci / nchild))

        # fine rows (untruncated stencil constants)
        fz, fy, fx = np.meshgrid(*[np.arange(s) for s in fs],
                                 indexing="ij")
        for off, cval in self.fine_entries:
            nz2 = fz + off[0]
            ny2 = fy + off[1]
            nx2 = fx + off[2]
            in_f = ((nz2 >= 0) & (nz2 < fs[0]) & (ny2 >= 0)
                    & (ny2 < fs[1]) & (nx2 >= 0) & (nx2 < fs[2]))
            c = np.full(fs, cval)
            src = fidx[fz, fy, fx]
            # interior fine-fine
            rows.append(src[in_f])
            cols.append(fidx[nz2[in_f], ny2[in_f], nx2[in_f]])
            vals.append(c[in_f])
            # ghost: coarse cell containing the fine ghost position
            gsel = ~in_f & (c != 0)
            if gsel.any():
                gz = lo[0] + nz2[gsel] // ref[0]
                gy = lo[1] + ny2[gsel] // ref[1]
                gx = lo[2] + nx2[gsel] // ref[2]
                ok2 = ((gz >= 0) & (gz < cs[0]) & (gy >= 0)
                       & (gy < cs[1]) & (gx >= 0) & (gx < cs[2]))
                # positions outside the global domain stay Dirichlet
                gsrc = src[gsel][ok2]
                gcol = cidx[gz[ok2], gy[ok2], gx[ok2]]
                live = gcol >= 0     # (could be under the patch: no)
                rows.append(gsrc[live])
                cols.append(gcol[live])
                vals.append(c[gsel][ok2][live])

        A = sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(n_comp, n_comp))
        A.sum_duplicates()
        self.A_comp = A
        self.n_cout = n_cout
        self.cidx, self.fidx, self.inside = cidx, fidx, inside
        self.ref = ref

        # restriction composite -> full coarse grid: identity outside,
        # child-average inside; prolongation = constant injection
        nc = int(np.prod(cs))
        call = np.arange(nc).reshape(cs)
        r_rows = [call[~inside]]
        r_cols = [cidx[~inside]]
        r_vals = [np.ones(n_cout)]
        for z in range(lo[0], hi[0]):
            for y in range(lo[1], hi[1]):
                for x in range(lo[2], hi[2]):
                    ch = children(z, y, x)
                    r_rows.append(np.full(nchild, call[z, y, x]))
                    r_cols.append(np.asarray(ch))
                    r_vals.append(np.full(nchild, 1.0 / nchild))
        R = sp.csr_matrix(
            (np.concatenate(r_vals),
             (np.concatenate(r_rows), np.concatenate(r_cols))),
            shape=(nc, n_comp))
        self.R = R
        # constant prolongation: every composite dof takes its coarse
        # cell's value with weight 1 (identity outside, injection into
        # the children inside)
        self.P = R.T.tocsr()
        self.P.data = np.ones_like(self.P.data)

        # coarse-correction operator: the GALERKIN product over the
        # composite (this is what fac_setup2.c assembles — under the
        # patch the raw coarse stencil underestimates the refined
        # stiffness and the correction diverges), solved by BoomerAMG
        from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG

        self.A_cc = (R @ A @ self.P).tocsr()
        self.coarse = BoomerAMG(AmgConfig(interp_type=3,
                                          relax_type=18)).setup(
            self.A_cc)
        d = A.diagonal()
        self.dinv = as_real(1.0 / np.where(d != 0, d, 1.0))
        fine_mask = np.zeros(n_comp)
        fine_mask[n_cout:] = 1.0
        self.fine_mask = as_real(fine_mask)
        self.A_op = sparse_op_from_scipy(A)
        self.R_op = sparse_op_from_scipy(R)
        self.P_op = sparse_op_from_scipy(self.P)

    # -- cycle ---------------------------------------------------------

    def _smooth_fine(self, b, x, sweeps):
        w = self.config.jacobi_weight
        for _ in range(sweeps):
            r = b - matvec(self.A_op, x)
            x = x + w * (self.dinv * r) * self.fine_mask
        return x

    def cycle(self, b, x):
        """One composite FAC V-cycle (fac_solve3.c structure)."""
        from hypre_tpu_torch.solvers.amg import amg_cycle

        cfg = self.config
        x = self._smooth_fine(b, x, cfg.n_pre)
        r = b - matvec(self.A_op, x)
        ec = amg_cycle(self.coarse.hierarchy, matvec(self.R_op, r))
        x = x + matvec(self.P_op, ec)
        x = self._smooth_fine(b, x, cfg.n_post)
        return x

    def solve(self, b, tol=None, max_iter=None):
        """Returns (x, iterations, relres); b a composite vector."""
        cfg = self.config
        tol = tol if tol is not None else cfg.tol
        max_iter = max_iter or cfg.max_iter
        b = as_real(b)
        x = torch.zeros_like(b)
        b0 = float(torch.linalg.vector_norm(b))
        b0 = b0 if b0 > 0 else 1.0
        it, rel = 0, 1.0
        while it < max_iter:
            x = self.cycle(b, x)
            rel = float(torch.linalg.vector_norm(
                b - matvec(self.A_op, x))) / b0
            it += 1
            if rel <= tol:
                break
        return x, it, rel

    # -- composite vector helpers --------------------------------------

    def composite_rhs(self, f_coarse, f_fine):
        """Assemble the composite rhs (numpy) from per-grid arrays."""
        b = np.zeros(self.A_comp.shape[0])
        b[self.cidx[~self.inside]] = np.asarray(f_coarse)[~self.inside]
        b[self.n_cout:] = np.asarray(f_fine).ravel()
        return b
