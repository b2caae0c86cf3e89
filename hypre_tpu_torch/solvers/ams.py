"""AMS, ADS and AME: the auxiliary-space solvers for H(curl) and H(div).

Port of hypre_tpu/solvers/ams.py, the analog of hypre's AMS (ref:
src/parcsr_ls/ams.c:2928 hypre_AMSSetup).  For an edge-element matrix
A = curl-curl + mass, plain AMG fails (the gradient near-nullspace is
huge); the Hiptmair-Xu auxiliary-space decomposition preconditions with

    M^{-1} = S  +  G B_G G^T  +  Pi B_Pi Pi^T

where
  S     — edge smoother (l1-Jacobi),
  G     — the discrete gradient (edges x nodes incidence, user input
          as in the reference's HYPRE_AMSSetDiscreteGradient),
  B_G   — BoomerAMG on the nodal Poisson-like matrix G^T A G,
  Pi    — nodal-vector to edge interpolation,
  B_Pi  — BoomerAMG on Pi^T A Pi (vector-nodal space).

This is the additive cycle of the reference.  The setups are the
reference's numpy/scipy on the host (two BoomerAMG host setups, bit for
bit the reference's hierarchies); G, G^T, Pi, Pi^T and every level are
uploaded once, and an application runs on the configured device: K2 on
the CSR operators, K3 on a DIA level, the dense matvec on small ones.

The problem builders (``maxwell_2d``, ``derham_3d``, ``maxwell_3d``,
``rt0_3d``, ``rt0_2d``) are numpy/scipy copies of the reference's and
give its CSR matrices bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG, amg_cycle

# relative diagonal shifts of the auxiliary matrices (ams.py:66 and :74)
GRAD_SHIFT = 1e-12
NODAL_SHIFT = 1e-10


@dataclasses.dataclass
class AmsConfig:
    amg: AmgConfig = dataclasses.field(
        default_factory=lambda: AmgConfig(interp_type=6))
    smooth_sweeps: int = 1


def shifted(M: sp.spmatrix, rel: float) -> sp.csr_matrix:
    """M + rel * max|diag(M)| * I: keeps a singular auxiliary matrix's
    sub-AMG (and its coarse LU) well posed."""
    M = M.tocsr()
    return (M + sp.identity(M.shape[0])
            * rel * abs(M.diagonal()).max()).tocsr()


def gradient_matrix(A: sp.spmatrix, G: sp.spmatrix) -> sp.csr_matrix:
    """G^T A G with the reference's shift (ams.py:63-66): the gradient
    space matrix can be singular for pure curl-curl."""
    return shifted((G.T @ A @ G).tocsr(), GRAD_SHIFT)


def nodal_vector_matrix(A: sp.spmatrix, Pi: sp.spmatrix) -> sp.csr_matrix:
    """Pi^T A Pi with the reference's shift (ams.py:71-74): it is
    rank-deficient whenever the nodal-vector space exceeds the edge
    space."""
    return shifted((Pi.T @ A @ Pi).tocsr(), NODAL_SHIFT)


def _transfer_ops(pairs):
    """CSR (or dense) operators of M and M^T for each (name, M)."""
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

    out = {}
    for name, M in pairs:
        M = M.tocsr()
        out[name] = sparse_op_from_scipy(M, prefer_dia=False)
        out[name + "t"] = sparse_op_from_scipy(M.T.tocsr(),
                                               prefer_dia=False)
    return out


def _inverse_l1(A: sp.csr_matrix) -> torch.Tensor:
    from hypre_tpu_torch.core.config import as_real
    from hypre_tpu_torch.setup.l1norms import l1_norms

    return as_real(1.0 / l1_norms(A, 1))


class AMS:
    def __init__(self, config: AmsConfig | None = None):
        self.config = config or AmsConfig()
        self.bg = None
        self.bpi = None
        self.G = None
        self.Pi = None
        self.dinv = None

    def setup(self, A: sp.csr_matrix, G: sp.csr_matrix,
              Pi: sp.csr_matrix) -> "AMS":
        """A: edge matrix; G: discrete gradient (n_edges x n_nodes);
        Pi: nodal-vector interpolation (n_edges x dim*n_nodes)."""
        from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

        A = A.tocsr()
        self.A_op = sparse_op_from_scipy(A)
        self.dinv = _inverse_l1(A)
        self.bg = BoomerAMG(self.config.amg).setup(gradient_matrix(A, G))
        self.bpi = BoomerAMG(self.config.amg).setup(
            nodal_vector_matrix(A, Pi))
        ops = _transfer_ops((("G", G), ("Pi", Pi)))
        self.G, self.Gt = ops["G"], ops["Gt"]
        self.Pi, self.Pit = ops["Pi"], ops["Pit"]
        return self

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        """Additive auxiliary-space cycle (ams.py:84-98)."""
        from hypre_tpu_torch.ops.formats import matvec

        z = self.dinv * r
        zg = matvec(self.G, amg_cycle(self.bg.hierarchy,
                                      matvec(self.Gt, r)))
        zp = matvec(self.Pi, amg_cycle(self.bpi.hierarchy,
                                       matvec(self.Pit, r)))
        return z + zg + zp


# ---------------------------------------------------------------------------
# reference problem builder (the ex15 analog): 2D lowest-order Nedelec
# curl-curl + mass on a uniform grid
# ---------------------------------------------------------------------------

def maxwell_2d(n: int, beta: float = 1.0):
    """Build (A, G, Pi) for E-field H(curl): A = C^T C + beta * M_e on
    an n x n uniform grid (unit cells).  Edge dofs: first the
    horizontal (x) edges, then the vertical (y) edges."""
    nn = (n + 1) * (n + 1)            # nodes
    nex = n * (n + 1)                 # x-edges
    ney = (n + 1) * n                 # y-edges

    def node(i, j):
        return j * (n + 1) + i

    def xedge(i, j):                  # from (i,j) to (i+1,j)
        return j * n + i

    def yedge(i, j):                  # from (i,j) to (i,j+1)
        return nex + i * n + j

    rows, cols, vals = [], [], []

    def addG(e, nneg, npos):
        rows.extend([e, e])
        cols.extend([nneg, npos])
        vals.extend([-1.0, 1.0])

    for j in range(n + 1):
        for i in range(n):
            addG(xedge(i, j), node(i, j), node(i + 1, j))
    for i in range(n + 1):
        for j in range(n):
            addG(yedge(i, j), node(i, j), node(i, j + 1))
    G = sp.coo_matrix((vals, (rows, cols)),
                      shape=(nex + ney, nn)).tocsr()

    # curl: one row per cell, +- the four edges around it
    crows, ccols, cvals = [], [], []
    for j in range(n):
        for i in range(n):
            c = j * n + i
            crows += [c, c, c, c]
            ccols += [xedge(i, j), xedge(i, j + 1),
                      yedge(i + 1, j), yedge(i, j)]
            cvals += [1.0, -1.0, 1.0, -1.0]
    C = sp.coo_matrix((cvals, (crows, ccols)),
                      shape=(n * n, nex + ney)).tocsr()

    A = (C.T @ C + beta * sp.identity(nex + ney)).tocsr()

    # Pi: nodal vector (ux at nodes, uy at nodes) -> tangential edge
    # averages
    prows, pcols, pvals = [], [], []
    for j in range(n + 1):
        for i in range(n):
            e = xedge(i, j)
            prows += [e, e]
            pcols += [node(i, j), node(i + 1, j)]        # ux block
            pvals += [0.5, 0.5]
    for i in range(n + 1):
        for j in range(n):
            e = yedge(i, j)
            prows += [e, e]
            pcols += [nn + node(i, j), nn + node(i, j + 1)]  # uy block
            pvals += [0.5, 0.5]
    Pi = sp.coo_matrix((pvals, (prows, pcols)),
                       shape=(nex + ney, 2 * nn)).tocsr()
    return A, G, Pi


class ADS:
    """ADS — auxiliary-space H(div) solver (ref: src/parcsr_ls/ads.c
    hypre_ADSSetup; ams.py:168-243).

    One rung up the de Rham complex from AMS: for a face-element
    matrix A = div-div + mass,

        M^{-1} = S + C B_C C^T + Pi B_Pi Pi^T

    with C the discrete curl (faces x edges), B_C an AMS cycle on the
    edge matrix A_C = C^T A C, and Pi the nodal-vector to face
    interpolation with B_Pi = BoomerAMG on Pi^T A Pi.

    setup(A, C, Pi, G=G, Pi_e=Pi_e) with the edge-space discrete
    gradient G and edge interpolation Pi_e gives the full 3D solver;
    without them the edge correction is a plain AMG on C^T A C (the 2D
    rotation case, where AMS == AMG on gradients).
    """

    def __init__(self, config: AmsConfig | None = None):
        self.config = config or AmsConfig()
        self.dinv = None
        self.bc_ams = None      # inner AMS on the edge space
        self.bc_amg = None      # fallback: plain AMG on C^T A C
        self.bpi = None

    def setup(self, A: sp.csr_matrix, C: sp.csr_matrix,
              Pi: sp.csr_matrix, G: sp.csr_matrix | None = None,
              Pi_e: sp.csr_matrix | None = None) -> "ADS":
        """A: face matrix; C: discrete curl (n_faces x n_edges);
        Pi: nodal-vector to face interpolation; G: edges x nodes
        discrete gradient (enables the inner AMS); Pi_e: nodal-vector
        to edge interpolation for the inner AMS."""
        A = A.tocsr()
        self.dinv = _inverse_l1(A)
        AC = shifted((C.T @ A @ C).tocsr(), GRAD_SHIFT)
        if G is not None and Pi_e is not None:
            self.bc_ams = AMS(self.config).setup(AC, G, Pi_e)
        else:
            self.bc_amg = BoomerAMG(self.config.amg).setup(AC)
        self.bpi = BoomerAMG(self.config.amg).setup(
            nodal_vector_matrix(A, Pi))
        ops = _transfer_ops((("C", C), ("Pi", Pi)))
        self.C, self.Ct = ops["C"], ops["Ct"]
        self.Pi, self.Pit = ops["Pi"], ops["Pit"]
        return self

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        from hypre_tpu_torch.ops.formats import matvec

        z = self.dinv * r
        rc = matvec(self.Ct, r)
        if self.bc_ams is not None:
            zc = self.bc_ams.precondition(rc)
        else:
            zc = amg_cycle(self.bc_amg.hierarchy, rc)
        z = z + matvec(self.C, zc)
        zp = matvec(self.Pi, amg_cycle(self.bpi.hierarchy,
                                       matvec(self.Pit, r)))
        return z + zp


class AME:
    """AME — Maxwell eigensolver (ref: src/parcsr_ls/ame.c; ams.py:
    245-301): LOBPCG on the edge curl-curl matrix, preconditioned by
    AMS, with the gradient (curl-free) subspace projected out of every
    application: x <- x - G (G^T G)^{-1} G^T x, the nodal solve a few
    AMG-PCG steps on the node Laplacian G^T G."""

    def __init__(self, config: AmsConfig | None = None,
                 proj_iters: int = 15):
        self.config = config or AmsConfig()
        self.proj_iters = proj_iters

    def setup(self, A: sp.csr_matrix, G: sp.csr_matrix,
              Pi: sp.csr_matrix) -> "AME":
        self.ams = AMS(self.config).setup(A, G, Pi)
        self.bgtg = BoomerAMG(self.config.amg).setup((G.T @ G).tocsr())
        ops = _transfer_ops((("G", G),))
        self.G, self.Gt = ops["G"], ops["Gt"]
        self.A_op = self.ams.A_op
        return self

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """Remove the discrete-gradient component."""
        from hypre_tpu_torch.ops.formats import matvec
        from hypre_tpu_torch.solvers.krylov import pcg

        g = matvec(self.Gt, x)
        y = pcg(self.bgtg.hierarchy.levels[0].A, g, M=self.bgtg,
                tol=1e-10, max_iter=self.proj_iters).x
        return x - matvec(self.G, y)

    def solve(self, nev: int, tol: float = 1e-6, max_iter: int = 100,
              seed: int = 0):
        """Smallest nev nonzero (non-gradient) eigenpairs.  The start
        block is drawn on the host by numpy's RandomState(seed), as the
        reference draws it (ams.py:290), and uploaded."""
        from hypre_tpu_torch.core.config import as_real
        from hypre_tpu_torch.ops.formats import matvec
        from hypre_tpu_torch.solvers.lobpcg import lobpcg

        n = self.A_op.shape[0]
        X0 = as_real(np.random.RandomState(seed).rand(n, nev))
        X0 = torch.stack([self._project(X0[:, j].contiguous())
                          for j in range(nev)], dim=1)

        def Aop(v):
            return self._project(matvec(self.A_op, v))

        def Mop(r):
            return self._project(self.ams.precondition(r))

        return lobpcg(Aop, X0, M=Mop, tol=tol, max_iter=max_iter)


def derham_3d(n: int):
    """Discrete de Rham complex on the unit-cube n^3 uniform grid with
    lowest-order elements (the ex15 discretization; ref:
    src/examples/ex15.c): returns (G, C, D, Pi_e, Pi_f) with

      G  (n_edges x n_nodes)      discrete gradient
      C  (n_faces x n_edges)      discrete curl
      D  (n_cells x n_faces)      discrete divergence
      Pi_e (n_edges x 3 n_nodes)  nodal-vector -> edge tangential avg
      Pi_f (n_faces x 3 n_nodes)  nodal-vector -> face normal avg

    exactness: C @ G == 0 and D @ C == 0.
    Edge order: x-edges, y-edges, z-edges; face order: x-, y-, z-normal.
    """
    m = n + 1
    nn = m * m * m

    def node(i, j, k):
        return i + m * (j + m * k)

    # index grids (i fastest), one family at a time, fully vectorized
    def grid(ni, nj, nk):
        k, j, i = np.meshgrid(np.arange(nk), np.arange(nj),
                              np.arange(ni), indexing="ij")
        return (i.ravel(), j.ravel(), k.ravel())

    ex_i, ex_j, ex_k = grid(n, m, m)      # x-edges
    ey_i, ey_j, ey_k = grid(m, n, m)      # y-edges
    ez_i, ez_j, ez_k = grid(m, m, n)      # z-edges
    nex, ney, nez = len(ex_i), len(ey_i), len(ez_i)
    ne = nex + ney + nez

    def xedge(i, j, k):
        return i + n * (j + m * k)

    def yedge(i, j, k):
        return nex + i + m * (j + n * k)

    def zedge(i, j, k):
        return nex + ney + i + m * (j + m * k)

    # G: edge -> (+head, -tail)
    heads = np.concatenate([node(ex_i + 1, ex_j, ex_k),
                            node(ey_i, ey_j + 1, ey_k),
                            node(ez_i, ez_j, ez_k + 1)])
    tails = np.concatenate([node(ex_i, ex_j, ex_k),
                            node(ey_i, ey_j, ey_k),
                            node(ez_i, ez_j, ez_k)])
    e_ids = np.arange(ne)
    G = sp.coo_matrix(
        (np.concatenate([np.ones(ne), -np.ones(ne)]),
         (np.concatenate([e_ids, e_ids]),
          np.concatenate([heads, tails]))), shape=(ne, nn)).tocsr()

    # faces
    fx_i, fx_j, fx_k = grid(m, n, n)      # x-normal faces
    fy_i, fy_j, fy_k = grid(n, m, n)
    fz_i, fz_j, fz_k = grid(n, n, m)
    nfx, nfy, nfz = len(fx_i), len(fy_i), len(fz_i)
    nf = nfx + nfy + nfz

    def xface(i, j, k):
        return i + m * (j + n * k)

    def yface(i, j, k):
        return nfx + i + n * (j + m * k)

    def zface(i, j, k):
        return nfx + nfy + i + n * (j + n * k)

    # C: circulation around each face (right-hand rule about its normal)
    rows, cols, vals = [], [], []

    def add(f_ids, e_ids_, s):
        rows.append(f_ids)
        cols.append(e_ids_)
        vals.append(np.full(len(f_ids), float(s)))

    fx = np.arange(nfx)
    add(fx, yedge(fx_i, fx_j, fx_k), 1.0)
    add(fx, zedge(fx_i, fx_j + 1, fx_k), 1.0)
    add(fx, yedge(fx_i, fx_j, fx_k + 1), -1.0)
    add(fx, zedge(fx_i, fx_j, fx_k), -1.0)
    fy = nfx + np.arange(nfy)
    add(fy, zedge(fy_i, fy_j, fy_k), 1.0)
    add(fy, xedge(fy_i, fy_j, fy_k + 1), 1.0)
    add(fy, zedge(fy_i + 1, fy_j, fy_k), -1.0)
    add(fy, xedge(fy_i, fy_j, fy_k), -1.0)
    fz = nfx + nfy + np.arange(nfz)
    add(fz, xedge(fz_i, fz_j, fz_k), 1.0)
    add(fz, yedge(fz_i + 1, fz_j, fz_k), 1.0)
    add(fz, xedge(fz_i, fz_j + 1, fz_k), -1.0)
    add(fz, yedge(fz_i, fz_j, fz_k), -1.0)
    C = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(nf, ne)).tocsr()

    # D: cell out-fluxes
    c_i, c_j, c_k = grid(n, n, n)
    nc = len(c_i)
    c_ids = np.arange(nc)
    rows, cols, vals = [], [], []

    def addd(f, s):
        rows.append(c_ids)
        cols.append(f)
        vals.append(np.full(nc, float(s)))

    addd(xface(c_i + 1, c_j, c_k), 1.0)
    addd(xface(c_i, c_j, c_k), -1.0)
    addd(yface(c_i, c_j + 1, c_k), 1.0)
    addd(yface(c_i, c_j, c_k), -1.0)
    addd(zface(c_i, c_j, c_k + 1), 1.0)
    addd(zface(c_i, c_j, c_k), -1.0)
    D = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(nc, nf)).tocsr()

    # Pi_e: tangential component averaged over the edge's 2 nodes,
    # into the matching cartesian block of the nodal vector space
    rows = np.concatenate([e_ids, e_ids])
    blk = np.concatenate([np.zeros(nex), np.ones(ney),
                          2 * np.ones(nez)]).astype(np.int64)
    cols = np.concatenate([heads, tails]) + np.concatenate([blk, blk]) * nn
    Pi_e = sp.coo_matrix((np.full(2 * ne, 0.5), (rows, cols)),
                         shape=(ne, 3 * nn)).tocsr()

    # Pi_f: normal component averaged over the face's 4 corner nodes
    f_ids4, f_cols = [], []
    for (fi, fj, fk, fid0, bb, corners) in (
            (fx_i, fx_j, fx_k, 0, 0,
             ((0, 0, 0), (0, 1, 0), (0, 0, 1), (0, 1, 1))),
            (fy_i, fy_j, fy_k, nfx, 1,
             ((0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 0, 1))),
            (fz_i, fz_j, fz_k, nfx + nfy, 2,
             ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0)))):
        ids = fid0 + np.arange(len(fi))
        for (di, dj, dk) in corners:
            f_ids4.append(ids)
            f_cols.append(node(fi + di, fj + dj, fk + dk) + bb * nn)
    Pi_f = sp.coo_matrix(
        (np.full(4 * nf, 0.25),
         (np.concatenate(f_ids4), np.concatenate(f_cols))),
        shape=(nf, 3 * nn)).tocsr()
    return G, C, D, Pi_e, Pi_f


def maxwell_3d(n: int, beta: float = 1.0):
    """3D lowest-order Nedelec curl-curl + mass (the ex15 problem):
    A_edge = C^T C + beta M_e.  Returns (A, G, Pi_e) for AMS."""
    G, C, D, Pi_e, Pi_f = derham_3d(n)
    A = (C.T @ C + beta * sp.identity(C.shape[1])).tocsr()
    return A, G, Pi_e


def rt0_3d(n: int, beta: float = 1.0):
    """3D lowest-order Raviart-Thomas div-div + mass:
    A_face = D^T D + beta M_f.  Returns (A, C, Pi_f, G, Pi_e) — the
    full ADS input set (ref: src/parcsr_ls/ads.c, ex15's H(div) twin)."""
    G, C, D, Pi_e, Pi_f = derham_3d(n)
    A = (D.T @ D + beta * sp.identity(D.shape[1])).tocsr()
    return A, C, Pi_f, G, Pi_e


def rt0_2d(n: int, beta: float = 1.0):
    """2D lowest-order Raviart-Thomas div-div + mass problem:
    (A, C, Pi).  In 2D, RT0 faces are rotated Nedelec edges and the
    discrete curl is the rotated gradient, so the Maxwell builder's
    operators transfer with the roles swapped."""
    A_e, G, Pi = maxwell_2d(n, beta)
    return A_e, G, Pi
