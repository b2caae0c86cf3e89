"""ILU preconditioner family.

Port of hypre_tpu/solvers/ilu.py (:53-402), the analog of hypre's ILU
solver (ref: src/parcsr_ls/par_ilu_setup.c:15; type enum
HYPRE_parcsr_ls.h:4780-4791):

  ilu_type  0 / 1   block-Jacobi ILU(k) / ILUT
           10 / 11  GMRES-ILU(k) / GMRES-ILUT (an inner GMRES around
                    the factored apply: a flexible preconditioner)
           20 / 21  NSH: Newton-Schulz-Hotelling sparse approximate
                    inverse with ILU dropping rules
           30 / 31  RAS: restricted additive Schwarz with per-block ILU
                    subdomain solves
           50       iterative ILU(0): Chow-Patel fixed-point setup with
                    truncated-Jacobi triangular solves

The factorization runs on the host: the native ``ilu_factor``
(csrc/setup_kernels.cpp, the reference's C++ byte for byte) or its
numpy twin ``_ilu_factor_numpy`` under HYPRE_TPU_TORCH_NATIVE_SETUP=0,
so L, U and the pivots equal the reference's bit for bit.  The apply
runs on the device: exact triangular solves by the wavefront solve of
ops/trisolve.py (tri_solve="exact"), or truncated Jacobi sweeps whose
L and U products are K2 SpMVs (tri_solve="jacobi", and type 50).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass
class IluConfig:
    ilu_type: int = 0          # hypre enum (see module docstring)
    fill_level: int = 0        # k in ILU(k)   (HYPRE_ILUSetLevelOfFill)
    drop_tol: float = 1e-2     # ILUT          (HYPRE_ILUSetDropThreshold)
    max_row_nnz: int = 1000    # ILUT keep cap (HYPRE_ILUSetMaxNnzPerRow)
    tri_solve: str = "exact"   # "exact" wavefront | "jacobi" truncated
    tri_iters: int = 5         # Jacobi iterations per triangular solve
    sweeps: int = 5            # Chow-Patel fixed-point sweeps (type 50)
    inner_iters: int = 5       # GMRES-ILU inner iterations (types 10/11)
    ras_block_size: int = 512  # RAS subdomain rows   (types 30/31)
    ras_overlap: int = 32      # RAS overlap per side
    nsh_iters: int = 2         # Newton-Schulz-Hotelling iterations
    nsh_drop_tol: float = 1e-3


def _device_ctx():
    from hypre_tpu_torch.core.config import get_config, get_device

    return get_config().real_dtype, get_device()


class ILU:
    """{Create, Setup(A), precondition(r)}: usable as the M of any
    Krylov solver (the HYPRE_ILUSetup/Solve surface)."""

    def __init__(self, config: IluConfig | None = None):
        self.config = config or IluConfig()
        self.L = None           # SparseOp strict lower (unit diagonal)
        self.U = None           # SparseOp strict upper
        self.udiag_inv = None
        self._wf_lo = None      # WavefrontTriSolve (exact mode)
        self._wf_up = None
        self._nsh_op = None     # approximate-inverse SparseOp (20/21)
        self._ras = None        # (ext_idx, gather) (30/31)
        self._A_op = None       # fine operator (GMRES-ILU inner solve)

    # -- setup ---------------------------------------------------------

    def setup(self, A: sp.csr_matrix) -> "ILU":
        cfg = self.config
        t = cfg.ilu_type
        A = A.tocsr()
        A.sort_indices()
        if t == 50:
            return self._setup_chow_patel(A)
        if t in (30, 31):
            return self._setup_ras(A, is_ilut=(t % 10 == 1))
        self._setup_factor(A, is_ilut=(t % 10 == 1))
        if t in (20, 21):
            self._setup_nsh(A)
        if t in (10, 11):
            from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

            self._A_op = sparse_op_from_scipy(A, prefer_dia=False)
        return self

    def _factor(self, A, is_ilut):
        from hypre_tpu_torch.setup.utils import native_enabled

        cfg = self.config
        if native_enabled():
            from hypre_tpu_torch.csrc import build as native

            return native.ilu_factor(
                A, fill_k=cfg.fill_level, drop_tol=cfg.drop_tol,
                max_keep=cfg.max_row_nnz, is_ilut=is_ilut)
        return _ilu_factor_numpy(A, cfg.fill_level, cfg.drop_tol,
                                 cfg.max_row_nnz, is_ilut)

    def _put_factors(self, Lm, ud, Um):
        """L, U and 1/udiag on the device; the wavefront solves in exact
        mode."""
        from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
        from hypre_tpu_torch.ops.trisolve import build_trisolve

        dtype, device = _device_ctx()
        self.L = sparse_op_from_scipy(Lm, prefer_dia=False)
        self.U = sparse_op_from_scipy(Um, prefer_dia=False)
        self.udiag_inv = torch.as_tensor(1.0 / ud, dtype=dtype,
                                         device=device)
        if self.config.tri_solve == "exact":
            m = Lm.shape[0]
            self._wf_lo = build_trisolve(Lm, np.ones(m), backward=False,
                                         dtype=dtype, device=device)
            self._wf_up = build_trisolve(Um, ud, backward=True,
                                         dtype=dtype, device=device)

    def _setup_factor(self, A, is_ilut):
        Lm, ud, Um = self._factor(A, is_ilut)
        self._put_factors(Lm, ud, Um)
        self._LU_scipy = (Lm, ud, Um)
        return self

    def _setup_nsh(self, A):
        """Newton-Schulz-Hotelling approximate inverse: M0 = D^-1, then
        M <- M (2I - A M) with ILU-style magnitude dropping each
        iteration (ref: par_ilu_setup.c hypre_ILUSetupNSH)."""
        from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
        from hypre_tpu_torch.setup.utils import native_enabled

        cfg = self.config
        d = A.diagonal()
        M = sp.diags(1.0 / np.where(d != 0, d, 1.0)).tocsr()
        eye2 = sp.identity(A.shape[0], format="csr") * 2.0

        def gemm(X, Y):
            if native_enabled():
                from hypre_tpu_torch.csrc import build as native

                return native.spgemm(X.tocsr(), Y.tocsr())
            return (X @ Y).tocsr()

        for _ in range(cfg.nsh_iters):
            AM = gemm(A, M)
            M = gemm(M, (eye2 - AM).tocsr())
            # drop small entries relative to the row max (the ILUT rule)
            M = M.tocsr()
            rmax = np.maximum.reduceat(
                np.abs(M.data), M.indptr[:-1],
            ) if M.nnz else np.zeros(M.shape[0])
            rmax = np.where(np.diff(M.indptr) > 0, rmax, 1.0)
            thresh = np.repeat(rmax * cfg.nsh_drop_tol, np.diff(M.indptr))
            M.data[np.abs(M.data) < thresh] = 0.0
            M.eliminate_zeros()
        self._nsh_op = sparse_op_from_scipy(M, prefer_dia=False)

    def _setup_ras(self, A, is_ilut):
        """Restricted additive Schwarz: contiguous row blocks extended by
        ras_overlap on each side, each ILU-factored; the apply solves
        all of them in one block-diagonal triangular solve and keeps
        each block's own rows."""
        cfg = self.config
        n = A.shape[0]
        bs, ov = cfg.ras_block_size, cfg.ras_overlap
        ext_rows, own_pos, own_rows = [], [], []
        blocks = []
        pos = 0
        for s in range(0, n, bs):
            e = min(s + bs, n)
            lo, hi = max(s - ov, 0), min(e + ov, n)
            ext_rows.append(np.arange(lo, hi))
            own_pos.append(np.arange(pos + (s - lo),
                                     pos + (s - lo) + (e - s)))
            own_rows.append(np.arange(s, e))
            blocks.append(A[lo:hi, lo:hi].tocsr())
            pos += hi - lo
        Abd = sp.block_diag(blocks, format="csr")
        Lm, ud, Um = self._factor(Abd, is_ilut)
        self._put_factors(Lm, ud, Um)
        _, device = _device_ctx()
        # scatter as a gather: x[own_rows] = z[own_pos], and own_rows is
        # a permutation of range(n)
        gather = np.empty(n, dtype=np.int64)
        gather[np.concatenate(own_rows)] = np.concatenate(own_pos)
        self._ras = (torch.as_tensor(np.concatenate(ext_rows),
                                     device=device),
                     torch.as_tensor(gather, device=device))
        return self

    def _setup_chow_patel(self, A):
        """Chow-Patel fixed-point ILU(0), hypre's iterative GPU setup
        (type 50)."""
        from hypre_tpu_torch.ops.formats import sparse_op_from_scipy

        dtype, device = _device_ctx()
        n = A.shape[0]
        coo = A.tocoo()
        rows = coo.row.astype(np.int64)
        cols = coo.col.astype(np.int64)
        vals = coo.data.astype(np.float64)
        nnz = len(vals)

        lower = rows > cols
        f = vals.copy()
        diag_pos = np.flatnonzero(rows == cols)
        diag_of_row = np.full(n, -1, dtype=np.int64)
        diag_of_row[rows[diag_pos]] = diag_pos

        key = rows * n + cols
        key_sorted = np.argsort(key)
        key_s = key[key_sorted]

        def find(i_arr, k_arr):
            kk = i_arr * n + k_arr
            p = np.searchsorted(key_s, kk)
            p = np.minimum(p, nnz - 1)
            hit = key_s[p] == kk
            return np.where(hit, key_sorted[p], -1), hit

        row_start = A.indptr[rows]
        row_cnt = A.indptr[rows + 1] - row_start
        te = np.repeat(np.arange(nnz), row_cnt)
        tpos = (np.arange(len(te))
                - np.repeat(np.cumsum(row_cnt) - row_cnt, row_cnt)
                + row_start[te])
        tk = A.indices[tpos].astype(np.int64)
        ti, tj = rows[te], cols[te]
        valid = tk < np.minimum(ti, tj)
        te, tk, ti, tj = te[valid], tk[valid], ti[valid], tj[valid]
        ik_pos = tpos[valid]
        kj_pos, hit = find(tk, tj)
        te, ik_pos, kj_pos = te[hit], ik_pos[hit], kj_pos[hit]

        for _ in range(self.config.sweeps):
            prod = np.bincount(te, f[ik_pos] * f[kj_pos], minlength=nnz)
            new = vals - prod
            udiag = f[diag_of_row[cols]]
            udiag = np.where(udiag != 0, udiag, 1.0)
            f = np.where(lower, new / udiag, new)

        Lm = sp.coo_matrix((f[lower], (rows[lower], cols[lower])),
                           shape=A.shape).tocsr()
        Um = sp.coo_matrix((f[~lower], (rows[~lower], cols[~lower])),
                           shape=A.shape).tocsr()
        ud = f[diag_of_row[np.arange(n)]]
        ud = np.where(ud != 0, ud, 1.0)
        self.L = sparse_op_from_scipy(Lm, prefer_dia=False)
        self.U = sparse_op_from_scipy(sp.triu(Um, k=1).tocsr(),
                                      prefer_dia=False)
        self.udiag_inv = torch.as_tensor(1.0 / ud, dtype=dtype,
                                         device=device)
        self._LU_scipy = (Lm, Um)
        return self

    # -- apply ---------------------------------------------------------

    def _trisolves(self, r):
        """x = U^-1 L^-1 r."""
        from hypre_tpu_torch.ops.formats import matvec

        if self._wf_lo is not None:
            return self._wf_up.solve(self._wf_lo.solve(r))
        k = self.config.tri_iters
        y = r
        for _ in range(k):
            y = r - matvec(self.L, y)
        x = self.udiag_inv * y
        for _ in range(k):
            x = self.udiag_inv * (y - matvec(self.U, x))
        return x

    def precondition(self, r):
        t = self.config.ilu_type
        if t in (20, 21):
            from hypre_tpu_torch.ops.formats import matvec

            return matvec(self._nsh_op, r)
        if t in (30, 31):
            ext_idx, gather = self._ras
            return self._trisolves(r[ext_idx])[gather]
        if t in (10, 11):
            # an inner GMRES around the factored apply, used as a
            # (flexible) preconditioner: ilu_type 10/11
            from hypre_tpu_torch.solvers.krylov_more import gmres

            return gmres(self._A_op, r, M=self._trisolves, tol=0.0,
                         max_iter=self.config.inner_iters,
                         k_dim=self.config.inner_iters).x
        return self._trisolves(r)


def _ilu_factor_numpy(A, fill_k, drop_tol, max_keep, is_ilut):
    """Pure-Python twin of the native ilu_factor (slow; tests only)."""
    import heapq

    n = A.shape[0]
    lrows, urows = [], []
    udiag = np.zeros(n)
    upat = []          # per previous row: (cols ndarray, vals, levs)
    for i in range(n):
        w = {}
        lev = {}
        b, e = A.indptr[i], A.indptr[i + 1]
        rsum = 0.0
        for p in range(b, e):
            w[int(A.indices[p])] = float(A.data[p])
            lev[int(A.indices[p])] = 0
            rsum += abs(float(A.data[p]))
        tau = drop_tol * rsum / max(e - b, 1) if is_ilut else 0.0
        w.setdefault(i, 0.0)
        lev.setdefault(i, 0)
        heap = [j for j in w if j < i]
        heapq.heapify(heap)
        done = set()
        lpart = []
        while heap:
            k = heapq.heappop(heap)
            if k in done:
                continue
            done.add(k)
            lik = w[k] / udiag[k]
            if is_ilut and abs(lik) < tau:
                del w[k]
                continue
            w[k] = lik
            lpart.append(k)
            cols, vals, levs = upat[k]
            for j, v, lv in zip(cols, vals, levs):
                fl = 0 if is_ilut else lev[k] + lv + 1
                if j not in w:
                    if not is_ilut and fl > fill_k:
                        continue
                    w[j] = -lik * v
                    lev[j] = fl
                    if j < i:
                        heapq.heappush(heap, int(j))
                else:
                    w[j] -= lik * v
                    if not is_ilut:
                        lev[j] = min(lev[j], fl)
        upart = sorted(j for j in w if j > i)
        if is_ilut:
            lpart = sorted([j for j in lpart if abs(w[j]) >= tau],
                           key=lambda j: -abs(w[j]))[:max_keep]
            lpart.sort()
            upart = sorted([j for j in upart if abs(w[j]) >= tau],
                           key=lambda j: -abs(w[j]))[:max_keep]
            upart.sort()
        di = w.get(i, 0.0)
        if di == 0.0:
            di = 1e-12 * rsum if rsum > 0 else 1.0
        udiag[i] = di
        lrows.append([(j, w[j]) for j in lpart])
        urows.append([(j, w[j]) for j in upart])
        upat.append((np.array(upart, dtype=np.int64),
                     np.array([w[j] for j in upart]),
                     np.array([0 if is_ilut else lev[j]
                               for j in upart], dtype=np.int64)))

    def to_csr(rows_list):
        indptr = np.zeros(n + 1, dtype=np.int64)
        ind, dat = [], []
        for i, row in enumerate(rows_list):
            for j, v in row:
                ind.append(j)
                dat.append(v)
            indptr[i + 1] = len(ind)
        return sp.csr_matrix((np.array(dat), np.array(ind, dtype=np.int32),
                              indptr), shape=(n, n))
    return to_csr(lrows), udiag, to_csr(urows)


def ilu_refactor(A, L, U):
    """Level-scheduled parallel (OpenMP) numeric factorization on a
    fixed pattern (ref: src/distributed_ls/Euclid/Euclid_dh.c:127):
    exact ILU(0) when L/U are tril/triu(A), a static-pattern ILU
    otherwise.  Returns (L', udiag', U') as scipy CSR and an array."""
    from hypre_tpu_torch.csrc import build as native

    return native.ilu_refactor(A, L, U)
