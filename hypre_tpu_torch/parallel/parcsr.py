"""Distributed ParCSR matrices and vectors.

Port of hypre_tpu/parallel/parcsr.py (``ParCSR`` :41, ``parcsr_from_
scipy`` :63, ``parcsr_from_pardell`` :147, ``par_matvec`` :233,
``par_dot`` :245, ``ParStencilOp`` :252, ``par_stencil_matvec`` :281),
the hypre_ParCSRMatrix analog (ref: src/parcsr_mv/par_csr_matrix.h:
27-86): each shard owns a contiguous block of rows, split into a diag
block (owned columns) and an offd block (columns in the shard's ghost
buffer, compressed as hypre's col_map_offd), with the CommPkg that
fills the ghost buffer.

The reference stacks each block as padded ELL, ``(n_shards, n_local,
width)``.  The port stores the stacked blocks as two CSR matrices so
that kernel K2 (``csrc/csr_spmv.cu``) carries every local product in one
launch whatever the shard count:

* diag: one block-diagonal CSR of ``n_held n_local`` rows whose
  columns are ``p n_local_col + local column``; padding rows of a square
  operator are identity rows (parcsr.py:94-100), P and R have none;
* offd: one CSR whose columns index the flattened ``(n_held, n_ghost +
  1)`` ghost buffer, ``p (n_ghost + 1) + slot``.

A distributed matvec is then exchange + K2(diag) + K2(offd) + add,
diag sum first as in the reference (parcsr.py:239-242).

``ParStencilOp`` keeps the reference's matrix-free fine level: shifted
slices of a halo-extended local vector, here vectorized over the shard
axis, the halo the neighbours' ``maxdisp`` tails and heads (zeros at the
ends) brought by the communicator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.ops.spmv import CsrMatrix, csr_spmv
from hypre_tpu_torch.parallel.comm import (
    CommPkg, build_comm_pkg, edge_halo_pkg,
)
from hypre_tpu_torch.parallel.partition import (
    RowPartition, true_counts, true_starts,
)


@dataclasses.dataclass(frozen=True)
class ParCSR:
    """Sharded sparse matrix: stacked diag and offd blocks as CSR.

    diag: CsrMatrix (n_held n_local, n_held n_local_col), block diagonal
    offd: CsrMatrix (n_held n_local, n_held (n_ghost + 1))
    comm: CommPkg over the column partition
    communicator: the executor (StackedComm or DistComm)
    """

    diag: CsrMatrix
    offd: CsrMatrix
    comm: CommPkg
    row_part: object
    col_part: object
    communicator: object

    def blocks(self):
        """(label, CsrMatrix) of the stacked blocks, for kernel checks."""
        return (("diag", self.diag), ("offd", self.offd))


def _default_comm(n_shards, communicator):
    if communicator is not None:
        return communicator
    from hypre_tpu_torch.parallel.comm import StackedComm

    return StackedComm(n_shards)


def _owner(gid: torch.Tensor, part) -> torch.Tensor:
    """Owning shard of global ids (true ids, on gid's device)."""
    st = torch.as_tensor(true_starts(part)[1:-1], device=gid.device)
    return torch.searchsorted(st, gid, right=True)


def _csr(counts, indices, values, n_cols: int, dtype) -> CsrMatrix:
    """CsrMatrix from per-row counts and row-major (column-sorted)
    entries, all on one device."""
    from hypre_tpu_torch.ops.spmv import group_size

    indptr = torch.zeros(len(counts) + 1, dtype=torch.int64,
                         device=counts.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return CsrMatrix(indptr=indptr, indices=indices.to(torch.int32),
                     values=values.to(dtype), n_rows=len(counts),
                     n_cols=int(n_cols),
                     group=group_size(len(counts), len(values)))


def parcsr_from_csr(A: sp.csr_matrix, row_part, col_part, communicator,
                    dtype: torch.dtype, square: bool) -> ParCSR:
    """Stacked ParCSR from a global CSR matrix with sorted columns, split
    on the communicator's device after one upload of A: the shard of
    each entry, the diag/offd split, the ghost compression (per shard
    sorted unique off-owner columns, to the host for the schedule) and
    the padding identity rows.  Both blocks keep A's entry order: rows
    ascend in the stacked order and, within a row, local columns and
    ghost slots ascend with the global column, so no sort is needed;
    padding rows follow every true row."""
    A = A.tocsr()
    A.sort_indices()
    dev = communicator.device
    ns = row_part.n_shards
    nl, ncl = row_part.n_local, col_part.n_local
    rstart = torch.as_tensor(true_starts(row_part), device=dev)
    cstart = torch.as_tensor(true_starts(col_part), device=dev)
    rows = torch.repeat_interleave(
        torch.arange(A.shape[0], device=dev),
        torch.as_tensor(np.diff(A.indptr), device=dev))
    cols = torch.as_tensor(A.indices, device=dev).to(torch.int64)
    vals = torch.as_tensor(A.data, device=dev)
    p = _owner(rows, row_part)
    owned = _owner(cols, col_part) == p
    # ghost compression over every shard (the schedule needs them all)
    big = max(col_part.n_global, 1)
    off = ~owned
    ukey, inv = torch.unique(p[off] * big + cols[off], return_inverse=True)
    u_p = ukey // big
    first = torch.searchsorted(u_p, torch.arange(ns + 1, device=dev))
    keys, fh = ukey.cpu().numpy(), first.cpu().numpy()
    comm = build_comm_pkg([keys[fh[q]:fh[q + 1]] - q * big
                           for q in range(ns)], col_part)
    slot = torch.arange(len(ukey), device=dev) - first[u_p]
    ng1 = comm.n_ghost + 1

    s0, nh = communicator.shards.start, communicator.n_held
    held = (p >= s0) & (p < s0 + nh)
    lp = p - s0
    lrow = lp * nl + rows - rstart[p]
    # diag block
    d = owned & held
    cnt = torch.bincount(lrow[d], minlength=nh * nl)
    d_cols = lp[d] * ncl + cols[d] - cstart[p[d]]
    d_vals = vals[d]
    if square:
        tc = torch.as_tensor(true_counts(row_part)[s0:s0 + nh], device=dev)
        loc = torch.arange(nl, device=dev)[None, :]
        pad = loc >= tc[:, None]
        sh = torch.arange(nh, device=dev)[:, None]
        cnt[(sh * nl + loc)[pad]] += 1
        d_cols = torch.cat([d_cols, (sh * ncl + loc)[pad]])
        d_vals = torch.cat([d_vals, torch.ones(int(pad.sum()),
                                               dtype=d_vals.dtype,
                                               device=dev)])
    diag = _csr(cnt, d_cols, d_vals, nh * ncl, dtype)
    # offd block
    oh = held[off]
    offd = _csr(torch.bincount(lrow[off][oh], minlength=nh * nl),
                lp[off][oh] * ng1 + slot[inv][oh], vals[off][oh], nh * ng1,
                dtype)
    return ParCSR(diag=diag, offd=offd, comm=comm, row_part=row_part,
                  col_part=col_part, communicator=communicator)


def parcsr_from_scipy(A, n_shards: int, dtype: torch.dtype | None = None,
                      row_part: RowPartition | None = None,
                      col_part: RowPartition | None = None,
                      communicator=None) -> ParCSR:
    """Host-side conversion of a global scipy matrix into ParCSR form
    (parcsr.py:63).  Rows and columns are padded up to equal shard
    sizes; padding rows of a square operator are identity rows of the
    diag block."""
    from hypre_tpu_torch.core.config import get_config

    dtype = dtype or get_config().real_dtype
    communicator = _default_comm(n_shards, communicator)
    n_rows, n_cols = A.shape
    rp = row_part or RowPartition.create(n_rows, n_shards)
    cp = col_part or RowPartition.create(n_cols, n_shards)
    square = n_rows == n_cols and rp.n_local == cp.n_local
    return parcsr_from_csr(A, rp, cp, communicator, dtype, square)


def par_matvec(A: ParCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A x (distributed): x (n_held, n_local_col) -> y (n_held,
    n_local).  One exchange, then K2 on the diag block and K2 on the
    offd block."""
    ghost = A.communicator.exchange(x, A.comm)
    y = csr_spmv(A.diag, x.reshape(-1))
    y = y + csr_spmv(A.offd, ghost.reshape(-1))
    return y.reshape(x.shape[0], A.row_part.n_local)


def par_dot(communicator, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Global inner product: a sum per shard, then over shards (the
    MPI_Allreduce of hypre_ParVectorInnerProd, ref: src/parcsr_mv/
    par_vector.c:513)."""
    return communicator.dot(x, y)


@dataclasses.dataclass(frozen=True)
class ParStencilOp:
    """Matrix-free distributed constant-stencil operator on an (nx, ny,
    nz) x-fastest grid whose rows are sharded in contiguous slabs (the
    reference's fine level, parcsr.py:252).  ``coef`` holds each arm's
    value masked to the rows where the arm stays inside the grid,
    (n_arms, n_held, n_local), built once."""

    shape: tuple            # (nx, ny, nz)
    arms: tuple             # ((dx, dy, dz), val) pairs, nonzero vals
    n_local: int
    n_shards: int
    communicator: object = dataclasses.field(compare=False, repr=False)
    coef: torch.Tensor = dataclasses.field(compare=False, repr=False,
                                           default=None)
    halo: CommPkg = dataclasses.field(compare=False, repr=False,
                                      default=None)

    @property
    def maxdisp(self) -> int:
        nx, ny, _ = self.shape
        return max(abs(dx + nx * (dy + ny * dz))
                   for (dx, dy, dz), _ in self.arms)

    @property
    def n_rows(self) -> int:
        return self.n_shards * self.n_local


def par_stencil_op(shape, entries, n_local: int, communicator,
                   dtype: torch.dtype) -> ParStencilOp:
    """ParStencilOp of (shape, [((dx, dy, dz), value), ...]), arms in
    the reference's sorted order (par_amg.py:139-143), with its masked
    coefficients on the communicator's device."""
    arms = tuple(sorted(((tuple(d), float(v)) for d, v in entries
                         if v != 0.0), key=lambda e: e[0]))
    nx, ny, nz = shape
    n = nx * ny * nz
    ns = communicator.n_shards
    op = ParStencilOp(shape=tuple(shape), arms=arms, n_local=int(n_local),
                      n_shards=ns, communicator=communicator)
    m = min(op.maxdisp, n_local)
    dev = communicator.device
    lin = (communicator.shard_index()[:, None] * n_local
           + torch.arange(n_local, device=dev)[None, :])
    gx, gy, gz = lin % nx, (lin // nx) % ny, lin // (nx * ny)
    coef = torch.empty((len(arms),) + tuple(lin.shape), dtype=dtype,
                       device=dev)
    for k, ((dx, dy, dz), v) in enumerate(arms):
        ok = ((lin < n) & (gx + dx >= 0) & (gx + dx < nx)
              & (gy + dy >= 0) & (gy + dy < ny)
              & (gz + dz >= 0) & (gz + dz < nz))
        coef[k] = torch.where(ok, v, 0.0)
    return dataclasses.replace(op, coef=coef, halo=edge_halo_pkg(
        ns, np.arange(n_local - m, n_local), np.arange(m)))


def par_stencil_matvec(op: ParStencilOp, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the stencil operator (parcsr.py:281): the halo is one
    exchange of the slab neighbours' m = min(maxdisp, n_local) boundary
    entries; each arm is a shifted slice of the extended vector times
    its masked coefficient."""
    m = op.halo.n_ghost // 2
    nl = op.n_local
    ghost = op.communicator.exchange(x, op.halo)
    xext = torch.cat([ghost[:, :m], x, ghost[:, m:2 * m]], dim=1)
    nx, ny, _ = op.shape
    y = torch.zeros_like(x)
    for k, ((dx, dy, dz), _) in enumerate(op.arms):
        d = dx + nx * (dy + ny * dz)
        y = y + op.coef[k] * xext[:, m + d:m + d + nl]
    return y


def shard_vector(v: np.ndarray, part) -> np.ndarray:
    """Pad + reshape a global vector to (n_shards, n_local), each shard's
    true rows in its first slots (parcsr.py:321)."""
    v = np.asarray(v)
    out = np.zeros((part.n_shards, part.n_local), dtype=v.dtype)
    st, cnt = true_starts(part), true_counts(part)
    for p in range(part.n_shards):
        out[p, :cnt[p]] = v[st[p]:st[p] + cnt[p]]
    return out


def unshard_vector(v, part) -> np.ndarray:
    """(n_shards, n_local) -> the global vector of true rows."""
    v = np.asarray(v).reshape(part.n_shards, part.n_local)
    cnt = true_counts(part)
    return np.concatenate([v[p, :cnt[p]] for p in range(part.n_shards)])


def to_device_shards(v: np.ndarray, part, communicator,
                     dtype: torch.dtype) -> torch.Tensor:
    """A global host vector as the communicator's held shards on its
    device, (n_held, n_local)."""
    s0 = communicator.shards.start
    sh = shard_vector(v, part)[s0:s0 + communicator.n_held]
    return torch.as_tensor(sh, dtype=dtype, device=communicator.device)


def _csr_from_slots(cols: torch.Tensor, vals: torch.Tensor, n_cols: int,
                    dtype: torch.dtype) -> CsrMatrix:
    """CSR of row-major slots (n_rows, k): each row's valid (>= 0) slots
    in slot order, on their own device."""
    from hypre_tpu_torch.ops.spmv import group_size

    valid = cols >= 0
    counts = valid.sum(1)
    indptr = torch.zeros(cols.shape[0] + 1, dtype=torch.int64,
                         device=cols.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    nnz = int(indptr[-1])
    return CsrMatrix(indptr=indptr, indices=cols[valid].to(torch.int32),
                     values=vals[valid].to(dtype), n_rows=int(cols.shape[0]),
                     n_cols=int(n_cols),
                     group=group_size(int(cols.shape[0]), nnz))


def parcsr_from_pardell(M, dtype: torch.dtype | None = None) -> ParCSR:
    """A distributed-setup operator (par_setup.ParDEll, global columns)
    as the solve's ParCSR (parcsr.py:147), entirely from the stacked
    blocks on the card: the ext ids split diag (own column) from offd
    (ghost slot), which is hypre's col_map_offd compression; square
    operators get identity entries on their padding rows."""
    from hypre_tpu_torch.core.config import get_config
    from hypre_tpu_torch.parallel.par_setup import (
        build_level_comm, real_rows,
    )

    dtype = dtype or get_config().real_dtype
    ce, comm = build_level_comm(M)
    ns, w, nl = ce.shape
    ncl = M.col_part.n_local
    ng1 = comm.n_ghost + 1
    square = M.row_part.n_global == M.col_part.n_global and nl == ncl
    ce = ce.permute(0, 2, 1)                       # (ns, nl, w)
    vals = M.vals.permute(0, 2, 1)
    shard = torch.arange(ns, device=ce.device)[:, None, None]
    isd = (ce >= 0) & (ce < ncl)
    iso = ce >= ncl
    dc = torch.where(isd, shard * ncl + ce, -1)
    oc = torch.where(iso, shard * ng1 + ce - ncl, -1)
    dv = vals
    if square:
        pad = ~real_rows(M.row_part, ce.device)
        loc = torch.arange(nl, device=ce.device)[None, :]
        eye_c = torch.where(pad, shard[:, :, 0] * ncl + loc, -1)
        dc = torch.cat([dc, eye_c[:, :, None]], 2)
        dv = torch.cat([dv, torch.ones_like(dv[:, :, :1])], 2)
    diag = _csr_from_slots(dc.reshape(ns * nl, -1), dv.reshape(ns * nl, -1),
                           ns * ncl, dtype)
    offd = _csr_from_slots(oc.reshape(ns * nl, -1),
                           vals.reshape(ns * nl, -1), ns * ng1, dtype)
    return ParCSR(diag=diag, offd=offd, comm=comm, row_part=M.row_part,
                  col_part=M.col_part, communicator=M.communicator)
