"""Carry a hypre_tpu AMG hierarchy across to the port.

The port imports nothing of hypre_tpu, so the caller hands over the
reference hierarchy's arrays as numpy (``np.asarray`` of each field)
and this module rebuilds them as the port's operators:

* StencilOp grid and entries → StencilOp;
* GST-ELL ``base``/``locs``/``vals`` → CsrMatrix, by the addressing of
  ``gstell_matvec_reference`` (hypre_tpu/ops/gstell.py:843-853): slot
  ``s = 8g + sublane`` of chunk ``ch`` in step ``t`` reads column
  ``base[t, ch, g, sublane] * 128 + locs[t, ch, s, lane]`` for row
  ``(t * CH + ch) * 128 + lane``; zero values and rows past ``n_rows``
  are padding and are dropped;
* ELL ``cols``/``vals`` (slot-major, ``[width, n_rows]``) → CsrMatrix;
* DIA ``offsets``/``vals`` (``vals[d, i] = A[i, i + offsets[d]]``) →
  DiaMatrix, the same arrays;
* Dense ``vals`` (128-padded) → DenseMatrix of the logical shape;
* the coarse LU: JAX's ``lu_factor`` pivots are 0-based, torch's
  ``lu_solve`` takes 1-based LAPACK pivots, so they are shifted by one;
* exact-GS factors: the dense ``gs_lo``/``gs_up`` as they are, and a
  ``WavefrontTriSolve`` from its ``perm``, ``inv_perm``, ``dinv_p``,
  ``cols``, ``vals`` (None for a wavefront with no entries) and
  ``block_bounds``.

Each operator is given as a dict with a ``kind`` key ("stencil",
"gstell", "ell", "dia", "dense") and that format's arrays.

``dell_from_numpy`` carries an operator of the reference's device setup
(a ``DEll``: slot-major ``cols``/``vals``) across unchanged, so the
port's device-setup stages can be fed the reference's own inputs.

``fsai_from_numpy``, ``parasails_from_numpy``, ``ilu_from_numpy`` and
``schwarz_from_numpy`` build the port's preconditioners from the
reference's set-up state (FSAI's G, ParaSails' M, ILU's L, U and pivots,
Schwarz's block inverses), so an apply can be compared from identical
state.

``struct_matrix_from_numpy`` carries a reference StructMatrix (its
coefficient arrays as numpy) across, so both packages' struct solvers
can be built from one operator.

``ams_from_numpy`` builds the port's AMS (or, with ``inner``, ADS) from
the reference's set-up state: its two sub-hierarchies (each as
``hierarchy_from_numpy`` takes it), the transfer matrices and the
inverse l1 norms.  ``maxwell_from_numpy`` does so for SStructMaxwell:
each level's operators (convert's dicts), inverse norms and the coarse
pseudo-inverse.

The distributed layer: ``partition_from_numpy`` (a partition as a dict),
``comm_pkg_from_numpy`` (a CommPkg's arrays, the same arrays),
``parcsr_from_numpy`` (a ParCSR's stacked ELL blocks,
``(n_shards, n_local, K)``, as the port's block-diagonal diag CSR,
columns ``p n_local_col + col``, and offd CSR, columns ``p (n_ghost + 1)
+ slot``; empty slots, value 0, dropped), ``pardell_from_numpy`` (a
ParDEll, the same layout) and ``par_hierarchy_from_numpy`` (a
ParAmgHierarchy: each level's ParCSRs and smoother arrays, the coarse
LU) build the port's objects on a stacked communicator.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.core.config import get_config, get_device
from hypre_tpu_torch.ops.dia import DiaMatrix
from hypre_tpu_torch.ops.formats import DenseMatrix, SparseOp
from hypre_tpu_torch.ops.spmv import csr_from_scipy
from hypre_tpu_torch.ops.stencil import stencil_op
from hypre_tpu_torch.ops.trisolve import WavefrontTriSolve
from hypre_tpu_torch.solvers.amg import AmgHierarchy, AmgLevel


def _coo_to_csr(rows, cols, vals, n_rows, n_cols) -> sp.csr_matrix:
    keep = (vals != 0) & (rows < n_rows) & (cols < n_cols)
    A = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])),
                      shape=(n_rows, n_cols))
    A.sum_duplicates()
    return A


def scipy_from_gstell(base, locs, vals, n_rows, n_cols) -> sp.csr_matrix:
    base = np.asarray(base, dtype=np.int64)          # [steps, CH, G, 8]
    locs = np.asarray(locs, dtype=np.int64)          # [steps, CH, 8G, 128]
    vals = np.asarray(vals, dtype=np.float64)
    n_steps, ch_step, n_slots, lanes = locs.shape
    cols = base.reshape(n_steps, ch_step, n_slots, 1) * 128 + locs
    chunk = np.arange(n_steps * ch_step).reshape(n_steps, ch_step, 1, 1)
    rows = chunk * lanes + np.arange(lanes).reshape(1, 1, 1, lanes)
    rows = np.broadcast_to(rows, locs.shape)
    return _coo_to_csr(rows.ravel(), cols.ravel(), vals.ravel(),
                       n_rows, n_cols)


def scipy_from_ell(cols, vals, n_cols) -> sp.csr_matrix:
    cols = np.asarray(cols, dtype=np.int64)          # [width, n_rows]
    vals = np.asarray(vals, dtype=np.float64)
    n_rows = cols.shape[1]
    rows = np.broadcast_to(np.arange(n_rows), cols.shape)
    return _coo_to_csr(rows.ravel(), cols.ravel(), vals.ravel(),
                       n_rows, n_cols)


def operator_from_numpy(op: dict, dtype=None, device=None) -> SparseOp:
    """One reference operator (a dict of numpy arrays) as a port op."""
    dtype = dtype or get_config().real_dtype
    device = device if device is not None else get_device()
    kind = op["kind"]
    if kind == "stencil":
        return stencil_op(op["grid"], op["entries"], dtype=dtype)
    if kind == "dense":
        v = np.array(op["vals"])[:op["n_rows"], :op["n_cols"]]
        return DenseMatrix(vals=torch.as_tensor(v, dtype=dtype,
                                                device=device))
    if kind == "dia":
        return DiaMatrix(vals=torch.as_tensor(np.array(op["vals"]),
                                              dtype=dtype, device=device),
                         offsets=tuple(int(d) for d in op["offsets"]),
                         n_cols=int(op["n_cols"]))
    if kind == "gstell":
        A = scipy_from_gstell(op["base"], op["locs"], op["vals"],
                              op["n_rows"], op["n_cols"])
    elif kind == "ell":
        A = scipy_from_ell(op["cols"], op["vals"], op["n_cols"])
    else:
        raise ValueError(f"unknown operator kind {kind!r}")
    return csr_from_scipy(A, dtype, device)


def dell_from_numpy(cols, vals, n_cols: int, device=None):
    """A reference DEll (np.asarray of its cols (w, n) and vals) as the
    port's DEll on the configured device: the same slots, f64 values."""
    from hypre_tpu_torch.setup.device_amg import DEll

    device = device if device is not None else get_device()
    return DEll(
        cols=torch.as_tensor(np.array(cols, dtype=np.int32),
                             device=device),
        vals=torch.as_tensor(np.array(vals, dtype=np.float64),
                             device=device),
        n_cols=int(n_cols))


def lu_pivots_from_jax(piv) -> torch.Tensor:
    """0-based pivots of jax.scipy.linalg.lu_factor → torch's 1-based."""
    return torch.as_tensor(np.asarray(piv, dtype=np.int64) + 1,
                           dtype=torch.int32)


def trisolve_from_numpy(wf: dict, dtype=None, device=None):
    """A reference WavefrontTriSolve (a dict of np.asarray of its fields)
    as the port's: the same permutation, wavefront blocks and bounds."""
    dtype = dtype or get_config().real_dtype
    device = device if device is not None else get_device()

    def idx(a):
        return torch.as_tensor(np.array(a, dtype=np.int64), device=device)

    def real(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return WavefrontTriSolve(
        perm=idx(wf["perm"]), inv_perm=idx(wf["inv_perm"]),
        dinv_p=real(wf["dinv_p"]),
        cols=tuple(None if c is None else idx(c) for c in wf["cols"]),
        vals=tuple(None if v is None else real(v) for v in wf["vals"]),
        block_bounds=tuple((int(s), int(m)) for s, m in wf["block_bounds"]))


def hierarchy_from_numpy(levels, c_lu, c_piv, relax_weight: float = 1.0,
                         num_sweeps: int = 1, relax_type: int = 18,
                         dtype=None, device=None) -> AmgHierarchy:
    """Build the port's AmgHierarchy from a reference hierarchy.

    levels: one dict per level with "A" (an operator dict), "P" and
    "R" (operator dicts, None on the coarsest level) and "dinv" (numpy
    vector, None on the coarsest level); for exact GS also "gs_lo" and
    "gs_up" (dense numpy factors) or "gs_wf_lo" and "gs_wf_up"
    (trisolve dicts), None where absent.  c_lu, c_piv: the reference's
    coarse LU factors and its 0-based pivots."""
    dtype = dtype or get_config().real_dtype
    device = device if device is not None else get_device()

    def op(d):
        return None if d is None else operator_from_numpy(d, dtype, device)

    def real(a):
        return None if a is None else torch.as_tensor(
            np.array(a), dtype=dtype, device=device)

    def wf(d):
        return None if d is None else trisolve_from_numpy(d, dtype, device)

    out = []
    for lvl in levels:
        out.append(AmgLevel(
            A=op(lvl["A"]), P=op(lvl.get("P")), R=op(lvl.get("R")),
            dinv=real(lvl.get("dinv")), gs_lo=real(lvl.get("gs_lo")),
            gs_up=real(lvl.get("gs_up")), gs_wf_lo=wf(lvl.get("gs_wf_lo")),
            gs_wf_up=wf(lvl.get("gs_wf_up"))))
    return AmgHierarchy(
        levels=tuple(out), c_lu=real(c_lu),
        c_piv=lu_pivots_from_jax(c_piv).to(device),
        relax_weight=relax_weight, num_sweeps=num_sweeps,
        relax_type=relax_type)


def fsai_from_numpy(G: sp.csr_matrix, config=None):
    """The port's FSAI with the reference's G (its ``_G_scipy``)."""
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
    from hypre_tpu_torch.solvers.fsai import FSAI

    out = FSAI(config)
    G = sp.csr_matrix(G)
    out.G = sparse_op_from_scipy(G, prefer_dia=False)
    out.Gt = sparse_op_from_scipy(G.T.tocsr(), prefer_dia=False)
    out._G_scipy = G
    return out


def parasails_from_numpy(M: sp.csr_matrix | None = None,
                         G: sp.csr_matrix | None = None, config=None):
    """The port's ParaSails with the reference's M (nonsymmetric mode,
    its ``_M_scipy``) or, in symmetric mode, its FSAI delegate's G."""
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
    from hypre_tpu_torch.solvers.parasails import ParaSails

    out = ParaSails(config)
    if G is not None:
        out._fsai = fsai_from_numpy(G)
    else:
        out._M_scipy = sp.csr_matrix(M)
        out.M = sparse_op_from_scipy(out._M_scipy, prefer_dia=False)
    return out


def ilu_from_numpy(L: sp.csr_matrix, udiag, U: sp.csr_matrix, config=None):
    """The port's ILU (types 0/1) with the reference's factors: strict
    lower L, the pivots udiag and strict upper U (its ``_LU_scipy``)."""
    from hypre_tpu_torch.solvers.ilu import ILU

    out = ILU(config)
    ud = np.asarray(udiag, dtype=np.float64)
    out._put_factors(sp.csr_matrix(L), ud, sp.csr_matrix(U))
    out._LU_scipy = (L, ud, U)
    return out


def schwarz_from_numpy(block_inv, starts, n: int, config=None, A=None):
    """The port's Schwarz with the reference's block inverses
    (np.asarray of ``block_inv``) and block starts; A (scipy) for the
    multiplicative variants."""
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
    from hypre_tpu_torch.solvers.schwarz import Schwarz

    out = Schwarz(config)
    out._set_blocks(np.array(block_inv), np.array(starts), n)
    if A is not None:
        out._Aop = sparse_op_from_scipy(sp.csr_matrix(A), prefer_dia=False)
    return out


def struct_matrix_from_numpy(coefs, offsets, shape, periodic=(0, 0, 0),
                             dtype=None, device=None):
    """A reference StructMatrix (np.asarray of its coefs, and its
    offsets, shape and periodic flags) as the port's, on the configured
    device: the same coefficient arrays, offset by offset."""
    from hypre_tpu_torch.struct.grid import StructMatrix

    dtype = dtype or get_config().real_dtype
    device = device if device is not None else get_device()
    return StructMatrix(
        coefs=torch.as_tensor(np.array(coefs), dtype=dtype, device=device),
        offsets=tuple(tuple(int(v) for v in off) for off in offsets),
        shape=tuple(int(v) for v in shape),
        periodic=tuple(int(v) for v in periodic))


def amg_from_numpy(h: dict, config=None):
    """A BoomerAMG around a reference hierarchy: h holds "levels",
    "c_lu" and "c_piv" as hierarchy_from_numpy takes them; the relax
    knobs come from config (an AmgConfig)."""
    from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG

    amg = BoomerAMG(config or AmgConfig())
    cfg = amg.config
    amg.hierarchy = hierarchy_from_numpy(
        h["levels"], h["c_lu"], h["c_piv"], relax_weight=cfg.relax_weight,
        num_sweeps=cfg.num_sweeps, relax_type=cfg.relax_type)
    amg.level_sizes = [lvl.A.shape[0] for lvl in amg.hierarchy.levels]
    return amg


def ams_from_numpy(bg: dict, bpi: dict, G: sp.csr_matrix,
                   Pi: sp.csr_matrix, dinv, A: sp.csr_matrix | None = None,
                   config=None, inner=None):
    """The port's AMS with the reference's state: bg and bpi are the
    sub-hierarchies of G^T A G and Pi^T A Pi (amg_from_numpy's dicts), G
    and Pi the scipy transfers, dinv the inverse l1 norms of A (the
    edge smoother), A the edge matrix (its operator, optional).

    With inner (a port AMS for the edge space, or a dict of a plain
    BoomerAMG) the result is an ADS instead: bg is then unused, G is the
    discrete curl C and Pi the nodal-vector to face interpolation."""
    from hypre_tpu_torch.core.config import as_real
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
    from hypre_tpu_torch.solvers.ams import ADS, AMS, _transfer_ops

    cls = AMS if inner is None else ADS
    out = cls(config)
    out.bpi = amg_from_numpy(bpi, out.config.amg)
    out.dinv = as_real(np.array(dinv, dtype=np.float64))
    if inner is None:
        out.bg = amg_from_numpy(bg, out.config.amg)
        ops = _transfer_ops((("G", sp.csr_matrix(G)),
                             ("Pi", sp.csr_matrix(Pi))))
        out.G, out.Gt = ops["G"], ops["Gt"]
    else:
        if isinstance(inner, AMS):
            out.bc_ams = inner
        else:
            out.bc_amg = amg_from_numpy(inner, out.config.amg)
        ops = _transfer_ops((("C", sp.csr_matrix(G)),
                             ("Pi", sp.csr_matrix(Pi))))
        out.C, out.Ct = ops["C"], ops["Ct"]
    out.Pi, out.Pit = ops["Pi"], ops["Pit"]
    if A is not None:
        out.A_op = sparse_op_from_scipy(sp.csr_matrix(A))
    return out


def maxwell_from_numpy(levels, c_inv, config=None):
    """The port's SStructMaxwell with the reference's levels: one dict
    a level with "A", "G", "GT", "Pe" and "PeT" (operator dicts; "Pe"
    and "PeT" None on the coarsest level) and "de", "dn" (the inverse
    edge and nodal l1 norms, numpy); c_inv the coarse pseudo-inverse."""
    from hypre_tpu_torch.core.config import as_real
    from hypre_tpu_torch.solvers.maxwell import SStructMaxwell

    out = SStructMaxwell(config)
    dtype, device = get_config().real_dtype, get_device()
    out.levels = []
    for lvl in levels:
        d = {k: None if lvl.get(k) is None
             else operator_from_numpy(lvl[k], dtype, device)
             for k in ("A", "G", "GT", "Pe", "PeT")}
        d["de"] = as_real(np.array(lvl["de"], dtype=np.float64))
        d["dn"] = as_real(np.array(lvl["dn"], dtype=np.float64))
        out.levels.append(d)
    out.c_inv = as_real(np.array(c_inv, dtype=np.float64))
    return out


# ---------------------------------------------------------------------------
# the distributed layer
# ---------------------------------------------------------------------------

def partition_from_numpy(d: dict):
    """{"n_global", "n_shards", "n_local"} -> RowPartition; {"starts",
    "n_local"} -> GenPartition."""
    from hypre_tpu_torch.parallel.partition import GenPartition, RowPartition

    if "starts" in d:
        return GenPartition(starts=tuple(int(x) for x in d["starts"]),
                            n_local=int(d["n_local"]))
    return RowPartition(int(d["n_global"]), int(d["n_shards"]),
                        int(d["n_local"]))


def comm_pkg_from_numpy(d: dict):
    """A reference CommPkg's send_idx, send_mask, recv_idx, offsets and
    n_ghost as the port's CommPkg."""
    from hypre_tpu_torch.parallel.comm import CommPkg

    return CommPkg(send_idx=np.asarray(d["send_idx"], np.int32),
                   send_mask=np.asarray(d["send_mask"], np.float64),
                   recv_idx=np.asarray(d["recv_idx"], np.int32),
                   offsets=tuple(int(o) for o in d["offsets"]),
                   n_ghost=int(d["n_ghost"]))


def _block_csr(cols, vals, col_stride: int, n_cols: int, dtype, device):
    """Stacked ELL (n_shards, n_local, K) -> one CSR with columns
    p col_stride + col; zero slots dropped."""
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    ns, nl, K = cols.shape
    rows = np.broadcast_to((np.arange(ns)[:, None] * nl
                            + np.arange(nl)[None, :])[:, :, None], cols.shape)
    c = np.arange(ns)[:, None, None] * col_stride + cols
    keep = vals != 0
    M = sp.csr_matrix((vals[keep], (rows[keep], c[keep])),
                      shape=(ns * nl, n_cols))
    return csr_from_scipy(M, dtype, device)


def parcsr_from_numpy(d: dict, communicator, dtype=None):
    """A reference ParCSR (diag_cols/diag_vals/offd_cols/offd_vals, its
    "comm" dict and "row_part"/"col_part" dicts) as the port's ParCSR on
    a stacked communicator."""
    from hypre_tpu_torch.parallel.parcsr import ParCSR

    dtype = dtype or get_config().real_dtype
    dev = communicator.device
    rp = partition_from_numpy(d["row_part"])
    cp = partition_from_numpy(d["col_part"])
    comm = comm_pkg_from_numpy(d["comm"])
    ns = rp.n_shards
    return ParCSR(
        diag=_block_csr(d["diag_cols"], d["diag_vals"], cp.n_local,
                        ns * cp.n_local, dtype, dev),
        offd=_block_csr(d["offd_cols"], d["offd_vals"], comm.n_ghost + 1,
                        ns * (comm.n_ghost + 1), dtype, dev),
        comm=comm, row_part=rp, col_part=cp, communicator=communicator)


def pardell_from_numpy(cols, vals, row_part: dict, col_part: dict,
                       communicator):
    """A reference ParDEll ((n_shards, w, n_local) global cols and
    values) as the port's, f64 on the communicator's device."""
    from hypre_tpu_torch.parallel.par_setup import ParDEll

    dev = communicator.device
    return ParDEll(cols=torch.as_tensor(np.array(cols, np.int32),
                                        device=dev),
                   vals=torch.as_tensor(np.array(vals, np.float64),
                                        device=dev),
                   row_part=partition_from_numpy(row_part),
                   col_part=partition_from_numpy(col_part),
                   communicator=communicator)


def par_hierarchy_from_numpy(levels, c_lu, c_piv, communicator,
                             relax_weight: float = 1.0, num_sweeps: int = 1,
                             relax_type: int = 18, dtype=None):
    """The port's ParAmgHierarchy from a reference one: levels, one dict
    each with "A", "P", "R" (parcsr_from_numpy dicts, None where
    absent), "dinv", "cheby_ds", "gs_lo", "gs_up" (stacked numpy arrays
    or None) and "cheby_bounds" (the (n_shards, 2) array or None); c_lu
    and c_piv the replicated coarse LU (0-based pivots)."""
    from hypre_tpu_torch.solvers.par_amg import ParAmgHierarchy, ParAmgLevel

    dtype = dtype or get_config().real_dtype
    dev = communicator.device

    def real(a):
        return None if a is None else torch.as_tensor(
            np.array(a), dtype=dtype, device=dev)

    out = []
    for lvl in levels:
        par = {k: None if lvl.get(k) is None
               else parcsr_from_numpy(lvl[k], communicator, dtype)
               for k in ("A", "P", "R")}
        b = lvl.get("cheby_bounds")
        out.append(ParAmgLevel(
            A=par["A"], P=par["P"], R=par["R"], dinv=real(lvl.get("dinv")),
            cheby_ds=real(lvl.get("cheby_ds")),
            cheby_bounds=None if b is None else (float(np.asarray(b)[0, 0]),
                                                 float(np.asarray(b)[0, 1])),
            gs_lo=real(lvl.get("gs_lo")), gs_up=real(lvl.get("gs_up"))))
    return ParAmgHierarchy(
        levels=tuple(out), c_lu=real(c_lu),
        c_piv=lu_pivots_from_jax(c_piv).to(dev), relax_weight=relax_weight,
        num_sweeps=num_sweeps, communicator=communicator,
        relax_type=relax_type)
