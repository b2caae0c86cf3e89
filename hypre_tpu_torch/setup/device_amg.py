"""Device-resident AMG setup: the whole BoomerAMG setup phase as torch
operations on the card, over a padded slot-major ELL operand, so the
hierarchy is built on the device and the host sees only per-level
scalars (coarse size, output widths, the PMIS "more" flag).

Counterpart of hypre_tpu/setup/device_amg.py, itself the analog of
hypre's device setup path:
  * strength               ref: src/parcsr_ls/par_strength.c:531
  * PMIS                   ref: src/parcsr_ls/par_coarsen_device.c:30
  * direct / ext+i interp  ref: src/parcsr_ls/par_interp.c:1948,
                           par_lr_interp_device.c:1001
  * truncation             ref: src/parcsr_mv/par_csr_matrix.c:2874
  * SpGEMM / RAP           ref: src/seq_mv/csr_spgemm_device.c:15 (the
                           hash-table SpGEMM becomes gather + per-row
                           sort + segment sum over bounded candidate
                           lists)
  * transpose              ref: src/seq_mv/csr_matop_device.c (csr2csc
                           by one stable key sort)

Every neighbour read goes through kernel K4 (ops/btake.py): PMIS marker
reads, interpolation reads, the SpGEMM row expansion, the fine-to-coarse
renumbering.  The reference's dell_gather_vec(A, x, fill) is
btake(A.cols, x, fill) here, called on each row chunk's window of cols.

The representation is `DEll`, stored slot-major: ``cols`` int32 (w, n)
with -1 in padding slots, ``vals`` (w, n) with 0 there.  On a GPU this
is column-major ELLPACK: adjacent rows are adjacent in memory, so every
per-slot pass is coalesced; it is also the reference's layout, so the
tests compare arrays directly.  Within a row the valid slots hold
ascending columns.

Departures from the reference, each on purpose:
  * no stencil shift paths (``DEll.disp``): level 0's reads go through
    K4 like every other level's; the results are the same;
  * no btake plan, windows or lane padding, no width or chunk bucketing
    for compiled-program reuse, no retries or heartbeats;
  * row chunks are sized by a memory budget (``CHUNK_BYTES``) and never
    padded: a level smaller than one chunk is one chunk of its own size;
  * membership in the ext+i candidate set is a per-row binary search
    (``torch.searchsorted``) in place of the merge-and-route sorts, and
    the transpose is one stable sort over all entries;
  * candidate lists are compacted to their non-empty slots before they
    are sorted (``_compact_valid``), ext+i expands only the rows of
    strong-F neighbours, and the SpGEMM is one pass that takes C's width
    from its own compacted chunks (the reference counts it in a pass of
    its own first); all of these give the reference's values exactly;
  * P and P^T keep their exact widths (only each coarse A is rounded
    up to the reference's width bucket, see dell_pad_width).

Every sum whose value reaches a later level's structure keeps the
reference's order of summation (setup/xla_order.py says which and why),
so the port reproduces the reference's hierarchy on the CPU, and the
card reproduces the CPU, bit for bit.  ``_slot_compact`` keeps the
reference's run sums: a difference of a stable-sorted cumulative sum
(device_amg.py:1036-1053).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from hypre_tpu_torch.core import trace
from hypre_tpu_torch.core.config import synchronize
from hypre_tpu_torch.ops.btake import btake, btake_rows
from hypre_tpu_torch.setup.xla_order import SUM_WINDOW, cumsum0, sum0, sum01

C_PT = 1
F_PT = -1
SF_PT = -3

_BIG = 2 ** 30
_M32 = 0xFFFFFFFF
# Temporaries of one row chunk are kept within about this many bytes.
# The per-row cost of each stage is estimated from its widths; a level
# smaller than a chunk is processed whole, never padded up.
CHUNK_BYTES = 16 << 30


@dataclasses.dataclass(frozen=True)
class DEll:
    """Slot-major padded ELL (pad col = -1, pad val = 0)."""

    cols: torch.Tensor          # int32 (w, n)
    vals: torch.Tensor          # real (w, n)
    n_cols: int

    @property
    def n_rows(self) -> int:
        return int(self.cols.shape[1])

    @property
    def width(self) -> int:
        return int(self.cols.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def mask(self) -> torch.Tensor:
        return self.cols >= 0

    @property
    def device(self) -> torch.device:
        return self.cols.device


def _chunks(n: int, per_row_bytes: int, chunk: int | None = None):
    """Row windows [c0, c1) covering n rows, each of about `chunk` rows
    (by default as many as CHUNK_BYTES allows), balanced so that no
    window is much smaller than the others."""
    if chunk is None:
        chunk = CHUNK_BYTES // max(int(per_row_bytes), 1)
    chunk = max(1, min(int(chunk), n))
    n_ch = -(-n // chunk) if n else 0
    size = -(-n // n_ch) if n_ch else 0
    return [(c0, min(c0 + size, n)) for c0 in range(0, n, max(size, 1))]


def _int_cumsum0(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumulative sum over the leading axis of (k, m).
    Exact in any order, so it runs along the transposed (inner) axis,
    where the card scans in parallel within each column."""
    return x.t().to(torch.int64).cumsum(1).t()


# ---------------------------------------------------------------------------
# host <-> device conversions (tests + interop)
# ---------------------------------------------------------------------------

def dell_from_scipy(A, dtype: torch.dtype = torch.float64,
                    device=None) -> DEll:
    """One upload of a scipy matrix as a DEll (ascending cols a row)."""
    from hypre_tpu_torch.core.config import get_device

    device = device if device is not None else get_device()
    A = A.tocsr()
    A.sort_indices()
    n_rows, n_cols = A.shape
    row_nnz = np.diff(A.indptr)
    width = max(int(row_nnz.max(initial=0)), 1)
    cols = np.full((width, n_rows), -1, dtype=np.int32)
    vals = np.zeros((width, n_rows), dtype=np.float64)
    slot = np.arange(len(A.indices)) - np.repeat(A.indptr[:-1], row_nnz)
    rows = np.repeat(np.arange(n_rows), row_nnz)
    cols[slot, rows] = A.indices
    vals[slot, rows] = A.data
    return DEll(cols=torch.as_tensor(cols, device=device),
                vals=torch.as_tensor(vals, dtype=dtype, device=device),
                n_cols=int(n_cols))


def dell_to_scipy(M: DEll):
    import scipy.sparse as sp

    cols = M.cols.cpu().numpy()
    vals = M.vals.cpu().numpy()
    mask = cols >= 0
    rows = np.broadcast_to(np.arange(M.n_rows)[None, :], cols.shape)
    A = sp.csr_matrix(
        (vals[mask].astype(np.float64), (rows[mask], cols[mask])),
        shape=(M.n_rows, M.n_cols))
    A.sum_duplicates()
    A.sort_indices()
    return A


_W_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 256)


def dell_pad_width(M: DEll) -> DEll:
    """Round the slot dimension up to a bucket (-1/0 padding slots), as
    the reference does between stages (there for compiled-program reuse
    on the TPU).  The port's level loop pads each coarse A, where the
    width sets the order of the sums over a row (see xla_order); P and
    P^T keep their exact widths."""
    return _pad_slots(M, next((b for b in _W_BUCKETS if M.width <= b),
                              M.width))


# ---------------------------------------------------------------------------
# device stencil generator (gen/laplace.py twin: the operator is made on
# the card, no host matrix and no transfer)
# ---------------------------------------------------------------------------

def dell_stencil(shape, entries, dtype: torch.dtype = torch.float64,
                 device=None) -> DEll:
    """Stencil operator on an (nx, ny, nz) grid, x-fastest ordering,
    Dirichlet truncation (semantics of gen/laplace.py stencil_matrix,
    ref: src/parcsr_ls/par_laplace.c:63).  Slot k is stencil arm k, arms
    in ascending displacement, so valid cols ascend along the slots;
    boundary holes interleave."""
    from hypre_tpu_torch.core.config import get_device

    device = device if device is not None else get_device()
    nx, ny, nz = (int(s) for s in shape)
    ents = sorted(((tuple(d), float(v)) for d, v in entries if v != 0.0),
                  key=lambda e: e[0][0] + nx * (e[0][1] + ny * e[0][2]))
    n = nx * ny * nz
    lin = torch.arange(n, dtype=torch.int32, device=device)
    x = lin % nx
    y = (lin // nx) % ny
    z = lin // (nx * ny)
    cols = torch.empty((len(ents), n), dtype=torch.int32, device=device)
    vals = torch.empty((len(ents), n), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    for k, ((dx, dy, dz), v) in enumerate(ents):
        ok = ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0)
              & (y + dy < ny) & (z + dz >= 0) & (z + dz < nz))
        disp = dx + nx * (dy + ny * dz)
        cols[k] = torch.where(ok, lin + disp, -1)
        # a tensor, not a Python float: where() of two Python scalars
        # would round v through float32
        vals[k] = torch.where(ok, torch.full_like(zero, v), zero)
    return DEll(cols=cols, vals=vals, n_cols=n)


def dell_laplacian(nx, ny, nz=1, cx=1.0, cy=1.0, cz=1.0,
                   dtype: torch.dtype = torch.float64, device=None) -> DEll:
    """7-pt (5-pt in 2D) Laplacian, matching gen.laplacian."""
    diag = 0.0
    entries = []
    if nx > 1:
        diag += 2 * cx
        entries += [((-1, 0, 0), -cx), ((1, 0, 0), -cx)]
    if ny > 1:
        diag += 2 * cy
        entries += [((0, -1, 0), -cy), ((0, 1, 0), -cy)]
    if nz > 1:
        diag += 2 * cz
        entries += [((0, 0, -1), -cz), ((0, 0, 1), -cz)]
    entries.append(((0, 0, 0), diag))
    return dell_stencil((nx, ny, nz), entries, dtype, device)


# ---------------------------------------------------------------------------
# strength of connection (strength.py twin)
# ---------------------------------------------------------------------------

def _row_ids(c0: int, c1: int, device) -> torch.Tensor:
    return torch.arange(c0, c1, dtype=torch.int32, device=device)


def _row_diag_rows(cols, vals, c0: int):
    """Diagonal of rows [c0, c0 + m) and the diagonal-slot mask (one
    entry a row at most, so the sum is exact in any order)."""
    is_diag = (cols >= 0) & (cols == _row_ids(c0, c0 + cols.shape[1],
                                              cols.device)[None, :])
    return torch.where(is_diag, vals, 0.0).sum(0), is_diag


def device_strength(A: DEll, theta: float = 0.25, max_row_sum: float = 0.9,
                    abs_soc: bool = False, chunk: int | None = None):
    """Boolean strong mask (w, n) over A's slots.  Semantics of
    hypre_BoomerAMGCreateS (ref: src/parcsr_ls/par_strength.c:531)."""
    w, n = A.cols.shape
    strong = torch.empty((w, n), dtype=torch.bool, device=A.device)
    for c0, c1 in _chunks(n, 48 * w, chunk):
        strong[:, c0:c1] = _strength_rows(
            A.cols[:, c0:c1], A.vals[:, c0:c1], c0, theta, max_row_sum,
            abs_soc)
    return strong


def _strength_rows(cols, v, c0, theta, max_row_sum, abs_soc):
    valid = cols >= 0
    diag, is_diag = _row_diag_rows(cols, v, c0)
    offd = valid & ~is_diag
    big = torch.finfo(v.dtype).max
    scale_max = torch.where(offd, v, -big).amax(0)
    scale_min = torch.where(offd, v, big).amin(0)
    d_neg = diag < 0
    row_scale = torch.where(d_neg, scale_max, scale_min)
    row_sum = sum0(torch.where(valid, v, 0.0))
    if max_row_sum < 1.0:
        weak_all = row_sum.abs() > diag.abs() * max_row_sum
    else:
        weak_all = torch.zeros_like(d_neg)
    if abs_soc:
        abs_scale = torch.where(offd, v.abs(), 0.0).amax(0)
        strong = v.abs() >= theta * abs_scale[None, :]
    else:
        thresh = (theta * row_scale)[None, :]
        strong = torch.where(d_neg[None, :], v > thresh, v < thresh)
    return strong & offd & ~weak_all[None, :]


# ---------------------------------------------------------------------------
# PMIS coarsening (coarsen.py twin; 32-bit measure hash)
# ---------------------------------------------------------------------------

def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h, c in [0, 2**32), with no int64
    overflow (the product is split into 16-bit halves of c)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pmis_hash32(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic [0, 1) float32 hash of the global row id: the
    murmur3 fmix32 finalizer, bit for bit the reference's
    (device_amg.py:291-306).  Computed in int64, masked to 32 bits after
    each step (torch's uint32 arithmetic is incomplete)."""
    h = (ids.to(torch.int64) + (seed & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) / float(1 << 24)


def _pmis_init(A: DEll, strong, seed: int, gid, chunk=None):
    w, n = A.cols.shape
    st_deg = torch.zeros(n, dtype=torch.int32, device=A.device)
    for c0, c1 in _chunks(n, 16 * w, chunk):
        tgt = A.cols[:, c0:c1][strong[:, c0:c1]]
        st_deg.index_add_(0, tgt, torch.ones_like(tgt))
    measure = st_deg.to(torch.float32) + pmis_hash32(gid, seed)
    isolated = ~strong.any(0)
    cf0 = torch.where(isolated, SF_PT, 0).to(torch.int32)
    measure = torch.where(isolated, 0.0, measure)
    return cf0, measure


def _pmis_round(A: DEll, strong, gid, cf, m, chunk=None):
    """One PMIS selection round (device_amg.py:370-419), chunked over
    rows so that only one chunk's (w, m) neighbour reads are alive.
    Returns (cf, m, more) with `more` still on the device."""
    w, n = A.cols.shape
    un = cf == 0
    cand = un & (m > 1.0)
    out = torch.zeros(n, dtype=torch.bool, device=A.device)
    windows = _chunks(n, 40 * w, chunk)
    for c0, c1 in windows:
        cols = A.cols[:, c0:c1]
        st = strong[:, c0:c1]
        cc, mc, gc = cand[c0:c1], m[c0:c1], gid[c0:c1]
        cand_nb = btake(cols, cand, False)
        m_nb = btake(cols, m, 0)
        gid_nb = btake(cols, gid, -1)
        beats_me = (m_nb > mc) | ((m_nb == mc) & (gid_nb > gc))
        out[c0:c1] |= (st & cand_nb & beats_me & cc).any(0)
        # the other side of the edge: i beats its strong neighbour j
        i_beats = (cc & cand_nb & st
                   & ((mc > m_nb) | ((mc == m_nb) & (gc > gid_nb))))
        out.index_fill_(0, cols[i_beats].to(torch.int64), True)
    new_c = cand & ~out
    cf = torch.where(new_c, C_PT, cf).to(torch.int32)
    low = un & (m < 1.0)
    cf = torch.where(low & (cf == 0), F_PT, cf).to(torch.int32)

    is_c = cf == C_PT
    has_c_dep = torch.empty(n, dtype=torch.bool, device=A.device)
    for c0, c1 in windows:
        has_c_dep[c0:c1] = (strong[:, c0:c1] & btake(
            A.cols[:, c0:c1], is_c, False)).any(0)
    make_f = un & ~new_c & ~low & has_c_dep
    cf = torch.where(make_f & (cf == 0), F_PT, cf).to(torch.int32)
    m = torch.where(un & (cf != 0), 0.0, m)
    return cf, m, (cf == 0).any()


def device_pmis(A, strong, seed: int = 2747, global_ids=None,
                chunk: int | None = None, stats: dict | None = None):
    """CF marker (C_PT/F_PT/SF_PT) by PMIS over slot-major cols/strong
    (ref: src/parcsr_ls/par_coarsen.c:2101) with the 32-bit hash; ties
    broken by global id.  One host sync per round (the "more" flag).

    A: a DEll or a bare (w, n) cols tensor.  stats, if given, receives
    the number of rounds."""
    if not isinstance(A, DEll):
        A = DEll(cols=A, vals=A, n_cols=int(A.shape[1]))
    n = A.n_rows
    if global_ids is None:
        global_ids = torch.arange(n, dtype=torch.int32, device=A.device)
    cf, m = _pmis_init(A, strong, seed, global_ids, chunk)
    more = bool((cf == 0).any())
    rounds = 0
    while more:
        cf, m, more_t = _pmis_round(A, strong, global_ids, cf, m, chunk)
        more = bool(more_t)
        rounds += 1
    if stats is not None:
        stats["pmis_rounds"] = rounds
    return cf


# ---------------------------------------------------------------------------
# interpolation (interp.py / interp_ext.py twins)
# ---------------------------------------------------------------------------

def _cmap(cf):
    """Number of C points up to and including each point, minus one:
    the coarse index of each C point."""
    return (torch.cumsum((cf == C_PT).to(torch.int32), 0) - 1).to(
        torch.int32)


def device_direct_interp(A: DEll, strong, cf, n_coarse: int = -1,
                         trunc_factor: float = 0.0, max_elmts: int = 4,
                         chunk: int | None = None) -> DEll:
    """Direct interpolation (type 3), semantics of
    hypre_BoomerAMGBuildDirInterp (ref: src/parcsr_ls/par_interp.c:
    1948-2500).  n_coarse is the caller's synced coarse count."""
    w, n = A.cols.shape
    is_c = cf == C_PT
    cmap = _cmap(cf)
    pc = torch.empty((w, n), dtype=torch.int32, device=A.device)
    pv = torch.empty((w, n), dtype=A.vals.dtype, device=A.device)
    for c0, c1 in _chunks(n, 96 * w, chunk):
        pc[:, c0:c1], pv[:, c0:c1] = _direct_rows(
            A, A.cols[:, c0:c1], A.vals[:, c0:c1], strong[:, c0:c1],
            cf[c0:c1], is_c, cmap, c0)
    P = DEll(cols=pc, vals=pv, n_cols=int(n_coarse))
    if trunc_factor > 0.0 or (0 < max_elmts < w):
        P = device_truncate(P, trunc_factor, max_elmts, chunk)
    return P


def _direct_rows(A, cols, vals, strong, cfch, is_c, cmap, c0):
    w = cols.shape[0]
    diag, is_diag = _row_diag_rows(cols, vals, c0)
    offd = (cols >= 0) & ~is_diag
    strong_c = strong & btake(cols, is_c, False)
    pos = vals > 0
    neg = vals < 0
    sum_n_neg = sum0(torch.where(offd & neg, vals, 0.0))
    sum_n_pos = sum0(torch.where(offd & pos, vals, 0.0))
    sum_p_neg = sum0(torch.where(strong_c & neg, vals, 0.0))
    sum_p_pos = sum0(torch.where(strong_c & pos, vals, 0.0))
    alfa = torch.where(sum_p_neg != 0, sum_n_neg / torch.where(
        sum_p_neg != 0, sum_p_neg * diag, 1.0), 1.0)
    beta = torch.where(sum_p_pos != 0, sum_n_pos / torch.where(
        sum_p_pos != 0, sum_p_pos * diag, 1.0), 1.0)
    row_c = cfch == C_PT
    f_row = ~row_c & (cfch != 0)
    sel = strong_c & f_row[None, :]
    pv = torch.where(vals < 0, -alfa[None, :] * vals, -beta[None, :] * vals)
    pc = torch.where(sel, btake(cols, cmap, -1), -1)
    pv = torch.where(sel, pv, 0.0)
    # C rows interpolate identity (slot 0)
    slot0 = (torch.arange(w, device=cols.device) == 0)[:, None]
    cmap_r = cmap[c0:c0 + cols.shape[1]]
    pc = torch.where(row_c[None, :],
                     torch.where(slot0, cmap_r[None, :], -1), pc)
    pv = torch.where(row_c[None, :], torch.where(slot0, 1.0, 0.0), pv)
    return pc.to(torch.int32), pv


def _extpi_row_bytes(w: int) -> int:
    """Bytes of temporaries per row of one ext+i chunk (estimate)."""
    return 128 * (w + w * w)


def device_extpi_interp(A: DEll, strong, cf, n_coarse: int = -1,
                        trunc_factor: float = 0.0, max_elmts: int = 4,
                        chunk: int | None = None) -> DEll:
    """Extended+i interpolation (type 6), semantics of
    hypre_BoomerAMGBuildExtPIInterp (ref: src/parcsr_ls/par_lr_interp.c:
    1024-1800; device variant par_lr_interp_device.c:1001).

    Per row chunk: the distance-2 pattern Ĉ_i is a sorted candidate
    list of height w(1 + w); membership tests are per-row binary
    searches in it; the distribution term expands each strong-F edge
    over its neighbour row (w² candidates), and the chunk compacts and
    truncates before it is written out, so peak memory is O(chunk · w²),
    never O(n · w²).  Follows the reference's general branch
    (device_amg.py:576-598), every neighbour read through K4."""
    w, n = A.cols.shape
    prep = _extpi_prepare(A, strong, cf)
    pcs, pvs = [], []
    for c0, c1 in _chunks(n, _extpi_row_bytes(w), chunk):
        pc, pv = _extpi_chunk(A, prep, strong[:, c0:c1], cf[c0:c1], c0, c1,
                              trunc_factor, max_elmts)
        pcs.append(pc)
        pvs.append(pv)
    return _extpi_finish(pcs, pvs, prep["cmap"], n_coarse)


def _extpi_prepare(A: DEll, strong, cf) -> dict:
    is_c = cf == C_PT
    diag = torch.empty(A.n_rows, dtype=A.vals.dtype, device=A.device)
    strong_c_all = torch.empty_like(strong)
    for c0, c1 in _chunks(A.n_rows, 24 * A.width):
        cols = A.cols[:, c0:c1]
        diag[c0:c1] = _row_diag_rows(cols, A.vals[:, c0:c1], c0)[0]
        strong_c_all[:, c0:c1] = strong[:, c0:c1] & btake(cols, is_c, False)
    # slots past the last one that holds an entry in any row are padding
    # (dell_pad_width): neighbour rows are read without them
    w_lead = int(A.mask.any(1).nonzero().max()) + 1 if A.n_rows else 1
    return {"cmap": _cmap(cf), "diag": diag, "strong_c_all": strong_c_all,
            "sign_diag": torch.sign(diag), "cf": cf, "w_lead": w_lead}


def _extpi_chunk(A: DEll, prep, strg, cfch, c0, c1, trunc_factor,
                 max_elmts):
    """Gather a row chunk's neighbour data and run the ext+i formulas.

    The distribution term reads the rows of the strong-F neighbours
    only, so only their slots are expanded: `ks` lists them per row
    (ascending slot, compacted, _BIG past the end), and each expanded
    row keeps A's leading w_lead slots (the rest is width padding).
    The reference expands all w x w; the values are the same."""
    cols = A.cols[:, c0:c1]
    vals = A.vals[:, c0:c1]
    w = cols.shape[0]
    cf_nb = btake(cols, prep["cf"], 0)
    sf = strg & (cf_nb == F_PT)
    slot = torch.arange(w, dtype=torch.int32, device=A.device)[:, None]
    ks, = _compact_valid(torch.where(sf, slot, _BIG))        # (w_sf, m)
    has_k = ks < _BIG
    ks_safe = torch.where(has_k, ks, 0).to(torch.int64)
    k_cols = torch.where(has_k, torch.gather(cols, 0, ks_safe), -1)
    k_vals = torch.where(has_k, torch.gather(vals, 0, ks_safe), 0.0)
    wl = prep["w_lead"]
    nb_cols = btake_rows(k_cols, A.cols[:wl], -1)             # (wl, w_sf, m)
    nb_sc = btake_rows(k_cols, prep["strong_c_all"][:wl], False) \
        & (nb_cols >= 0)
    return _extpi_body(
        cols, vals, strg, cfch, prep["diag"][c0:c1], _row_ids(c0, c1,
                                                              A.device),
        cf_nb, ks, k_cols, k_vals, btake(k_cols, prep["sign_diag"], 0),
        nb_cols, nb_sc, btake_rows(k_cols, A.vals[:wl], 0),
        trunc_factor=trunc_factor, max_elmts=max_elmts)


def _member(chat_t: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Membership of each query (q, m) in its row's sorted candidate
    list chat_t (m, c), by binary search; _BIG is never a member."""
    qt = queries.t().contiguous()
    pos = torch.searchsorted(chat_t, qt).clamp_(max=chat_t.shape[1] - 1)
    hit = (torch.gather(chat_t, 1, pos) == qt) & (qt < _BIG)
    return hit.t()


def _unpack_slots(x, ks, w: int, dim: int):
    """x indexed along `dim` by compacted strong-F slots `ks` (see
    _extpi_chunk), laid back out over all w slots (zero elsewhere)."""
    shape = list(x.shape)
    shape[dim] = w + 1                  # slot w collects the empty ones
    out = x.new_zeros(shape)
    idx = torch.where(ks < _BIG, ks, w).to(torch.int64)
    out.scatter_(dim, idx.expand_as(x), x)
    return out.narrow(dim, 0, w)


def _extpi_body(cols, vals, strg, cfch, diagch, gid, cf_nb, ks, k_cols,
                k_vals, k_sign, nb_cols, nb_sc, t_a, *, trunc_factor,
                max_elmts):
    """The ext+i row formulas over pre-gathered neighbour data
    (device_amg.py:751-875; hypre_BoomerAMGBuildExtPIInterp, ref:
    src/parcsr_ls/par_lr_interp.c:1024-1800).  The (l, k) arrays hold
    the strong-F slots k only (ks, k_cols, k_vals, k_sign); sums over
    slots are taken as the reference takes them over all w."""
    w, m = cols.shape
    wc = w * (1 + w)
    valid = cols >= 0
    sc = strg & (cf_nb == C_PT)
    sf = strg & (cf_nb == F_PT)
    col_is_sf = cf_nb == SF_PT
    f_row = cfch == F_PT
    row_is_c = cfch == C_PT
    is_diag_slot = valid & (cols == gid[None, :])
    offd = valid & ~is_diag_slot
    wl, wsf = nb_cols.shape[:2]

    # ---- Ĉ: sorted candidate list (duplicates fine), rows leading ----
    cand1 = torch.where(sc, cols, _BIG)                       # (w, m)
    cand2 = torch.where(nb_sc, nb_cols, _BIG)                 # (wl, wsf, m)
    chat, = _compact_valid(torch.cat([cand1, cand2.reshape(wl * wsf, m)]))
    chat_t = chat.t().contiguous().sort(dim=1).values         # (m, <= wc)
    del cand1, cand2, chat

    # ---- direct: A entries with col in Ĉ ----
    direct_sel = offd & f_row[None, :] & _member(
        chat_t, torch.where(offd, cols, _BIG))
    d = diagch

    # ---- weak: offd, not direct, not strong-F, not SF ----
    weak_sel = offd & f_row[None, :] & ~direct_sel & ~sf & ~col_is_sf
    d = d + sum0(torch.where(weak_sel, vals, 0.0))

    # ---- distribution over strong-F neighbours ----
    # row k of A expanded for each strong-F slot k: (w_l, w_k, m)
    t_l = nb_cols
    t_valid = nb_cols >= 0
    not_diag = t_l != k_cols[None]
    sign_ok = (k_sign[None] * t_a) < 0
    memb = _member(chat_t, torch.where(t_valid, t_l, _BIG).reshape(
        wl * wsf, m)).reshape(wl, wsf, m)
    is_self = t_l == gid[None, None, :]
    in_den = t_valid & not_diag & sign_ok & (memb | is_self)

    denom = sum0(torch.where(in_den, t_a, 0.0), length=w)    # (wsf, m)
    has_den = denom != 0
    dist = torch.where(has_den, k_vals / torch.where(has_den, denom, 1.0),
                       0.0)
    # s == 0: a_ik to the diagonal
    has_den_w = _unpack_slots(has_den, ks, w, 0)
    d = d + sum0(torch.where(sf & ~has_den_w, vals, 0.0))
    # "+i" self term: at most one l per k.  Up to 32 x 32 the reference
    # sums (l, k) in row-major order, which the compacted layout keeps;
    # beyond, its windows need the full (w, w) layout
    dist_t = dist[None] * t_a
    self_v = torch.where(in_den & is_self & has_den[None], dist_t, 0.0)
    if w > SUM_WINDOW:
        self_v = _unpack_slots(torch.cat([self_v, self_v.new_zeros(
            (w - wl, wsf, m))]), ks[None], w, 1)
    d = d + sum01(self_v)
    del self_v

    contrib_sel = in_den & memb & has_den[None]
    contrib_v = torch.where(contrib_sel, dist_t, 0.0)
    contrib_c = torch.where(contrib_sel, t_l, -1)
    del dist_t, memb, in_den, sign_ok, not_diag, t_valid, chat_t

    # ---- assemble, normalize, truncate ----
    # (l, k) candidates in the reference's row-major order, empty k left
    # out: the order of the others is unchanged
    cand_c = torch.cat([torch.where(direct_sel, cols, -1),
                        contrib_c.reshape(wl * wsf, m)])
    cand_v = torch.cat([torch.where(direct_sel, vals, 0.0),
                        contrib_v.reshape(wl * wsf, m)])
    del contrib_c, contrib_v
    # the reference's P chunk has wc slots; here only as many as hold
    # entries, and truncation sums as over wc (device_truncate `length`)
    pc, pv = _slot_compact(cand_c, cand_v)
    dsafe = torch.where(d != 0, -d, 1.0)
    pv = pv / dsafe[None, :]

    # C identity rows; SF rows stay empty
    slot0 = (torch.arange(pc.shape[0], device=cols.device) == 0)[:, None]
    pc = torch.where(row_is_c[None, :],
                     torch.where(slot0, gid[None, :], -1), pc)
    pv = torch.where(row_is_c[None, :], torch.where(slot0, 1.0, 0.0), pv)
    # n_cols is provisional: _extpi_finish renumbers fine -> coarse
    Pch = DEll(cols=pc.to(torch.int32), vals=pv, n_cols=int(m))
    if trunc_factor > 0.0 or (0 < max_elmts < wc):
        Pch = device_truncate(Pch, trunc_factor, max_elmts, length=wc)
    else:
        Pch = _pad_slots(Pch, wc)
    return Pch.cols, Pch.vals


def _pad_slots(M: DEll, width: int) -> DEll:
    """M with empty slots appended up to `width`."""
    ex = width - M.width
    if ex <= 0:
        return M
    return DEll(cols=torch.cat([M.cols, M.cols.new_full((ex, M.n_rows), -1)]),
                vals=torch.cat([M.vals, M.vals.new_zeros((ex, M.n_rows))]),
                n_cols=M.n_cols)


def _extpi_finish(pcs, pvs, cmap, n_coarse: int) -> DEll:
    """(w_out, n) from the chunks, columns renumbered fine -> coarse."""
    pcols = torch.cat(pcs, dim=1) if len(pcs) > 1 else pcs[0]
    pvals = torch.cat(pvs, dim=1) if len(pvs) > 1 else pvs[0]
    return DEll(cols=btake(pcols, cmap, -1), vals=pvals,
                n_cols=int(n_coarse))


# ---------------------------------------------------------------------------
# slot-axis sort helpers, SpGEMM, transpose, truncation
# ---------------------------------------------------------------------------

def _compact_valid(key: torch.Tensor, *payload: torch.Tensor):
    """Move each column's entries with key < _BIG to its low slots, in
    their order, and cut the height to the largest count (one sync).

    Candidate lists are mostly empty slots (_BIG), and those sort last;
    so a sort, a run sum or a membership test over the compacted list
    gives the same values, bit for bit, at a fraction of the cost.
    Returns (key, *payload) of height >= 1; the others hold _BIG / 0."""
    k, m = key.shape
    valid = key < _BIG
    kv = max(int(valid.sum(0).max()) if m else 0, 1)
    if kv >= k:
        return (key, *payload)
    tgt = torch.where(valid, _int_cumsum0(valid) - 1, kv)
    out = []
    for x, empty in ((key, _BIG),) + tuple((p, 0) for p in payload):
        y = x.new_full((kv + 1, m), empty)
        y.scatter_(0, tgt, x)          # row kv collects the empty slots
        out.append(y[:kv])
    return tuple(out)


def _sort0(key: torch.Tensor, stable: bool = True):
    """Sort each column of a (k, m) tensor along the slot axis.  Returns
    (sorted keys, source slot) as (k, m) views.  The sort runs on the
    transposed, row-contiguous copy, so each row is one segment."""
    s, order = torch.sort(key.t().contiguous(), dim=1, stable=stable)
    return s.t(), order.t()


def _slot_compact(cand_cols, cand_vals):
    """Per-row dedup over the slot axis: sort candidate (col, val) slots
    by col (stable), sum runs of equal cols, compact to the low slots
    (ascending cols).  cand_cols int32 (k, m) with -1 padding.  The
    result has as many slots as the largest candidate count of a row;
    the rows of fewer distinct cols end in empty slots.

    A run's total is cum[run end] - cum[just before the run], cum the
    cumulative sum in sorted order (device_amg.py:1036-1053): the
    reference's order of summation, kept."""
    key, cand_vals = _compact_valid(
        torch.where(cand_cols >= 0, cand_cols, _BIG), cand_vals)
    k, m = key.shape
    sc, order = _sort0(key)
    sv = torch.gather(cand_vals, 0, order)
    del order, key, cand_vals
    valid = sc < _BIG
    differ = sc[1:] != sc[:-1]
    new = valid.clone()
    new[1:] &= differ
    last = valid.clone()
    last[:-1] &= differ
    del differ
    slot = _int_cumsum0(new) - 1
    cum = cumsum0(sv)
    del sv
    prev = torch.cat([cum.new_zeros((1, m)), cum[:-1]])
    iota = torch.arange(k, device=sc.device)[:, None]
    # a running max of integers: exact in any order, scanned per column
    start_idx = torch.cummax(torch.where(new, iota, -1).t(), 1).values \
        .t().clamp_(min=0)
    total = cum - torch.gather(prev, 0, start_idx)
    del cum, prev, start_idx
    tgt = torch.where(last, slot, k)
    oc = torch.full((k + 1, m), -1, dtype=torch.int32, device=sc.device)
    ov = torch.zeros((k + 1, m), dtype=total.dtype, device=sc.device)
    oc.scatter_(0, tgt, torch.where(last, sc, -1).to(torch.int32))
    ov.scatter_(0, tgt, torch.where(last, total, 0.0))
    return oc[:k], ov[:k]


def _rank_desc(mag, valid):
    """rank[s, i] = position of slot s among row i's slots ordered by
    descending mag (invalid slots last, ties by slot id)."""
    w, m = mag.shape
    key = torch.where(valid, -mag, torch.finfo(mag.dtype).max)
    _, sslot = _sort0(key)
    rank = torch.empty((w, m), dtype=torch.int64, device=mag.device)
    rank.scatter_(0, sslot, torch.arange(w, device=mag.device)[:, None]
                  .expand(w, m).contiguous())
    return rank


def _spgemm_row_bytes(wa: int, wb: int) -> int:
    return 128 * wa * wb


def device_spgemm(A: DEll, B: DEll, chunk: int | None = None) -> DEll:
    """C = A @ B (ref: src/seq_mv/csr_spgemm_device.c:15 — the two-pass
    hash SpGEMM becomes gather + per-row sort + segment sum), chunked
    over A's rows to bound the (wa·wb, chunk) candidate buffers.  The
    B-row expansion is kernel K4, B.cols and B.vals each one launch.

    One pass: C's width, the most distinct cols of any row (the
    reference's device_spgemm_width), is taken from the compacted
    chunks themselves, each of which is cut or padded to it (a row's
    entries do not depend on the width past its own)."""
    wa, n = A.cols.shape
    parts = []
    for c0, c1 in _chunks(n, _spgemm_row_bytes(wa, B.width), chunk):
        ac = A.cols[:, c0:c1]
        bc = btake_rows(ac, B.cols, -1)                 # (wb, wa, m)
        bv = btake_rows(ac, B.vals, 0) * A.vals[:, c0:c1][None]
        m = c1 - c0
        parts.append(_slot_compact(bc.reshape(-1, m), bv.reshape(-1, m)))
        del bc, bv
    width = max(max(int((c >= 0).sum(0).max()) for c, _ in parts), 1)
    parts = [_pad_slots(DEll(c[:width], v[:width], 0), width)
             for c, v in parts]
    cols = torch.cat([M.cols for M in parts], dim=1)
    vals = torch.cat([M.vals for M in parts], dim=1)
    return DEll(cols=cols, vals=vals, n_cols=B.n_cols)


def device_transpose_width(M: DEll) -> int:
    """Max entries in any column of M (host int; one sync)."""
    if not M.n_cols:
        return 1
    counts = torch.bincount(M.cols[M.mask].to(torch.int64),
                            minlength=M.n_cols)
    return max(int(counts.max()), 1) if counts.numel() else 1


def device_transpose(M: DEll, out_width: int) -> DEll:
    """M^T by one stable sort of all entries by column (the cusparse
    csr2csc analog, ref: src/seq_mv/csr_matop_device.c).  Entries are
    taken in row-major order, so within an output row the slots hold
    ascending source rows, as in the reference's chunked version."""
    w, n = M.cols.shape
    n_cols = M.n_cols
    cols_r = M.cols.t().reshape(-1)                     # row-major
    key = torch.where(cols_r >= 0, cols_r, _BIG)
    scol, perm = torch.sort(key, stable=True)
    counts = torch.bincount(M.cols[M.mask].to(torch.int64),
                            minlength=n_cols)
    nnz = int(counts.sum())
    scol = scol[:nnz].to(torch.int64)
    perm = perm[:nnz]
    starts = torch.cumsum(counts, 0) - counts
    local = torch.arange(nnz, device=M.device) - starts[scol]
    flat = local * n_cols + scol
    oc = torch.full((out_width * n_cols,), -1, dtype=torch.int32,
                    device=M.device)
    ov = torch.zeros((out_width * n_cols,), dtype=M.vals.dtype,
                     device=M.device)
    oc[flat] = (perm // w).to(torch.int32)
    ov[flat] = M.vals.t().reshape(-1)[perm]
    return DEll(cols=oc.reshape(out_width, n_cols),
                vals=ov.reshape(out_width, n_cols), n_cols=n)


def device_truncate(P: DEll, trunc_factor: float, max_elmts: int,
                    chunk: int | None = None,
                    length: int | None = None) -> DEll:
    """Interpolation truncation (ref: src/parcsr_mv/par_csr_matrix.c:
    2874): drop entries below trunc_factor * row-inf-norm, keep the
    max_elmts largest by magnitude, rescale to preserve row sums.
    Output width = max_elmts when it is below the input width.

    length: the width the reference's P has when only the first slots
    of a wider, otherwise empty P are given (sets the output width and
    the order of the row sums); default P.width."""
    w, n = P.cols.shape
    L = w if length is None else length
    kw = max_elmts if 0 < max_elmts < L else L
    cols = torch.empty((kw, n), dtype=torch.int32, device=P.device)
    vals = torch.empty((kw, n), dtype=P.vals.dtype, device=P.device)
    for c0, c1 in _chunks(n, 96 * w, chunk):
        cols[:, c0:c1], vals[:, c0:c1] = _truncate_rows(
            P.cols[:, c0:c1], P.vals[:, c0:c1], trunc_factor, kw, L)
    return DEll(cols=cols, vals=vals, n_cols=P.n_cols)


def _truncate_rows(pcols, pvals, trunc_factor, kw, length):
    mask = pcols >= 0
    vals = torch.where(mask, pvals, 0.0)
    absv = vals.abs()
    keep = mask
    if trunc_factor > 0.0:
        row_nrm = absv.amax(0)
        keep = keep & (absv >= trunc_factor * row_nrm[None, :])
    if kw < length:
        # rank by descending magnitude among kept entries; keep the
        # first kw
        keep = keep & (_rank_desc(absv, keep) < kw)
    row_sum = sum0(vals, length)
    kept_sum = sum0(torch.where(keep, vals, 0.0), length)
    scale = torch.where(kept_sum != 0, row_sum / kept_sum, 1.0)
    newv = torch.where(keep, vals * scale[None, :], 0.0)
    newc = torch.where(keep, pcols, _BIG)
    # compact kept entries to the low slots (ascending col)
    sc, order = _sort0(newc)
    sc, order = sc[:kw], order[:kw]
    sv = torch.gather(newv, 0, order)
    ok = sc < _BIG
    out = DEll(cols=torch.where(ok, sc, -1).to(torch.int32),
               vals=torch.where(ok, sv, 0.0), n_cols=0)
    out = _pad_slots(out, kw)
    return out.cols, out.vals


def device_rap(A: DEll, P: DEll, chunk: int | None = None,
               stats: dict | None = None):
    """Galerkin triple product Ac = P^T (A P) on the card (device_amg.py:
    889-925, the device_transpose branch).  Returns (Ac, P^T)."""
    AP = device_spgemm(A, P, chunk=chunk)
    PT = device_transpose(P, device_transpose_width(P))
    Ac = device_spgemm(PT, AP, chunk=chunk)
    if stats is not None:
        stats.update(w_ap=AP.width, w_pt=PT.width, w_ac=Ac.width)
    return Ac, PT


def device_diagonal(A: DEll) -> torch.Tensor:
    """The diagonal of A, zero where a row stores none (the reference's
    ``_row_diag``, device_amg.py:457)."""
    d = torch.empty(A.n_rows, dtype=A.vals.dtype, device=A.device)
    for c0, c1 in _chunks(A.n_rows, 16 * A.width):
        d[c0:c1] = _row_diag_rows(A.cols[:, c0:c1], A.vals[:, c0:c1], c0)[0]
    return d


def device_l1_norms(A: DEll, option: int = 1) -> torch.Tensor:
    """Smoother l1 row norms, matching setup/l1norms.l1_norms on one
    process (ref: src/parcsr_ls/ams.c:628-760): option 1 = full row l1;
    option 4 without off-process couplings = |a_ii|; option 5 = plain
    diagonal."""
    l1 = torch.empty(A.n_rows, dtype=A.vals.dtype, device=A.device)
    for c0, c1 in _chunks(A.n_rows, 32 * A.width):
        cols, vals = A.cols[:, c0:c1], A.vals[:, c0:c1]
        diag, _ = _row_diag_rows(cols, vals, c0)
        if option == 5:
            r = diag
        elif option == 4:
            r = torch.where(diag < 0, -diag.abs(), diag.abs())
        else:
            # reaches only the smoother: no need for the reference's order
            r = torch.where(cols >= 0, vals.abs(), 0.0).sum(0)
            r = torch.where(diag < 0, -r, r)
        l1[c0:c1] = r
    return torch.where(l1 != 0, l1, 1.0)


# ---------------------------------------------------------------------------
# level loop (iter_host_hierarchy twin, fully on the card)
# ---------------------------------------------------------------------------

def stage_mark() -> tuple:
    """A setup stage boundary: the host clock (ns) and, while the tracer
    is on, K4's launch count (0 while it is off)."""
    return time.perf_counter_ns(), btake_rows.launches if trace.on else 0


def iter_device_hierarchy(A: DEll, cfg, stats: list | None = None,
                          note=None):
    """Device-resident AMG setup level loop (ref: src/parcsr_ls/
    par_amg_setup.c:29; device_amg.py:932-990).  Yields
    (A_l, P_l, R_l = P_l^T, cf_l) per level, then the coarsest A.  No
    matrix leaves the card: the host reads the coarse size, the output
    widths and the PMIS flag.  Always coarsens by PMIS, as the
    reference does.

    stats, if given, receives one dict per level with the wall seconds
    of each stage (the card is synchronised at each stage's end) and
    the widths; while the tracer is on, the same clock readings are the
    spans setup.strength, setup.pmis, setup.interp and setup.rap
    (``level``, PMIS's ``rounds``, K4's launches as ``btake``).
    note(msg), if given, is called after each stage."""
    dev = A.device
    Al = A
    for level in range(cfg.max_levels - 1):
        n = Al.n_rows
        if n <= cfg.max_coarse_size:
            break
        st = {"level": level, "n": n, "w": Al.width}
        t0, k0 = stage_mark()
        strong = device_strength(Al, cfg.strong_threshold, cfg.max_row_sum)
        synchronize(dev)
        t1, k1 = stage_mark()
        cf = device_pmis(Al, strong, seed=cfg.seed, stats=st)
        n_coarse = int((cf == C_PT).sum())
        t2, k2 = stage_mark()
        st.update(strength_s=(t1 - t0) / 1e9, pmis_s=(t2 - t1) / 1e9,
                  n_coarse=n_coarse)
        if trace.on:
            trace.add("setup.strength", t0, t1, level=level, btake=k1 - k0)
            trace.add("setup.pmis", t1, t2, level=level,
                      rounds=st["pmis_rounds"], btake=k2 - k1)
        if note:
            note(f"level {level} strength + PMIS ({st['pmis_rounds']} "
                 f"rounds): n={n} -> {n_coarse}")
        if n_coarse == 0 or n_coarse == n:
            if stats is not None:
                stats.append(st)
            break
        if cfg.interp_type == 3:
            P = device_direct_interp(
                Al, strong, cf, n_coarse=n_coarse,
                trunc_factor=cfg.trunc_factor, max_elmts=cfg.p_max_elmts)
        else:
            P = device_extpi_interp(
                Al, strong, cf, n_coarse=n_coarse,
                trunc_factor=cfg.trunc_factor, max_elmts=cfg.p_max_elmts)
        del strong
        synchronize(dev)
        t3, k3 = stage_mark()
        Ac, PT = device_rap(Al, P, stats=st)
        synchronize(dev)
        t4, k4 = stage_mark()
        st.update(interp_s=(t3 - t2) / 1e9, rap_s=(t4 - t3) / 1e9,
                  w_p=P.width)
        if stats is not None:
            stats.append(st)
        if trace.on:
            trace.add("setup.interp", t2, t3, level=level, btake=k3 - k2)
            trace.add("setup.rap", t3, t4, level=level, btake=k4 - k3)
        if note:
            note(f"level {level} interp {st['interp_s']:.3f}s, RAP "
                 f"{st['rap_s']:.3f}s (w_P={P.width}, w_AP={st['w_ap']}, "
                 f"w_Ac={st['w_ac']})")
        yield (Al, P, PT, cf)
        # the reference rounds each coarse A's width up to a bucket; the
        # order of its sums over a row depends on that width
        Al = dell_pad_width(Ac)
    yield Al
