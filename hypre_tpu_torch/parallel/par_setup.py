"""Distributed BoomerAMG setup on the stacked shards.

Port of hypre_tpu/parallel/par_setup.py (``ParDEll`` :62,
``discover_ghosts`` :170, ``build_level_comm`` :199, ``par_strength``
:260, ``par_pmis`` :304, ``coarse_partition`` :393, ``par_direct_
interp`` :440, ``par_extpi_interp`` :500, ``par_transpose`` :698,
``par_spgemm`` :770, ``iter_par_hierarchy`` :814): the hierarchy is
built without a global level.  Each level is a ``ParDEll``, per-shard
slot-major blocks with GLOBAL column ids stacked on a leading shard
axis; every cross-shard value moves through the communicator's
exchanges (parallel/comm.py) and the host reads only O(ghost) metadata
(ghost id lists, widths, coarse counts, the PMIS flag).

  hypre (ref)                              here
  --------------------------------------   ---------------------------
  ParCSR diag/offd + col_map_offd          ParDEll + ext ids: [0, nl)
  (par_csr_matrix.h:27-86)                 own column, nl + ghost slot
  hypre_MatvecCommPkgCreate                build_level_comm
  hypre_ParCSRMatrixExtractBExt            exchange_mat of row payloads
  par PMIS + outer-boundary exchange       par_pmis: halo gathers and
  (par_coarsen.c:2101)                     exchange_rev rounds
  BuildDirInterp / BuildExtPIInterp        par_direct_interp /
                                           par_extpi_interp (ghost rows)
  RAP via triple products + row sends      par_transpose + par_spgemm
  coarse row_starts (unequal)              GenPartition

Every stage is torch on the whole ``(n_shards, ...)`` stack: a
row-local formula runs on the slot-major view ``(w, n_shards n_local)``
of all shards' rows at once, through the same functions as the
single-device setup (setup/device_amg.py), and a neighbour read is one
gather (kernel K4 on the card) from a per-shard table of own plus ghost
entries.  So the C/F splits, coarse numbering and operators are those
of the single-device setup, bit for bit: the PMIS measures hash the
global row id, the coarse numbering is shard-major (= global ascending),
each row's slots hold ascending columns as there, and the coarse A's
width is rounded up to the same bucket (its sums run in slot order).

The stacked executor only: a DistComm rank would need every shard's
ghost lists to build a schedule (an all_gather of O(ghost) ids), which
is not written.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.core.errors import HypreTpuError
from hypre_tpu_torch.ops.btake import btake, btake_rows
from hypre_tpu_torch.parallel.comm import CommPkg, StackedComm, build_comm_pkg
from hypre_tpu_torch.parallel.partition import (
    GenPartition, true_counts, true_starts,
)
from hypre_tpu_torch.setup import device_amg as dev
from hypre_tpu_torch.setup.device_amg import C_PT, F_PT, SF_PT
from hypre_tpu_torch.setup.xla_order import sum0

_BIG = dev._BIG


@dataclasses.dataclass(frozen=True)
class ParDEll:
    """Sharded slot-major padded ELL with GLOBAL column ids.

    cols: int32 (n_shards, w, n_local), -1 padding
    vals: f64   (n_shards, w, n_local)
    Local slot i of shard p is global row starts[p] + i; slots past the
    shard's true count are empty padding rows."""

    cols: torch.Tensor
    vals: torch.Tensor
    row_part: object
    col_part: object
    communicator: object

    @property
    def n_shards(self) -> int:
        return int(self.cols.shape[0])

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def n_local(self) -> int:
        return int(self.cols.shape[2])

    @property
    def device(self):
        return self.cols.device

    def nnz(self) -> int:
        return int((self.cols >= 0).sum())

    def view(self):
        """(cols, vals) as (w, n_shards n_local): every shard's rows."""
        return _view(self.cols), _view(self.vals)

    def l1_norms(self, option: int = 1) -> torch.Tensor:
        """Smoother l1 row norms (n_shards, n_local), the single-device
        device_l1_norms on each row (own rows only, no exchange)."""
        cols, vals = self.view()
        gid = gids_stacked(self.row_part, self.device).reshape(-1)
        diag = torch.where((cols >= 0) & (cols == gid[None, :]), vals,
                           0.0).sum(0)
        if option == 5:
            r = diag
        elif option == 4:
            r = torch.where(diag < 0, -diag.abs(), diag.abs())
        else:
            r = torch.where(cols >= 0, vals.abs(), 0.0).sum(0)
            r = torch.where(diag < 0, -r, r)
        r = torch.where(r != 0, r, 1.0)
        return r.reshape(self.n_shards, self.n_local)


def _view(x: torch.Tensor) -> torch.Tensor:
    """(n_shards, w, nl) -> (w, n_shards nl), contiguous (K4 reads its
    index rows with unit stride; with nl = 1 a reshape alone is a
    strided view)."""
    ns, w, nl = x.shape
    return x.permute(1, 0, 2).reshape(w, ns * nl).contiguous()


def _unview(y: torch.Tensor, ns: int, nl: int) -> torch.Tensor:
    """(w, n_shards nl) -> (n_shards, w, nl)."""
    return y.reshape(y.shape[0], ns, nl).permute(1, 0, 2).contiguous()


def _check_stacked(communicator):
    if not isinstance(communicator, StackedComm):
        raise HypreTpuError("the distributed setup runs on the stacked "
                            "executor (StackedComm) only")


def gids_stacked(part, device) -> torch.Tensor:
    """Global id of each slot, (n_shards, n_local): starts[p] + i."""
    st = torch.as_tensor(true_starts(part)[:-1], device=device)
    return (st[:, None] + torch.arange(part.n_local, device=device)[None, :]
            ).to(torch.int32)


def real_rows(part, device) -> torch.Tensor:
    cnt = torch.as_tensor(true_counts(part), device=device)
    return torch.arange(part.n_local, device=device)[None, :] < cnt[:, None]


def pardell_from_scipy(A, part, col_part=None, communicator=None,
                       width: int | None = None) -> ParDEll:
    """Host conversion of a global scipy matrix (each shard's row slice;
    tests and fine-level ingestion), f64 on the communicator's
    device."""
    communicator = communicator or StackedComm(part.n_shards)
    _check_stacked(communicator)
    A = A.tocsr().astype(np.float64)
    A.sort_indices()
    col_part = col_part or part
    ns, nl = part.n_shards, part.n_local
    w = width or max(int(np.diff(A.indptr).max(initial=0)), 1)
    rn = np.diff(A.indptr)
    rows = np.repeat(np.arange(A.shape[0]), rn)
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], rn)
    p = part.owner(rows)
    loc = rows - true_starts(part)[p]
    cols = np.full((ns, w, nl), -1, dtype=np.int32)
    vals = np.zeros((ns, w, nl))
    cols[p, slot, loc] = A.indices
    vals[p, slot, loc] = A.data
    d = communicator.device
    return ParDEll(cols=torch.as_tensor(cols, device=d),
                   vals=torch.as_tensor(vals, device=d), row_part=part,
                   col_part=col_part, communicator=communicator)


def pardell_to_scipy(M: ParDEll) -> sp.csr_matrix:
    """Gather to a global scipy matrix (tests only)."""
    cols = M.cols.cpu().numpy()
    vals = M.vals.cpu().numpy()
    ns, w, nl = cols.shape
    st = true_starts(M.row_part)
    rows_g = np.broadcast_to(st[:ns, None, None] + np.arange(nl)[None, None],
                             cols.shape)
    real = np.arange(nl)[None, None, :] < true_counts(M.row_part)[:, None,
                                                                   None]
    mask = (cols >= 0) & real
    A = sp.csr_matrix((vals[mask], (rows_g[mask], cols[mask])),
                      shape=(M.row_part.n_global, M.col_part.n_global))
    A.sum_duplicates()
    A.sort_indices()
    return A


def pad_width(M: ParDEll) -> ParDEll:
    """The slot axis rounded up to the single-device setup's bucket
    (device_amg.dell_pad_width): the order of a row's sums follows it."""
    w = next((b for b in dev._W_BUCKETS if M.width <= b), M.width)
    if w == M.width:
        return M
    ns, nl = M.n_shards, M.n_local
    return dataclasses.replace(
        M, cols=torch.cat([M.cols, M.cols.new_full((ns, w - M.width, nl),
                                                   -1)], 1),
        vals=torch.cat([M.vals, M.vals.new_zeros((ns, w - M.width, nl))],
                       1))


# ---------------------------------------------------------------------------
# ghost discovery + ext remap
# ---------------------------------------------------------------------------

def discover_ghosts(M: ParDEll):
    """Per shard, the sorted unique off-owner global columns (host
    lists; O(ghost) to the host), found by one unique on the card."""
    ns = M.n_shards
    st = torch.as_tensor(true_starts(M.col_part), device=M.device)
    c = M.cols.reshape(ns, -1).to(torch.int64)
    off = (c >= 0) & ((c < st[:-1, None]) | (c >= st[1:, None]))
    big = max(M.col_part.n_global, 1)
    shard = torch.arange(ns, device=M.device)[:, None].expand_as(c)
    keys = torch.unique((shard * big + c)[off]).cpu().numpy()
    p = keys // big
    bounds = np.searchsorted(p, np.arange(ns + 1))
    return [keys[bounds[q]:bounds[q + 1]] - q * big for q in range(ns)]


def build_level_comm(M: ParDEll):
    """Ghost discovery + CommPkg + ext ids of M's columns: [0, n_local
    of the column partition) own, n_local + ghost slot otherwise, -1
    padding.  Returns (cols_ext, cp)."""
    ghost_lists = discover_ghosts(M)
    cp = build_comm_pkg(ghost_lists, M.col_part)
    ns = M.n_shards
    gpad = np.full((ns, cp.n_ghost), np.iinfo(np.int64).max, np.int64)
    for q in range(ns):
        gpad[q, :len(ghost_lists[q])] = ghost_lists[q]
    st = torch.as_tensor(true_starts(M.col_part), device=M.device)
    c = M.cols.reshape(ns, -1).to(torch.int64)
    valid = c >= 0
    local = valid & (c >= st[:-1, None]) & (c < st[1:, None])
    slot = torch.searchsorted(torch.as_tensor(gpad, device=M.device),
                              c.contiguous())
    ncl = M.col_part.n_local
    ext = torch.where(local, c - st[:-1, None], ncl + slot)
    ext = torch.where(valid, ext, -1).to(torch.int32)
    return ext.reshape(M.cols.shape), cp


@dataclasses.dataclass(frozen=True)
class Halo:
    """One operator's halo: its ext ids, schedule and the flat index of
    each slot into a stacked (n_shards, n_local + n_ghost) table."""

    cols_ext: torch.Tensor          # (ns, w, nl)
    cp: CommPkg
    flat: torch.Tensor              # int32 (w, ns nl), -1 padding
    n_local_col: int
    communicator: object

    def table(self, x: torch.Tensor) -> torch.Tensor:
        """x (ns, n_local_col[, F]) with each shard's ghost entries
        appended, flattened: (ns (n_local_col + n_ghost)[, F]).  Row
        payloads (F) are the ExtractBExt step, exchange_mat."""
        comm = self.communicator
        ex = comm.exchange_mat if x.dim() > 2 else comm.exchange
        g = ex(x, self.cp)
        t = torch.cat([x, g[:, :self.cp.n_ghost]], dim=1)
        return t.reshape((-1,) + tuple(x.shape[2:]))

    def gather(self, x: torch.Tensor, fill) -> torch.Tensor:
        """x at every slot's column, (w, ns nl); `fill` on padding."""
        return btake(self.flat, self.table(x), fill)

    def gather_rows(self, X: torch.Tensor, fill) -> torch.Tensor:
        """Row payloads (ns, n_local_col, F) at every slot's column:
        (F, w, ns nl)."""
        t = self.table(X)                       # (ns (nl + ng), F)
        return btake_rows(self.flat, t.t().contiguous(), fill)


def level_halo(M: ParDEll, communicator) -> Halo:
    ce, cp = build_level_comm(M)
    ns, w, nl = ce.shape
    width = M.col_part.n_local + cp.n_ghost
    base = (torch.arange(ns, device=ce.device) * width)[:, None, None]
    flat = torch.where(ce >= 0, base + ce, -1).to(torch.int32)
    return Halo(cols_ext=ce, cp=cp, flat=_view(flat),
                n_local_col=M.col_part.n_local, communicator=communicator)


# ---------------------------------------------------------------------------
# strength, PMIS, coarse numbering
# ---------------------------------------------------------------------------

def par_strength(M: ParDEll, theta: float = 0.25,
                 max_row_sum: float = 0.9) -> torch.Tensor:
    """Strong mask (w, ns nl) over M's slots (par_strength.c:531; the
    single-device _strength_rows with the diagonal found by global id).
    Row-local: no communication."""
    cols, v = M.view()
    gid = gids_stacked(M.row_part, M.device).reshape(-1)
    valid = cols >= 0
    is_diag = valid & (cols == gid[None, :])
    diag = torch.where(is_diag, v, 0.0).sum(0)
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
    thresh = (theta * row_scale)[None, :]
    strong = torch.where(d_neg[None, :], v > thresh, v < thresh)
    return strong & offd & ~weak_all[None, :]


def _scatter_rev(h: Halo, sel: torch.Tensor, n_local: int, dtype):
    """Per-row count of the slots `sel` (w, ns nl) that point at each
    row, own rows directly and ghost rows through the reverse
    exchange: the |S^T| degree and PMIS's scatter side."""
    cp = h.cp
    ns = h.cols_ext.shape[0]
    width = n_local + cp.n_ghost
    acc = torch.zeros(ns * width, dtype=dtype, device=sel.device)
    idx = h.flat[sel].to(torch.int64)
    acc.index_add_(0, idx, torch.ones_like(idx, dtype=dtype))
    acc = acc.reshape(ns, width)
    back = h.communicator.exchange_rev(acc[:, n_local:], cp, n_local)
    return acc[:, :n_local] + back


def par_pmis(M: ParDEll, h: Halo, strong: torch.Tensor, seed: int = 2747,
             stats: dict | None = None) -> torch.Tensor:
    """Distributed PMIS (par_coarsen.c:2101 with the outer-boundary
    exchanges of par_coarsen_device.c:30; par_setup.py:304): measures
    hash the GLOBAL row id (pmis_hash32), so the C/F split is the
    single-device one.  One host read a round, as hypre allreduces the
    count of unassigned points.  Returns cf (ns, nl)."""
    ns, nl = M.n_shards, M.n_local
    gid = gids_stacked(M.row_part, M.device)
    real = real_rows(M.row_part, M.device)
    st_deg = _scatter_rev(h, strong, nl, torch.float32)
    measure = st_deg + dev.pmis_hash32(gid, seed)
    isolated = ~strong.any(0).reshape(ns, nl)
    cf = torch.where(isolated | ~real, SF_PT, 0).to(torch.int32)
    m = torch.where(cf == SF_PT, 0.0, measure)
    rounds = 0
    mv = lambda x: x.reshape(-1)            # noqa: E731
    while True:
        un = cf == 0
        cand = un & (m > 1.0)
        cand_nb = h.gather(cand, False)
        m_nb = h.gather(m, 0.0)
        gid_nb = h.gather(gid, -1)
        mc, gc, cc = mv(m)[None, :], mv(gid)[None, :], mv(cand)[None, :]
        beats_me = (m_nb > mc) | ((m_nb == mc) & (gid_nb > gc))
        out_row = (strong & cand_nb & beats_me & cc).any(0)
        i_beats = (cc & cand_nb & strong
                   & ((mc > m_nb) | ((mc == m_nb) & (gc > gid_nb))))
        out_sc = _scatter_rev(h, i_beats, nl, torch.int32) > 0
        new_c = cand & ~(out_row.reshape(ns, nl) | out_sc)
        cf = torch.where(new_c, C_PT, cf).to(torch.int32)
        low = un & (m < 1.0)
        cf = torch.where(low & (cf == 0), F_PT, cf).to(torch.int32)
        is_c = cf == C_PT
        has_c_dep = (strong & h.gather(is_c, False)).any(0).reshape(ns, nl)
        make_f = un & ~new_c & ~low & has_c_dep
        cf = torch.where(make_f & (cf == 0), F_PT, cf).to(torch.int32)
        m = torch.where(un & (cf != 0), 0.0, m)
        rounds += 1
        if not bool((cf == 0).any()):
            break
    if stats is not None:
        stats["pmis_rounds"] = rounds
    return cf


def coarse_partition(cf: torch.Tensor, row_part):
    """Per-shard C counts -> GenPartition, and each C point's global
    coarse id: shard-major numbering, which is global ascending, so the
    single-device cumsum numbering (par_setup.py:393)."""
    is_c = cf == C_PT
    counts = is_c.sum(1).cpu().numpy()
    cpart = GenPartition.create(counts)
    coff = torch.as_tensor(np.asarray(cpart.starts[:-1]), device=cf.device)
    rank = torch.cumsum(is_c.to(torch.int32), 1) - 1
    cmap = torch.where(is_c, coff[:, None] + rank, -1).to(torch.int32)
    return cpart, cmap


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def _truncate_view(pc, pv, trunc_factor, max_elmts, length=None):
    P = dev.DEll(cols=pc, vals=pv, n_cols=0)
    if trunc_factor > 0.0 or (0 < max_elmts < (length or pc.shape[0])):
        P = dev.device_truncate(P, trunc_factor, max_elmts, length=length)
    elif length is not None:
        P = dev._pad_slots(P, length)
    return P.cols, P.vals


def par_direct_interp(M: ParDEll, h: Halo, strong, cf, cmap, cpart,
                      trunc_factor=0.0, max_elmts=4) -> ParDEll:
    """Distributed direct interpolation (par_interp.c:1948; par_setup.py:
    440): the single-device row formulas, the halo of (is_c, cmap) the
    only communication."""
    ns, nl = M.n_shards, M.n_local
    cols, vals = M.view()
    w = cols.shape[0]
    gid = gids_stacked(M.row_part, M.device).reshape(-1)
    is_c = cf == C_PT
    is_diag = (cols >= 0) & (cols == gid[None, :])
    diag = torch.where(is_diag, vals, 0.0).sum(0)
    offd = (cols >= 0) & ~is_diag
    strong_c = strong & h.gather(is_c, False)
    pos, neg = vals > 0, vals < 0
    sum_n_neg = sum0(torch.where(offd & neg, vals, 0.0))
    sum_n_pos = sum0(torch.where(offd & pos, vals, 0.0))
    sum_p_neg = sum0(torch.where(strong_c & neg, vals, 0.0))
    sum_p_pos = sum0(torch.where(strong_c & pos, vals, 0.0))
    alfa = torch.where(sum_p_neg != 0, sum_n_neg / torch.where(
        sum_p_neg != 0, sum_p_neg * diag, 1.0), 1.0)
    beta = torch.where(sum_p_pos != 0, sum_n_pos / torch.where(
        sum_p_pos != 0, sum_p_pos * diag, 1.0), 1.0)
    cfv = cf.reshape(-1)
    row_c = cfv == C_PT
    f_row = ~row_c & (cfv != SF_PT)
    sel = strong_c & f_row[None, :]
    pv = torch.where(vals < 0, -alfa[None, :] * vals, -beta[None, :] * vals)
    pc = torch.where(sel, h.gather(cmap, -1), -1)
    pv = torch.where(sel, pv, 0.0)
    slot0 = (torch.arange(w, device=cols.device) == 0)[:, None]
    cmr = cmap.reshape(-1)
    pc = torch.where(row_c[None, :], torch.where(slot0, cmr[None, :], -1), pc)
    pv = torch.where(row_c[None, :], torch.where(slot0, 1.0, 0.0), pv)
    pc, pv = _truncate_view(pc.to(torch.int32), pv, trunc_factor, max_elmts)
    return ParDEll(cols=_unview(pc, ns, nl), vals=_unview(pv, ns, nl),
                   row_part=M.row_part, col_part=cpart,
                   communicator=M.communicator)


def par_extpi_interp(M: ParDEll, h: Halo, strong, cf, cmap, cpart,
                     trunc_factor=0.0, max_elmts=4) -> ParDEll:
    """Distributed ext+i interpolation (par_lr_interp.c:1024; par_setup.
    py:500).  The ghost ROWS of A (cols, vals, strong-C flags) arrive by
    exchange_mat (the ExtractBExt step); then every row runs the
    single-device formulas (device_amg._extpi_body) on its neighbours'
    rows.  P's columns come out as global FINE ids of C points; a
    second, distance-2 halo of cmap renumbers them to coarse ids."""
    ns, nl = M.n_shards, M.n_local
    cols, vals = M.view()
    w, n = cols.shape
    gid = gids_stacked(M.row_part, M.device).reshape(-1)
    is_c = cf == C_PT
    is_diag = (cols >= 0) & (cols == gid[None, :])
    diag = torch.where(is_diag, vals, 0.0).sum(0)
    strong_c_all = strong & h.gather(is_c, False)
    cf_nb = h.gather(cf, 0)
    wl = int((M.cols >= 0).any(2).any(0).nonzero().max()) + 1 \
        if M.nnz() else 1
    # the neighbour-row tables: own rows and ghost rows, (F, ns (nl+ng))
    sca = _unview(strong_c_all, ns, nl)[:, :wl]
    rows_c = h.table(M.cols[:, :wl].permute(0, 2, 1)).t().contiguous()
    rows_v = h.table(M.vals[:, :wl].permute(0, 2, 1)).t().contiguous()
    rows_s = h.table(sca.permute(0, 2, 1)).t().contiguous()
    sign = h.table(torch.sign(diag).reshape(ns, nl))
    slot = torch.arange(w, dtype=torch.int32, device=M.device)[:, None]
    cfv = cf.reshape(-1)
    pcs, pvs = [], []
    # row chunks bound the (w, w, rows) temporaries, as on one device
    for c0, c1 in dev._chunks(n, dev._extpi_row_bytes(w)):
        cc, vv, st = cols[:, c0:c1], vals[:, c0:c1], strong[:, c0:c1]
        sf = st & (cf_nb[:, c0:c1] == F_PT)
        ks, = dev._compact_valid(torch.where(sf, slot, _BIG))
        has_k = ks < _BIG
        ks_safe = torch.where(has_k, ks, 0).to(torch.int64)
        k_flat = torch.where(has_k, torch.gather(h.flat[:, c0:c1], 0,
                                                 ks_safe), -1)
        nb_cols = btake_rows(k_flat, rows_c, -1)
        pc, pv = dev._extpi_body(
            cc, vv, st, cfv[c0:c1], diag[c0:c1], gid[c0:c1],
            cf_nb[:, c0:c1], ks,
            torch.where(has_k, torch.gather(cc, 0, ks_safe), -1),
            torch.where(has_k, torch.gather(vv, 0, ks_safe), 0.0),
            btake(k_flat, sign, 0), nb_cols,
            btake_rows(k_flat, rows_s, False) & (nb_cols >= 0),
            btake_rows(k_flat, rows_v, 0),
            trunc_factor=trunc_factor, max_elmts=max_elmts)
        pcs.append(pc)
        pvs.append(pv)
        del nb_cols
    pc = torch.cat(pcs, 1) if len(pcs) > 1 else pcs[0]
    pv = torch.cat(pvs, 1) if len(pvs) > 1 else pvs[0]
    Pf = ParDEll(cols=_unview(pc, ns, nl), vals=_unview(pv, ns, nl),
                 row_part=M.row_part, col_part=M.row_part,
                 communicator=M.communicator)
    hp = level_halo(Pf, M.communicator)
    pc2 = hp.gather(cmap, -1)
    return ParDEll(cols=_unview(pc2, ns, nl), vals=Pf.vals,
                   row_part=M.row_part, col_part=cpart,
                   communicator=M.communicator)


# ---------------------------------------------------------------------------
# transpose + SpGEMM
# ---------------------------------------------------------------------------

def par_transpose(M: ParDEll) -> ParDEll:
    """R = M^T distributed (par_csr_triplemat.c; par_setup.py:698): each
    shard transposes its entries onto own and ghost output rows by one
    stable sort (csr2csc), the ghost rows travel back to their owners by
    the reverse row exchange, and each output row's candidates are
    sorted by column.  Values pass through bitwise."""
    comm = M.communicator
    h = level_halo(M, comm)
    ce, cp = h.cols_ext, h.cp
    ns, w, nl = ce.shape
    nlo, ng = M.col_part.n_local, cp.n_ghost
    wo = nlo + ng
    gid = gids_stacked(M.row_part, M.device)
    # entries in row-major order per shard
    colsR = ce.permute(0, 2, 1).reshape(ns, -1).to(torch.int64)
    valsR = M.vals.permute(0, 2, 1).reshape(ns, -1)
    rowsR = gid[:, :, None].expand(ns, nl, w).reshape(ns, -1)
    key = torch.where(colsR >= 0, colsR, _BIG)
    skey, order = torch.sort(key, dim=1, stable=True)
    srow = torch.gather(rowsR, 1, order)
    sval = torch.gather(valsR, 1, order)
    ok = skey < _BIG
    idx = torch.arange(skey.shape[1], device=M.device)[None, :]
    newrow = ok.clone()
    newrow[:, 1:] &= skey[:, 1:] != skey[:, :-1]
    start = torch.cummax(torch.where(newrow, idx, 0), 1).values
    pos = idx - start
    wt = max(int(pos[ok].max()) + 1 if bool(ok.any()) else 1, 1)
    flat = torch.where(ok, (torch.arange(ns, device=M.device)[:, None]
                            * wt + pos) * wo + skey, ns * wt * wo)
    tc = torch.full((ns * wt * wo + 1,), -1, dtype=torch.int64,
                    device=M.device)
    tv = torch.zeros(ns * wt * wo + 1, dtype=M.vals.dtype, device=M.device)
    tc[flat.reshape(-1)] = srow.reshape(-1).to(torch.int64)
    tv[flat.reshape(-1)] = sval.reshape(-1)
    tc = tc[:-1].reshape(ns, wt, wo)
    tv = tv[:-1].reshape(ns, wt, wo)
    # ghost output rows -> owners, ids +1 so that a zero pad decodes -1
    back_c = comm.exchange_rev_rows(
        (tc[:, :, nlo:] + 1).permute(0, 2, 1).contiguous(), cp, nlo) - 1
    back_v = comm.exchange_rev_rows(
        tv[:, :, nlo:].permute(0, 2, 1).contiguous(), cp, nlo)
    R = back_c.shape[2]
    cand_c = torch.cat([tc[:, :, :nlo],
                        back_c.reshape(ns, nlo, R * wt).permute(0, 2, 1)], 1)
    cand_v = torch.cat([tv[:, :, :nlo],
                        back_v.reshape(ns, nlo, R * wt).permute(0, 2, 1)], 1)
    key = torch.where(cand_c >= 0, cand_c, _BIG)
    oc, order = torch.sort(key, dim=1, stable=True)
    ov = torch.gather(cand_v, 1, order)
    used = max(int((oc < _BIG).sum(1).max()), 1)
    oc = torch.where(oc < _BIG, oc, -1)[:, :used].to(torch.int32)
    return ParDEll(cols=oc.contiguous(), vals=ov[:, :used].contiguous(),
                   row_part=M.col_part, col_part=M.row_part,
                   communicator=comm)


def par_spgemm(X: ParDEll, Y: ParDEll) -> ParDEll:
    """C = X Y distributed (csr_spgemm_device.c:15; par_setup.py:770):
    Y's ghost rows arrive by exchange_mat (ExtractBExt), each X row
    expands over its Y rows in the single-device order (Y slot, X slot),
    and device_amg._slot_compact sums and compacts every row at once."""
    ns, nl = X.n_shards, X.n_local
    h = level_halo(X, X.communicator)
    xc, xv = X.view()
    rows_c = h.table(Y.cols.permute(0, 2, 1)).t().contiguous()
    rows_v = h.table(Y.vals.permute(0, 2, 1)).t().contiguous()
    bc = btake_rows(h.flat, rows_c, -1)                  # (wy, wx, n)
    bv = btake_rows(h.flat, rows_v, 0) * xv[None]
    n = ns * nl
    cc, cv = dev._slot_compact(bc.reshape(-1, n), bv.reshape(-1, n))
    wout = max(int((cc >= 0).sum(0).max()) if n else 1, 1)
    return ParDEll(cols=_unview(cc[:wout], ns, nl),
                   vals=_unview(cv[:wout], ns, nl), row_part=X.row_part,
                   col_part=Y.col_part, communicator=X.communicator)


# ---------------------------------------------------------------------------
# level driver
# ---------------------------------------------------------------------------

def iter_par_hierarchy(A: ParDEll, cfg, communicator=None,
                       stats: list | None = None):
    """Distributed level loop (the sharded twin of iter_device_hierarchy,
    par_setup.py:814).  Yields (A_l, P_l, R_l, cf_l) per level, then the
    coarsest A.  No global level is formed."""
    communicator = communicator or A.communicator
    _check_stacked(communicator)
    Al = A
    for level in range(cfg.max_levels - 1):
        n = Al.row_part.n_global
        if n <= cfg.max_coarse_size:
            break
        st = {"level": level, "n": n}
        h = level_halo(Al, communicator)
        strong = par_strength(Al, cfg.strong_threshold, cfg.max_row_sum)
        cf = par_pmis(Al, h, strong, seed=cfg.seed, stats=st)
        n_coarse = int((cf == C_PT).sum())
        st["n_coarse"] = n_coarse
        if stats is not None:
            stats.append(st)
        if n_coarse == 0 or n_coarse == n:
            break
        cpart, cmap = coarse_partition(cf, Al.row_part)
        interp = par_direct_interp if cfg.interp_type == 3 \
            else par_extpi_interp
        Pl = interp(Al, h, strong, cf, cmap, cpart,
                    trunc_factor=cfg.trunc_factor,
                    max_elmts=cfg.p_max_elmts)
        del strong
        Rl = par_transpose(Pl)
        AP = par_spgemm(Al, Pl)
        Ac = par_spgemm(Rl, AP)
        yield (Al, Pl, Rl, cf)
        Al = pad_width(Ac)
    yield Al


def dense_coarse(Ac: ParDEll) -> np.ndarray:
    """The coarsest operator as a dense matrix in the shard-major padded
    order, identity on the padding slots (par_amg.py:290-305): slot
    p n_local + i holds global row starts[p] + i for i < count_p."""
    part = Ac.row_part
    nl, ns = part.n_local, part.n_shards
    st, cnt = true_starts(part), true_counts(part)
    gid_of_slot = np.full(part.n_padded, -1, np.int64)
    for p in range(ns):
        gid_of_slot[p * nl:p * nl + cnt[p]] = st[p] + np.arange(cnt[p])
    dense = np.eye(part.n_padded)
    vs = np.flatnonzero(gid_of_slot >= 0)
    dense[np.ix_(vs, vs)] = pardell_to_scipy(Ac).toarray()[
        np.ix_(gid_of_slot[vs], gid_of_slot[vs])]
    return dense
