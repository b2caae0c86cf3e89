"""The plain reference that decides `correct`.

Plain PyTorch and NumPy only: it imports nothing of the program.  From
the configuration's stencil it builds its own AMG hierarchy, level by
level on its own operators, and its own cycle:

* the fine operator, applied by shifted slices of the grid;
* the strength of connection and the PMIS C/F split of every level
  (hypre's PMIS, with the 32-bit murmur3 `fmix32` hash of the row id
  and the configuration's seed as the random part of the measure);
* the extended+i interpolation of every row, truncated to
  `p_max_elmts` entries of largest magnitude and rescaled to keep the
  row sum (hypre_BoomerAMGBuildExtPIInterp,
  hypre_BoomerAMGInterpTruncation);
* the Galerkin operators P^T A P, by expanding every product and
  summing by (row, column);
* the smoothers (l1-Jacobi; Chebyshev of order 2 on D^-1/2 A D^-1/2
  with the spectral bounds from a power iteration started from JAX's
  Threefry uniform draw) and one V-cycle with a direct coarsest solve.

It reads the program while it builds only to break ties, which two
sums of the same numbers in another order may put either way, and
where a different choice is as right but makes another hierarchy: a
strength test within 1e-12 of its threshold is decided as on the
program's A of that level (`adopt_ties`), and a truncated row keeps the
program's set where that is a largest-magnitude choice up to
magnitudes within 1e-12 of each other (`_truncate`).  The comparison
then holds every row of the program's P and A against the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

C_PT, F_PT, SF_PT = 1, -1, -3
_M32 = 0xFFFFFFFF
_BIG = torch.iinfo(torch.int64).max
MISMATCH = 1e300         # the gap of a level or row the reference lacks


# ---------------------------------------------------------------- stencil

def stencil_apply(grid, entries, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the constant stencil on an (nx, ny, nz) grid,
    x-fastest, truncated at the boundary (Dirichlet)."""
    nx, ny, nz = grid
    u = x.reshape(nz, ny, nx)
    y = torch.zeros_like(u)
    for (dx, dy, dz), v in entries:
        ys = [slice(None)] * 3
        us = [slice(None)] * 3
        for ax, d, n in ((2, dx, nx), (1, dy, ny), (0, dz, nz)):
            if d > 0:
                ys[ax], us[ax] = slice(0, n - d), slice(d, n)
            elif d < 0:
                ys[ax], us[ax] = slice(-d, n), slice(0, n + d)
        y[tuple(ys)] += v * u[tuple(us)]
    return y.reshape(-1)


def stencil_ell(grid, entries, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The stencil as a padded neighbour table: cols int64 (k, n), -1
    outside the grid, and vals (k, n) float64, one slot per entry."""
    nx, ny, nz = grid
    n = nx * ny * nz
    i = torch.arange(n, device=device)
    x, y, z = i % nx, (i // nx) % ny, i // (nx * ny)
    cols = torch.empty((len(entries), n), dtype=torch.int64, device=device)
    vals = torch.empty((len(entries), n), dtype=torch.float64, device=device)
    for k, ((dx, dy, dz), v) in enumerate(entries):
        ok = ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
              & (z + dz >= 0) & (z + dz < nz))
        cols[k] = torch.where(ok, i + dx + nx * (dy + ny * dz), -1)
        vals[k] = torch.where(ok, float(v), 0.0)
    return cols, vals


def csr_ell(indptr, indices, values, device):
    """A CSR matrix (any device) as a padded neighbour table on
    `device`: cols int64 (w, n) with -1 padding, vals float64."""
    indptr = indptr.to(device, torch.int64)
    n = indptr.numel() - 1
    counts = indptr[1:] - indptr[:-1]
    w = max(int(counts.max()) if n else 1, 1)
    rows = torch.repeat_interleave(torch.arange(n, device=device), counts)
    slot = torch.arange(rows.numel(), device=device) - indptr[rows]
    cols = torch.full((w, n), -1, dtype=torch.int64, device=device)
    vals = torch.zeros((w, n), dtype=torch.float64, device=device)
    cols[slot, rows] = indices.to(device, torch.int64)
    vals[slot, rows] = values.to(device, torch.float64)
    return cols, vals


# --------------------------------------------------------------- strength

def strength(cols: torch.Tensor, vals: torch.Tensor, theta: float,
             max_row_sum: float, rel: float = 1e-12):
    """Strong mask (w, n): hypre_BoomerAMGCreateS.  For a row with a
    negative diagonal, a_ij is strong if a_ij > theta * max_offd; with a
    positive one, if a_ij < theta * min_offd; no entry of a row whose
    |row sum| exceeds max_row_sum |a_ii| is strong.  Also the mask of
    the entries whose test ties within `rel` of its threshold, which
    two roundings of the same operator may decide either way."""
    n = cols.shape[1]
    valid = cols >= 0
    is_diag = cols == torch.arange(n, device=cols.device)[None, :]
    diag = torch.where(is_diag, vals, 0.0).sum(0)
    offd = valid & ~is_diag
    big = torch.finfo(vals.dtype).max
    scale = torch.where(diag < 0, torch.where(offd, vals, -big).amax(0),
                        torch.where(offd, vals, big).amin(0))
    thr = theta * scale[None, :]
    strong = torch.where((diag < 0)[None, :], vals > thr, vals < thr)
    tie = (vals - thr).abs() <= rel * thr.abs()
    if max_row_sum < 1.0:
        rsum = torch.where(valid, vals, 0.0).sum(0)
        lim = diag.abs() * max_row_sum
        strong &= ~(rsum.abs() > lim)[None, :]
        tie |= ((rsum.abs() - lim).abs() <= rel * lim)[None, :]
    return strong & offd, tie & offd


def adopt_ties(strong, tie, cols, prog: Csr, theta, max_row_sum):
    """`strong` with each tied entry decided as the program's operator
    `prog` (the same level, as the comparison checks) decides it."""
    n = cols.shape[1]
    if prog is None or prog.n_rows != n or not bool(tie.any()):
        return strong
    pc, pv = csr_ell(prog.indptr, prog.indices, prog.values, cols.device)
    ps, _ = strength(pc, pv, theta, max_row_sum)
    rows = torch.arange(n, device=cols.device)[None].expand_as(pc)
    keys = torch.sort((rows * n + pc)[ps]).values
    q = (torch.arange(n, device=cols.device)[None].expand_as(cols) * n
         + cols)[tie]
    pos = torch.searchsorted(keys, q).clamp_(max=max(keys.numel() - 1, 0))
    hit = (keys[pos] == q) if keys.numel() else torch.zeros_like(q, dtype=torch.bool)
    out = strong.clone()
    out[tie] = hit
    return out


# ------------------------------------------------------------------- PMIS

def fmix32_measure(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """The random part of the PMIS measure: murmur3's fmix32 of
    (id + seed) mod 2^32, its top 24 bits as a float32 in [0, 1)."""
    h = (ids.to(torch.int64) + (seed & _M32)) & _M32
    for shift, mult in ((16, 0x85EBCA6B), (13, 0xC2B2AE35)):
        h ^= h >> shift
        # (h * mult) mod 2^32 without overflowing int64
        h = ((h * (mult & 0xFFFF)) + (((h * (mult >> 16)) & 0xFFFF) << 16)) \
            & _M32
    h ^= h >> 16
    return (h >> 8).to(torch.float32) / float(1 << 24)


def pmis(cols: torch.Tensor, strong: torch.Tensor, seed: int,
         max_rounds: int = 200) -> torch.Tensor:
    """C/F split by PMIS (hypre's par_coarsen.c, PMIS branch): measure =
    number of points that depend strongly on i (float32) + the hash; a
    point with no strong connection of its own is SF.  Each round, an
    undecided point of measure > 1 becomes C unless a strongly
    connected candidate (either direction) beats it on (measure, id);
    undecided points of measure < 1 become F, and so do undecided
    points that depend strongly on a C point.  int8 (n,)."""
    n = cols.shape[1]
    dev = cols.device
    tgt = cols[strong]
    deg = torch.bincount(tgt, minlength=n).to(torch.float32)
    gid = torch.arange(n, device=dev)
    isolated = ~strong.any(0)
    m = torch.where(isolated, 0.0, deg + fmix32_measure(gid, seed))
    cf = torch.where(isolated, SF_PT, 0).to(torch.int8)
    safe = cols.clamp(min=0)
    for _ in range(max_rounds):
        un = cf == 0
        if not bool(un.any()):
            return cf
        cand = un & (m > 1.0)
        m_nb, c_nb = m[safe], cand[safe] & strong
        edge = c_nb & cand[None, :]
        nb_wins = (m_nb > m[None, :]) | ((m_nb == m[None, :]) & (safe > gid))
        out = (edge & nb_wins).any(0)
        me_wins = (m[None, :] > m_nb) | ((m[None, :] == m_nb) & (gid > safe))
        out[safe[edge & me_wins]] = True
        new_c = cand & ~out
        cf[new_c] = C_PT
        low = un & (m < 1.0) & (cf == 0)
        cf[low] = F_PT
        dep_c = (strong & (cf[safe] == C_PT)).any(0)
        cf[un & ~new_c & ~low & dep_c & (cf == 0)] = F_PT
    raise RuntimeError(f"reference PMIS did not finish in {max_rounds} rounds")


# --------------------------------------------------------- sparse helpers

class Csr(NamedTuple):
    """A sparse matrix: indptr int64 (n + 1), indices int64, values
    float64 (columns ascending within a row), and its number of
    columns."""
    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.indptr.numel() - 1

    def rows(self) -> torch.Tensor:
        return torch.repeat_interleave(
            torch.arange(self.n_rows, device=self.indptr.device),
            self.indptr[1:] - self.indptr[:-1])

    def sparse(self) -> torch.Tensor:
        """As a torch sparse CSR matrix (for products with vectors)."""
        return torch.sparse_csr_tensor(self.indptr, self.indices,
                                       self.values,
                                       size=(self.n_rows, self.n_cols))


def csr_from_coo(rows, cols, vals, n_rows: int, n_cols: int) -> Csr:
    """Sum duplicate (row, col) entries; rows and columns ascending."""
    key = rows * n_cols + cols
    key, order = torch.sort(key)
    uk, inv = torch.unique_consecutive(key, return_inverse=True)
    out = torch.zeros(uk.numel(), dtype=torch.float64, device=vals.device)
    out.index_add_(0, inv, vals[order].to(torch.float64))
    r = uk // n_cols
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=vals.device)
    indptr[1:] = torch.cumsum(torch.bincount(r, minlength=n_rows), 0)
    return Csr(indptr, uk % n_cols, out, n_cols)


def csr_from_ell(cols, vals) -> Csr:
    w, n = cols.shape
    ok = (cols >= 0).t()
    rows = torch.arange(n, device=cols.device)[:, None].expand(n, w)
    return csr_from_coo(rows[ok], cols.t()[ok], vals.t()[ok], n, n)


def transpose(M: Csr) -> Csr:
    return csr_from_coo(M.indices, M.rows(), M.values, M.n_cols, M.n_rows)


def spgemm(A: Csr, B: Csr, budget: int = 1 << 26) -> Csr:
    """A @ B: every product a_ik b_kj expanded and summed by (i, j), in
    blocks of A's rows of about `budget` products each."""
    dev = A.values.device
    b_len = B.indptr[1:] - B.indptr[:-1]
    per_nz = b_len[A.indices]
    cum = torch.zeros(A.values.numel() + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(per_nz, 0)
    row_cum = cum[A.indptr].cpu()             # products before each row
    parts = []
    r0 = 0
    n = A.n_rows
    while r0 < n:
        r1 = int(torch.searchsorted(row_cum, row_cum[r0] + budget,
                                    right=True)) - 1
        r1 = min(max(r1, r0 + 1), n)
        e0, e1 = int(A.indptr[r0]), int(A.indptr[r1])
        cnt = per_nz[e0:e1]
        tot = int(cnt.sum())
        src = torch.repeat_interleave(torch.arange(e0, e1, device=dev), cnt)
        pos = B.indptr[A.indices[src]] + torch.arange(tot, device=dev) \
            - (cum[src] - cum[e0])
        rows = torch.searchsorted(A.indptr, src, right=True) - 1
        parts.append(csr_from_coo(rows - r0, B.indices[pos],
                                  A.values[src] * B.values[pos],
                                  r1 - r0, B.n_cols))
        r0 = r1
    indptr = [parts[0].indptr]
    for p in parts[1:]:
        indptr.append(p.indptr[1:] + indptr[-1][-1])
    return Csr(torch.cat(indptr), torch.cat([p.indices for p in parts]),
               torch.cat([p.values for p in parts]), B.n_cols)


def galerkin(A: Csr, P: Csr) -> Csr:
    """P^T A P."""
    return spgemm(transpose(P), spgemm(A, P))


def row_gap(got: Csr, want: Csr) -> float:
    """The largest row gap between two matrices of one shape: a row's
    largest |got - want| over its largest |want| (a row that `want`
    leaves empty gaps by 1e300 unless `got` is empty there too)."""
    if got.n_rows != want.n_rows or got.n_cols != want.n_cols:
        return MISMATCH
    dev = want.values.device
    n, m = want.n_rows, want.n_cols
    d = csr_from_coo(torch.cat([got.rows().to(dev), want.rows()]),
                     torch.cat([got.indices.to(dev), want.indices]),
                     torch.cat([got.values.to(dev, torch.float64),
                                -want.values]), n, m)
    diff = torch.zeros(n, dtype=torch.float64, device=dev)
    diff.scatter_reduce_(0, d.rows(), d.values.abs(), "amax")
    scale = torch.zeros(n, dtype=torch.float64, device=dev)
    scale.scatter_reduce_(0, want.rows(), want.values.abs(), "amax")
    gap = torch.where(scale > 0, diff / torch.where(scale > 0, scale, 1.0),
                      (diff > 0).to(torch.float64) * MISMATCH)
    g = float(gap.max()) if n else 0.0
    return g if g == g else MISMATCH


# ---------------------------------------------------------- interpolation

def _member(sorted_rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """q (k, m): whether q[:, i] lies in row i of sorted_rows (m, L),
    each row ascending; _BIG is never a member."""
    qt = q.t().contiguous()
    pos = torch.searchsorted(sorted_rows, qt).clamp_(
        max=sorted_rows.shape[1] - 1)
    return ((sorted_rows.gather(1, pos) == qt) & (qt < _BIG)).t()


def _extpi_rows(cols, vals, strong, cf, c0: int, c1: int):
    """Rows c0..c1 of the extended+i interpolation before truncation
    (hypre_BoomerAMGBuildExtPIInterp), over a level's neighbour table:
    (fine columns ascending, _BIG past a row's entries; values), each
    (L, m).  Only F rows hold entries here.

    The coarse set Ĉ of F row i is its strong C neighbours and theirs
    of its strong F neighbours.  An entry of row i to a point of Ĉ is
    kept; a weak one (neither in Ĉ nor strong F nor SF) is lumped on
    the diagonal; a strong F neighbour k is distributed over row k's
    entries of the sign opposite to a_kk that lie in Ĉ or are i (to
    the diagonal where none does).  Each row is divided by minus its
    diagonal sum."""
    w = cols.shape[0]
    m = c1 - c0
    dev = cols.device
    cc, vv, st = cols[:, c0:c1], vals[:, c0:c1], strong[:, c0:c1]
    gid = torch.arange(c0, c1, device=dev)
    valid = cc >= 0
    safe = cc.clamp(min=0)
    cfn = torch.where(valid, cf[safe], 0)
    isd = valid & (cc == gid)
    sf = st & (cfn == F_PT)
    sc = st & (cfn == C_PT)
    # row k of every strong F neighbour: [t, s, i] = slot t of row cc[s, i]
    kc = cols[:, safe]
    kv = vals[:, safe]
    kval = (kc >= 0) & sf[None]
    kc_safe = kc.clamp(min=0)
    k_sc = kval & strong[:, safe] & (cf[kc_safe] == C_PT)
    chat = torch.cat([torch.where(sc, cc, _BIG),
                      torch.where(k_sc, kc, _BIG).reshape(w * w, m)])
    chat = torch.sort(chat.t().contiguous(), dim=1).values
    del k_sc
    in_chat = _member(chat, torch.where(valid & ~isd, cc, _BIG))
    lump = valid & ~isd & ~in_chat & ~sf & (cfn != SF_PT)
    d = torch.where(isd | lump, vv, 0.0).sum(0)
    own = kc == safe[None]
    sign_k = torch.sign(torch.where(kval & own, kv, 0.0).sum(0))
    to_i = kc == gid
    in_k = _member(chat, torch.where(kval, kc, _BIG).reshape(w * w, m)) \
        .reshape(w, w, m)
    use = kval & ~own & (sign_k[None] * kv < 0) & (in_k | to_i)
    del in_k, own, chat
    den = torch.where(use, kv, 0.0).sum(0)
    has = sf & (den != 0)
    d = d + torch.where(sf & ~has, vv, 0.0).sum(0)
    dist = torch.where(has, vv / torch.where(has, den, 1.0), 0.0)
    contrib = torch.where(use, dist[None] * kv, 0.0)
    d = d + torch.where(to_i, contrib, 0.0).sum((0, 1))
    to_c = use & ~to_i
    ncol = torch.cat([torch.where(in_chat, cc, _BIG),
                      torch.where(to_c, kc, _BIG).reshape(w * w, m)])
    nval = torch.cat([torch.where(in_chat, vv, 0.0),
                      torch.where(to_c, contrib, 0.0).reshape(w * w, m)])
    del kc, kv, contrib, to_c, use, to_i
    is_f = (cf[c0:c1] == F_PT)[None]
    ncol = torch.where(is_f, ncol, _BIG)
    sc_, order = torch.sort(ncol, dim=0)
    sv = nval.gather(0, order)
    new = torch.ones_like(sc_, dtype=torch.bool)
    new[1:] = sc_[1:] != sc_[:-1]
    g = torch.cumsum(new.to(torch.int64), 0) - 1
    ucol = torch.full_like(sc_, _BIG).scatter_(0, g, sc_)
    uval = torch.zeros_like(sv).scatter_add_(0, g, sv)
    k = max(int((ucol < _BIG).sum(0).max()) if m else 0, 1)
    ucol, uval = ucol[:k], uval[:k]
    scale = torch.where(d != 0, -d, 1.0)
    return ucol, torch.where(ucol < _BIG, uval / scale[None], 0.0)


def _truncate(ucol, q, cmap, a, prog_rows):
    """The kept entries of each row: those above trunc_factor times the
    row's largest, then its p_max_elmts of largest magnitude (ties to
    the lower column), the rest of the row's sum spread over them.
    Where the program's row keeps another set, that set is taken if it
    is a largest-magnitude choice up to magnitudes within 1e-12 of each
    other (prog_rows: the program's coarse columns of these rows,
    (m, k) ascending, _BIG past the end).  Returns (keep, q)."""
    L, m = q.shape
    valid = ucol < _BIG
    mag = torch.where(valid, q.abs(), 0.0)
    pre = valid
    if a["trunc_factor"] > 0.0:
        pre = pre & (mag >= a["trunc_factor"] * mag.amax(0)[None])
    pmax = a["p_max_elmts"]
    if 0 < pmax < L:
        key = torch.where(pre, -mag, float("inf"))
        _, order = torch.sort(key, dim=0, stable=True)
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(L, device=q.device)[:, None].expand(L, m)
            .contiguous())
        keep = pre & (rank < pmax)
    else:
        keep = pre
    if prog_rows is not None:
        coarse = torch.where(valid, cmap[ucol.clamp(max=cmap.numel() - 1)],
                             _BIG)
        in_prog = _member(prog_rows, coarse) & valid
        n_prog = (prog_rows < _BIG).sum(1)
        lo = torch.where(in_prog, mag, float("inf")).amin(0)
        hi = torch.where(pre & ~in_prog, mag, 0.0).amax(0)
        ok = ((n_prog == keep.sum(0)) & (in_prog.sum(0) == n_prog)
              & ((in_prog & ~pre).sum(0) == 0) & (lo >= hi * (1 - 1e-12)))
        keep = torch.where(ok[None], in_prog, keep)
    cut = (valid & ~keep).any(0)
    total = torch.where(valid, q, 0.0).sum(0)
    kept = torch.where(keep, q, 0.0).sum(0)
    s = torch.where(cut & (kept != 0), total / torch.where(
        kept != 0, kept, 1.0), 1.0)
    return keep, q * s[None]


def _ell_rows(M: Csr, r0: int, r1: int) -> torch.Tensor:
    """Columns of rows r0..r1 of M as (m, k), ascending, _BIG padded."""
    dev = M.indptr.device
    ptr = M.indptr[r0:r1 + 1]
    cnt = ptr[1:] - ptr[:-1]
    k = max(int(cnt.max()) if r1 > r0 else 1, 1)
    out = torch.full((r1 - r0, k), _BIG, dtype=torch.int64, device=dev)
    rows = torch.repeat_interleave(torch.arange(r1 - r0, device=dev), cnt)
    slot = torch.arange(rows.numel(), device=dev) - (ptr[rows] - ptr[0])
    out[rows, slot] = M.indices[int(ptr[0]):int(ptr[-1])].to(dev,
                                                              torch.int64)
    return out


def extpi(cols, vals, strong, cf, a, prog_P: Csr | None = None,
          budget: int = 1 << 31) -> Csr:
    """The level's interpolation P (n, n_C): ext+i rows truncated,
    identity rows at C points, empty rows at SF points; in blocks of
    rows of about `budget` bytes of work arrays."""
    w, n = cols.shape
    dev = cols.device
    is_c = cf == C_PT
    cmap = torch.cumsum(is_c.to(torch.int64), 0) - 1
    n_c = int(is_c.sum())
    step = max(1, budget // (160 * w * w + 64))
    rs, cs, vs = [], [], []
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        ucol, q = _extpi_rows(cols, vals, strong, cf, c0, c1)
        prog = (None if prog_P is None or prog_P.n_rows != n
                else _ell_rows(prog_P, c0, c1))
        keep, q = _truncate(ucol, q, cmap, a, prog)
        rows = torch.arange(c0, c1, device=dev)[None].expand_as(ucol)
        rs.append(rows[keep])
        cs.append(cmap[ucol[keep]])
        vs.append(q[keep])
    ci = torch.nonzero(is_c).flatten()
    rs.append(ci)
    cs.append(cmap[ci])
    vs.append(torch.ones(ci.numel(), dtype=torch.float64, device=dev))
    return csr_from_coo(torch.cat(rs), torch.cat(cs), torch.cat(vs), n, n_c)


# -------------------------------------------------------------- hierarchy

class RefLevel(NamedTuple):
    A: Csr
    cols: torch.Tensor      # A as a neighbour table (w, n)
    vals: torch.Tensor
    cf: torch.Tensor
    P: Csr


def hierarchy(grid, entries, a, device, prog_P=None, prog_A=None):
    """The reference's own AMG hierarchy from the stencil: per level
    the strength, PMIS split, ext+i P and P^T A P, until a level has
    max_coarse_size rows or fewer, PMIS leaves no C or no F point, or
    max_levels is reached.  prog_P(l) and prog_A(l), if given, are the
    program's P and A of level l (or None), read only to break ties of
    truncation and of strength (`_truncate`, `adopt_ties`).  Returns
    (levels, coarsest A)."""
    cols, vals = stencil_ell(grid, entries, device)
    A = csr_from_ell(cols, vals)
    levels = []
    for l in range(a["max_levels"] - 1):
        n = A.n_rows
        if n <= a["max_coarse_size"]:
            break
        strong, tie = strength(cols, vals, a["strong_threshold"],
                               a["max_row_sum"])
        if prog_A is not None:
            strong = adopt_ties(strong, tie, cols, prog_A(l),
                                a["strong_threshold"], a["max_row_sum"])
        del tie
        cf = pmis(cols, strong, a["seed"])
        n_c = int((cf == C_PT).sum())
        if n_c == 0 or n_c == n:
            break
        P = extpi(cols, vals, strong, cf, a,
                  None if prog_P is None else prog_P(l))
        del strong
        levels.append(RefLevel(A, cols, vals, cf, P))
        A = galerkin(A, P)
        cols, vals = csr_ell(A.indptr, A.indices, A.values, device)
    return levels, A

# ------------------------------------------------------------- smoothers

def l1_dinv(cols, vals) -> torch.Tensor:
    """1 / the l1 row norm, signed as the diagonal (relax 18)."""
    n = cols.shape[1]
    diag = torch.where(cols == torch.arange(n, device=cols.device)[None, :],
                       vals, 0.0).sum(0)
    r = torch.where(cols >= 0, vals.abs(), 0.0).sum(0)
    r = torch.where(diag < 0, -r, r)
    return 1.0 / torch.where(r != 0, r, 1.0)


def diagonal(cols, vals) -> torch.Tensor:
    n = cols.shape[1]
    return torch.where(cols == torch.arange(n, device=cols.device)[None, :],
                       vals, 0.0).sum(0)


def threefry_uniform(seed: int, n: int) -> np.ndarray:
    """jax.random.uniform(PRNGKey(seed), (n,), float64): Threefry-2x32
    (20 rounds) over each element's 64-bit counter split in two words,
    the two output words as the 64 bits, their top 52 under the exponent
    of 1.0, minus 1.0."""
    k0, k1 = np.uint32((seed >> 32) & _M32), np.uint32(seed & _M32)
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    c = np.arange(n, dtype=np.uint64)
    x0 = (c >> np.uint64(32)).astype(np.uint32)
    x1 = (c & np.uint64(_M32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for b in range(5):
            for r in rot[b % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(b + 1) % 3]
            x1 = x1 + ks[(b + 2) % 3] + np.uint32(b + 1)
    bits = (x0.astype(np.uint64) << np.uint64(32)) | x1.astype(np.uint64)
    one = np.array(1.0).view(np.uint64)
    return ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0


class Level:
    """One level of the reference cycle: apply(x) = A x, the smoother's
    data, and P (n, n_c) and R = P^T as torch sparse matrices."""

    def __init__(self, apply, cols, vals, P: Csr, cfg):
        self.apply = apply
        self.P = P.sparse()
        self.R = transpose(P).sparse()
        self.n = cols.shape[1]
        if cfg["relax_type"] == 18:
            self.dinv = l1_dinv(cols, vals)
        elif cfg["relax_type"] == 16:
            self.ds = 1.0 / torch.sqrt(diagonal(cols, vals).abs())
            v = torch.as_tensor(threefry_uniform(7919, self.n),
                                device=cols.device)
            lmax = torch.ones((), dtype=torch.float64, device=cols.device)
            for _ in range(cfg["cheby_eig_iters"]):
                w = self.ds * apply(self.ds * v)
                lmax = torch.linalg.vector_norm(w)
                v = w / torch.clamp_min(lmax, 1e-30)
            self.lmax = float(lmax) * 1.05
            self.lmin = cfg["cheby_fraction"] * self.lmax
        else:
            raise ValueError(f"reference: relax_type {cfg['relax_type']}")


def cycle_levels(levels: list, grid, entries, cfg) -> list:
    """The cycle's levels over the reference's hierarchy; level 0
    applies the stencil itself."""
    out = []
    for l, lv in enumerate(levels):
        if l == 0:
            def apply(x):
                return stencil_apply(grid, entries, x)
        else:
            M = lv.A.sparse()

            def apply(x, M=M):
                return M @ x
        out.append(Level(apply, lv.cols, lv.vals, lv.P, cfg))
    return out


def smooth(lvl: Level, cfg, f, u):
    """One sweep of the level's smoother from u (None: from zero)."""
    if cfg["relax_type"] == 18:
        r = f if u is None else f - lvl.apply(u)
        z = cfg["relax_weight"] * lvl.dinv * r
        return z if u is None else u + z
    ds, lmax, lmin = lvl.ds, lvl.lmax, lvl.lmin
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta

    def op(z):
        return ds * lvl.apply(ds * z)

    fs = ds * f
    us = None if u is None else u / ds
    r = fs if us is None else fs - op(us)
    p = r / theta
    us = p if us is None else us + p
    rho_old = 1.0 / sigma
    for _ in range(1, cfg["cheby_order"]):
        rho = 1.0 / (2.0 * sigma - rho_old)
        r = fs - op(us)
        p = rho * rho_old * p + (2.0 * rho / delta) * r
        us = us + p
        rho_old = rho
    return ds * us


def v_cycle(levels: list, coarse: torch.Tensor, cfg, f: torch.Tensor,
            l: int = 0) -> torch.Tensor:
    """One V-cycle from a zero guess, pre- and post-smoothing, the
    coarsest level solved directly."""
    if l == len(levels):
        return torch.linalg.solve(coarse, f)
    lvl = levels[l]
    u = smooth(lvl, cfg, f, None)
    fc = lvl.R @ (f - lvl.apply(u))
    u = u + lvl.P @ v_cycle(levels, coarse, cfg, fc, l + 1)
    return smooth(lvl, cfg, f, u)
