"""Halo-exchange schedules and the two executors that run them.

Port of hypre_tpu/parallel/comm.py (``CommPkg`` :41, ``build_comm_pkg``
:60, ``exchange`` :123, ``exchange_mat`` :150, ``exchange_rev`` :167),
the analog of hypre's CommPkg/CommHandle (ref: src/parcsr_mv/
par_csr_communication.h:52-78; par_csr_communication.c:358,492-546).

The schedule is the reference's, built on the host from every shard's
ghost list: one round a distinct shard offset; in round r shard q packs
``x[send_idx[q, r]]`` (``send_mask`` marks the real entries) for shard
``p = q - offsets[r]``, which writes them into ghost slots
``recv_idx[p, r]``; padding slots point at the dump slot ``n_ghost``.

The reference runs its solver text inside ``shard_map`` against a mesh
axis (``ppermute``, ``psum``, ``all_gather``, ``axis_index``).  The
port writes it once against a communicator with the same operations,
and gives it two executors:

* ``StackedComm`` — one process holds every shard: each per-shard array
  carries a leading shard axis ``(n_shards, n_local, ...)``, the
  reference's own layout.  An exchange is one index gather over all
  rounds and shards at once and one scatter into the flattened
  ``(n_shards, n_ghost + 1)`` ghost buffer (``p (n_ghost + 1) +
  recv_idx``); the mask is applied when the plan is built, so padding
  entries are never gathered and never reach a slot.  A dot is a sum
  per shard, then a sum over the shard axis: the reference's
  ``psum(vdot)`` order.  The reverse exchange sums duplicates in a
  fixed order (the entries sorted on the host, then a sum over a small
  padded table), so that two runs on the card build the same hierarchy;
  ``index_add_``'s atomics would not.
* ``DistComm`` — ``torch.distributed``, one shard a rank (leading axis
  of length 1): an exchange sends round by round with
  ``batch_isend_irecv`` to ``p - offsets[r]`` and receives from
  ``p + offsets[r]``; dots are an ``all_reduce``, the coarse solve an
  ``all_gather``.

Host-side discovery replaces hypre's rendezvous (assumed partition and
DataExchangeList, ref: src/utilities/ap.c, exchange_data.c:108).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CommPkg:
    """Halo-exchange schedule (host numpy, the reference's arrays).

    send_idx:  int32[n_shards, R, S]  local row index to pack (0 pad)
    send_mask: real [n_shards, R, S]  1.0 valid / 0.0 padding
    recv_idx:  int32[n_shards, R, S]  ghost slot to fill; padding
               slots point at index n_ghost (the dump slot)
    offsets:   tuple[int]             shard delta per round
    n_ghost:   int                    ghost buffer size (max over shards)
    """

    send_idx: np.ndarray
    send_mask: np.ndarray
    recv_idx: np.ndarray
    offsets: tuple
    n_ghost: int
    # device index plans of the executors, built on first use
    plans: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    @property
    def n_shards(self) -> int:
        return int(self.send_idx.shape[0])


def build_comm_pkg(ghost_gids_per_shard, partition,
                   real_dtype=np.float64) -> CommPkg:
    """Host-side CommPkg construction (hypre_MatvecCommPkgCreate analog,
    ref: src/parcsr_mv/par_csr_communication.c:1163; comm.py:60).

    ghost_gids_per_shard: list (len n_shards) of sorted int arrays of
    global row ids each shard needs (its col_map_offd)."""
    n_shards = partition.n_shards
    offset_set = set()
    per_pair = {}
    for p in range(n_shards):
        gids = np.asarray(ghost_gids_per_shard[p], dtype=np.int64)
        if gids.size == 0:
            continue
        owners = partition.owner(gids)
        for q in np.unique(owners):
            sel = owners == q
            per_pair[(p, int(q))] = gids[sel]
            offset_set.add(int(q) - p)
    offsets = tuple(sorted(offset_set))
    R = max(len(offsets), 1)
    max_ghost = max((len(g) for g in ghost_gids_per_shard), default=0)
    max_ghost = max(max_ghost, 1)
    s_max = 1
    for gids in per_pair.values():
        s_max = max(s_max, len(gids))

    send_idx = np.zeros((n_shards, R, s_max), dtype=np.int32)
    send_mask = np.zeros((n_shards, R, s_max), dtype=np.dtype(real_dtype))
    recv_idx = np.full((n_shards, R, s_max), max_ghost, dtype=np.int32)
    for r, off in enumerate(offsets):
        for p in range(n_shards):      # p receives from q = p + off
            q = p + off
            gids = per_pair.get((p, q))
            if gids is None:
                continue
            k = len(gids)
            send_idx[q, r, :k] = partition.local_index(gids)
            send_mask[q, r, :k] = 1.0
            slots = np.searchsorted(
                np.asarray(ghost_gids_per_shard[p]), gids)
            recv_idx[p, r, :k] = slots
    return CommPkg(send_idx=send_idx, send_mask=send_mask,
                   recv_idx=recv_idx, offsets=offsets,
                   n_ghost=int(max_ghost))


def edge_halo_pkg(n_shards: int, tail, head) -> CommPkg:
    """The halo of contiguous row ranges: ghost slots [0, m) take the
    previous shard's entries `tail`, [m, 2m) the next shard's entries
    `head` (local indices, m each); the ends stay zero.  A stencil's
    slab halo (parcsr.py) and a struct level's ±1 planes (par_struct.py)
    are both of this kind."""
    tail, head = np.asarray(tail), np.asarray(head)
    m = len(tail)
    send_idx = np.zeros((n_shards, 2, m), dtype=np.int32)
    send_mask = np.zeros((n_shards, 2, m))
    recv_idx = np.full((n_shards, 2, m), 2 * m, dtype=np.int32)
    # round 0 (offset -1): q sends its tail to p = q + 1
    send_idx[:-1, 0], send_mask[:-1, 0] = tail, 1.0
    recv_idx[1:, 0] = np.arange(m)
    # round 1 (offset +1): q sends its head to p = q - 1
    send_idx[1:, 1], send_mask[1:, 1] = head, 1.0
    recv_idx[:-1, 1] = np.arange(m, 2 * m)
    return CommPkg(send_idx=send_idx, send_mask=send_mask,
                   recv_idx=recv_idx, offsets=(-1, 1), n_ghost=2 * m)


def _pairs(cp: CommPkg):
    """Every real entry of the schedule, round-major: (receiver p,
    round r, sender q, send slot, ghost slot), host numpy."""
    ns, R, S = cp.send_idx.shape
    offs = np.zeros(R, dtype=np.int64)
    offs[:len(cp.offsets)] = cp.offsets
    r = np.broadcast_to(np.arange(R)[None, :, None], (ns, R, S))
    p = np.broadcast_to(np.arange(ns)[:, None, None], (ns, R, S))
    q = p + offs[r]
    ok = (q >= 0) & (q < ns) & (np.arange(R)[None, :, None]
                                < len(cp.offsets))
    qc = np.clip(q, 0, ns - 1)
    ok &= cp.send_mask[qc, r, np.arange(S)[None, None, :]] > 0
    s = np.broadcast_to(np.arange(S)[None, None, :], (ns, R, S))
    order = np.argsort((r * ns + p)[ok], kind="stable")
    sel = tuple(a[ok][order] for a in (p, r, qc, s))
    p_, r_, q_, s_ = sel
    return (p_, r_, q_, cp.send_idx[q_, r_, s_].astype(np.int64),
            cp.recv_idx[p_, r_, s_].astype(np.int64))


class StackedComm:
    """Every shard in one process, stacked on a leading axis."""

    def __init__(self, n_shards: int, device=None):
        from hypre_tpu_torch.core.config import get_device

        self.n_shards = int(n_shards)
        self.device = torch.device(device) if device is not None \
            else get_device()
        self.shards = range(self.n_shards)
        self.exchanges = 0          # exchanges run (tests count them)
        self.all_gathers = 0
        self.gathered = []          # entries of each all_gather

    @property
    def n_held(self) -> int:
        return self.n_shards

    def shard_index(self) -> torch.Tensor:
        return torch.arange(self.n_shards, device=self.device)

    def _plan(self, cp: CommPkg, n_local: int, kind: str):
        key = ("stacked", kind, n_local)
        if key not in cp.plans:
            p, r, q, s_loc, g_slot = _pairs(cp)
            ng1 = cp.n_ghost + 1
            dev = self.device
            if kind == "fwd":
                plan = (torch.as_tensor(q * n_local + s_loc, device=dev),
                        torch.as_tensor(p * ng1 + g_slot, device=dev))
            elif kind == "rows":
                R = max(len(cp.offsets), 1)
                plan = (torch.as_tensor(p * ng1 + g_slot, device=dev),
                        torch.as_tensor((q * n_local + s_loc) * R + r,
                                        device=dev), R)
            else:
                # reverse with summation: entries grouped by destination
                # in round order; a (n_dst, K) table padded with the
                # dump slot of shard 0 (which holds zero)
                src = p * ng1 + g_slot
                dst = q * n_local + s_loc
                order = np.argsort(dst, kind="stable")
                src, dst = src[order], dst[order]
                udst, first, cnt = np.unique(dst, return_index=True,
                                             return_counts=True)
                K = int(cnt.max(initial=1))
                table = np.full((len(udst), K), cp.n_ghost, np.int64)
                rank = np.arange(len(dst)) - np.repeat(first, cnt)
                table[np.repeat(np.arange(len(udst)), cnt), rank] = src
                plan = (torch.as_tensor(table, device=dev),
                        torch.as_tensor(udst, device=dev))
            cp.plans[key] = plan
        return cp.plans[key]

    def exchange(self, x: torch.Tensor, cp: CommPkg) -> torch.Tensor:
        """Ghost buffer (n_shards, n_ghost + 1[, F]) of x (n_shards,
        n_local[, F]): one gather, one scatter; slot n_ghost stays
        zero."""
        ns, nl = x.shape[0], x.shape[1]
        src, dst = self._plan(cp, nl, "fwd")
        tail = tuple(x.shape[2:])
        xf = x.reshape((ns * nl,) + tail)
        ghost = torch.zeros((ns * (cp.n_ghost + 1),) + tail,
                            dtype=x.dtype, device=x.device)
        ghost[dst] = xf[src]
        self.exchanges += 1
        return ghost.reshape((ns, cp.n_ghost + 1) + tail)

    exchange_mat = exchange

    def exchange_rev(self, g: torch.Tensor, cp: CommPkg,
                     n_local: int) -> torch.Tensor:
        """Reverse exchange with summation: ghost-slot contributions g
        (n_shards, n_ghost[, F]) travel back to their owners and add into
        (n_shards, n_local[, F])."""
        ns = g.shape[0]
        table, udst = self._plan(cp, n_local, "rev")
        tail = tuple(g.shape[2:])
        gp = torch.cat([g, torch.zeros((ns, 1) + tail, dtype=g.dtype,
                                       device=g.device)], dim=1)
        gf = gp.reshape((ns * (cp.n_ghost + 1),) + tail)
        out = torch.zeros((ns * n_local,) + tail, dtype=g.dtype,
                          device=g.device)
        out[udst] = gf[table].sum(1).to(g.dtype)
        self.exchanges += 1
        return out.reshape((ns, n_local) + tail)

    def exchange_rev_rows(self, g: torch.Tensor, cp: CommPkg,
                          n_local: int) -> torch.Tensor:
        """Reverse row exchange without summation (comm.py analog of
        par_setup.exchange_rev_rows): ghost rows (n_shards, n_ghost, F)
        land in their owner's per-round slot, (n_shards, n_local, R,
        F)."""
        ns, _, F = g.shape
        src, dst, R = self._plan(cp, n_local, "rows")
        gp = torch.cat([g, torch.zeros((ns, 1, F), dtype=g.dtype,
                                       device=g.device)], dim=1)
        out = torch.zeros((ns * n_local * R, F), dtype=g.dtype,
                          device=g.device)
        out[dst] = gp.reshape(-1, F)[src]
        self.exchanges += 1
        return out.reshape(ns, n_local, R, F)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ns = a.shape[0]
        return (a * b).reshape(ns, -1).sum(1).sum()

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(a, a))

    def all_gather(self, f: torch.Tensor) -> torch.Tensor:
        """The shard-major padded global vector, (n_shards n_local,)."""
        self.all_gathers += 1
        self.gathered.append(int(f.numel()))
        return f.reshape(-1)

    def own_rows(self, u_all: torch.Tensor, n_local: int) -> torch.Tensor:
        return u_all.reshape(self.n_shards, n_local)

    def gather_host(self, x: torch.Tensor) -> np.ndarray:
        """Every shard's rows to the host, (n_shards, n_local, ...)."""
        return x.cpu().numpy()


class DistComm:
    """One shard a rank over an initialised torch.distributed group."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        from hypre_tpu_torch.core.config import get_device

        self.dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.n_shards = dist.get_world_size(group)
        self.device = torch.device(device) if device is not None \
            else get_device()
        self.shards = range(self.rank, self.rank + 1)
        self.exchanges = 0
        self.all_gathers = 0
        self.gathered = []

    @property
    def n_held(self) -> int:
        return 1

    def shard_index(self) -> torch.Tensor:
        return torch.tensor([self.rank], device=self.device)

    def _rounds(self, cp: CommPkg):
        key = ("dist", self.rank)
        if key not in cp.plans:
            me, ns = self.rank, self.n_shards
            rounds = []
            for r, off in enumerate(cp.offsets):
                to, frm = me - off, me + off
                send = recv = None
                if 0 <= to < ns:
                    k = int((cp.send_mask[me, r] > 0).sum())
                    if k:
                        send = (to, torch.as_tensor(
                            cp.send_idx[me, r, :k].astype(np.int64),
                            device=self.device))
                if 0 <= frm < ns:
                    k = int((cp.recv_idx[me, r] != cp.n_ghost).sum())
                    if k:
                        recv = (frm, torch.as_tensor(
                            cp.recv_idx[me, r, :k].astype(np.int64),
                            device=self.device))
                rounds.append((send, recv))
            cp.plans[key] = rounds
        return cp.plans[key]

    def _p2p(self, jobs):
        ops = []
        for kind, buf, peer in jobs:
            fn = self.dist.isend if kind == "send" else self.dist.irecv
            ops.append(self.dist.P2POp(fn, buf, peer, self.group))
        if ops:
            for req in self.dist.batch_isend_irecv(ops):
                req.wait()

    def exchange(self, x: torch.Tensor, cp: CommPkg) -> torch.Tensor:
        tail = tuple(x.shape[2:])
        ghost = torch.zeros((1, cp.n_ghost + 1) + tail, dtype=x.dtype,
                            device=x.device)
        jobs, recvs = [], []
        for send, recv in self._rounds(cp):
            if send is not None:
                jobs.append(("send", x[0][send[1]].contiguous(), send[0]))
            if recv is not None:
                buf = torch.empty((len(recv[1]),) + tail, dtype=x.dtype,
                                  device=x.device)
                jobs.append(("recv", buf, recv[0]))
                recvs.append((recv[1], buf))
        self._p2p(jobs)
        for slots, buf in recvs:
            ghost[0][slots] = buf
        self.exchanges += 1
        return ghost

    exchange_mat = exchange

    def exchange_rev(self, g: torch.Tensor, cp: CommPkg,
                     n_local: int) -> torch.Tensor:
        tail = tuple(g.shape[2:])
        jobs, recvs = [], []
        for send, recv in self._rounds(cp):
            # reverse: what was received goes back to its sender
            if recv is not None:
                jobs.append(("send", g[0][recv[1]].contiguous(), recv[0]))
            if send is not None:
                buf = torch.empty((len(send[1]),) + tail, dtype=g.dtype,
                                  device=g.device)
                jobs.append(("recv", buf, send[0]))
                recvs.append((send[1], buf))
        self._p2p(jobs)
        out = torch.zeros((n_local,) + tail, dtype=g.dtype, device=g.device)
        for rows, buf in recvs:          # round order, as the reference
            acc = torch.zeros_like(out)
            acc[rows] = buf
            out = out + acc
        self.exchanges += 1
        return out[None]

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = (a * b).reshape(a.shape[0], -1).sum(1).sum()
        self.dist.all_reduce(s, group=self.group)
        return s

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(a, a))

    def all_gather(self, f: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.n_shards,) + tuple(f.shape[1:]),
                          dtype=f.dtype, device=f.device)
        self.dist.all_gather_into_tensor(out, f.contiguous(),
                                         group=self.group)
        self.all_gathers += 1
        self.gathered.append(int(out.numel()))
        return out.reshape(-1)

    def own_rows(self, u_all: torch.Tensor, n_local: int) -> torch.Tensor:
        return u_all.reshape(self.n_shards, n_local)[self.rank:self.rank + 1]

    def gather_host(self, x: torch.Tensor) -> np.ndarray:
        out = torch.empty((self.n_shards,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self.dist.all_gather_into_tensor(out, x.contiguous(),
                                         group=self.group)
        return out.cpu().numpy()
