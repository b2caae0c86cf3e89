"""Distributed IJ assembly: an off-process stash and a device reduce.

Port of hypre_tpu/parallel/ij_par.py (``ParIJMatrix`` :33,
``_assemble_jit`` :162, ``ParIJVector`` :213), hypre's parallel IJ
build path:
  * any shard may Set or AddTo values of rows it does not own; those
    entries wait in an off-process stash (ref: src/IJ_mv/
    aux_parcsr_matrix.h:50-63 off_proc_i/off_proc_data);
  * assemble() routes them to their owners (the DataExchange step of
    IJMatrix_parcsr.c), grouping on the host, the O(stash) metadata;
  * each owner reduces its COO stack on the device with one sort and a
    segmented scan (ref: src/IJ_mv/IJMatrix_parcsr_device.c:104-130),
    with hypre's duplicate semantics: a later SET overrides everything
    before it, ADDs accumulate on top of the last SET (or of zero).

Entries are ordered by (row, col, sequence) with stable sorts, the
sequence being (calling shard, call order); a run's value is the sum of
its entries from its last SET on, by the reference's segmented scan in
jax.lax.associative_scan's association order (so floating sums agree
bit for bit).  The result is a par_setup.ParDEll (global columns),
what ParBoomerAMG.setup_distributed takes.
"""
from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.parallel.partition import RowPartition, true_starts


class ParIJMatrix:
    """Per-shard Set/AddTo staging with off-process routing."""

    def __init__(self, n_global: int, n_shards: int, communicator=None):
        from hypre_tpu_torch.parallel.comm import StackedComm

        self.part = RowPartition.create(n_global, n_shards)
        self.communicator = communicator or StackedComm(n_shards)
        # one staging list per CALLING shard (rows may be anywhere)
        self._stash = [[] for _ in range(n_shards)]

    def set_values(self, shard: int, rows, cols, values):
        self._push(shard, rows, cols, values, 1)

    def add_to_values(self, shard: int, rows, cols, values):
        self._push(shard, rows, cols, values, 0)

    def _push(self, shard, rows, cols, values, mode):
        rows = np.asarray(rows, np.int64).ravel()
        self._stash[shard].append(
            (rows, np.asarray(cols, np.int64).ravel(),
             np.asarray(values, np.float64).ravel(),
             np.full(len(rows), mode, np.int8)))

    def assemble(self):
        """Route + device reduce; returns a ParDEll."""
        from hypre_tpu_torch.parallel.par_setup import ParDEll

        ns, nl = self.part.n_shards, self.part.n_local
        # route: every entry with its owner and (source shard, sequence)
        chunks = []
        for shard, lst in enumerate(self._stash):
            if not lst:
                continue
            r, c, v, m = (np.concatenate([t[k] for t in lst])
                          for k in range(4))
            seq = (np.int64(shard) << np.int64(40)) + np.arange(len(r))
            chunks.append((r, c, v, m, seq))
        if chunks:
            r, c, v, m, seq = (np.concatenate([t[k] for t in chunks])
                               for k in range(5))
        else:
            r = c = seq = np.zeros(0, np.int64)
            v, m = np.zeros(0), np.zeros(0, np.int8)
        owner = np.asarray(self.part.owner(r))
        # stack per owner, padded to a common length (row = -1 pads)
        order = np.argsort(owner, kind="stable")
        cnt = np.bincount(owner, minlength=ns)
        m_max = max(int(cnt.max(initial=0)), 1)
        pos = np.arange(len(r)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        o = owner[order]

        def stack(a, fill, dtype):
            out = np.full((ns, m_max), fill, dtype)
            out[o, pos] = a[order]
            return out

        dev = self.communicator.device
        t = {k: torch.as_tensor(stack(a, f, d), device=dev) for k, a, f, d in
             (("r", r, -1, np.int64), ("c", c, 0, np.int64),
              ("v", v, 0.0, np.float64), ("m", m, 0, np.int8),
              ("s", seq, 0, np.int64))}
        cols, vals = _device_assemble(t, true_starts(self.part), nl)
        return ParDEll(cols=cols, vals=vals, row_part=self.part,
                       col_part=self.part, communicator=self.communicator)


def _device_assemble(t: dict, starts: np.ndarray, n_local: int):
    """The per-shard COO reduce (IJMatrix_parcsr_device.c semantics):
    sort by (row, col, seq); a run's value is its last SET plus the ADDs
    after it.  Returns slot-major (ns, w, n_local) cols and vals."""
    rows, cols, vals, mode, seq = t["r"], t["c"], t["v"], t["m"], t["s"]
    ns, m = rows.shape
    dev = rows.device
    valid = rows >= 0
    big = torch.iinfo(torch.int64).max
    key = torch.where(valid, rows * (1 << 31) | cols, big)
    # (row, col) major, sequence minor: two stable sorts
    o1 = torch.sort(seq, dim=1, stable=True).indices
    k1 = torch.gather(key, 1, o1)
    o2 = torch.sort(k1, dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)
    key_s = torch.gather(key, 1, order)
    v_s = torch.gather(vals, 1, order)
    m_s = torch.gather(mode, 1, order)
    ok = key_s < big
    new = ok.clone()
    new[:, 1:] &= key_s[:, 1:] != key_s[:, :-1]
    last = ok.clone()
    last[:, :-1] &= key_s[:, :-1] != key_s[:, 1:]
    # run value: the segmented set/add scan (a run start acts as a SET,
    # add-to-zero), in the reference's association order
    _, total = _associative_scan(_set_add, ((m_s == 1) | new, v_s))
    # compact each row's runs into slots of ascending column
    r_out = key_s >> 31
    c_out = (key_s & ((1 << 31) - 1)).to(torch.int32)
    loc = r_out - torch.as_tensor(starts[:-1], device=dev)[:, None]
    run = torch.cumsum(new.to(torch.int64), 1) - 1
    row_new = new.clone()
    row_new[:, 1:] &= r_out[:, 1:] != r_out[:, :-1]
    first = torch.cummax(torch.where(row_new, run, 0), 1).values
    slot = run - first
    keep = last & (loc >= 0) & (loc < n_local)
    w = max(int(slot[keep].max()) + 1 if bool(keep.any()) else 1, 1)
    shard = torch.arange(ns, device=dev)[:, None].expand(ns, m)
    flat = ((shard * w + slot) * n_local + loc)[keep]
    oc = torch.full((ns * w * n_local,), -1, dtype=torch.int32, device=dev)
    ov = torch.zeros(ns * w * n_local, dtype=vals.dtype, device=dev)
    oc[flat] = c_out[keep]
    ov[flat] = total[keep]
    return oc.reshape(ns, w, n_local), ov.reshape(ns, w, n_local)


def _set_add(a, b):
    """The set/add combine (ij_par.py:193-196): b's value, plus a's
    unless b holds a SET."""
    a_set, a_val = a
    b_set, b_val = b
    return a_set | b_set, b_val + torch.where(b_set, 0.0, a_val)


def _associative_scan(fn, elems):
    """Inclusive scan along axis 1 in jax.lax.associative_scan's order
    (pairwise reduction, the scan of the reduced half, then the even
    elements), so that floating sums associate exactly as the
    reference's."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = fn(tuple(e[:, 0:-1:2] for e in elems),
                 tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(o[:, :-1] for o in odd),
                  tuple(e[:, 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], 1) for e, r in zip(elems, even))
    out = []
    for e, o in zip(even, odd):
        y = torch.empty((e.shape[0], n) + tuple(e.shape[2:]), dtype=e.dtype,
                        device=e.device)
        y[:, 0::2] = e
        y[:, 1::2] = o
        out.append(y)
    return tuple(out)


class ParIJVector:
    """Per-shard Set/AddTo of vector entries, routed to their owners."""

    def __init__(self, n_global: int, n_shards: int):
        self.part = RowPartition.create(n_global, n_shards)
        self._stash = [[] for _ in range(n_shards)]

    def set_values(self, shard: int, indices, values):
        self._stash[shard].append((np.asarray(indices, np.int64),
                                   np.asarray(values, np.float64), True))

    def add_to_values(self, shard: int, indices, values):
        self._stash[shard].append((np.asarray(indices, np.int64),
                                   np.asarray(values, np.float64), False))

    def assemble(self) -> np.ndarray:
        """Sharded (n_shards, n_local) vector; sets override, adds sum,
        in (calling shard, call) order as the reference's."""
        out = np.zeros((self.part.n_shards, self.part.n_local))
        for lst in self._stash:
            for idx, v, is_set in lst:
                p = np.asarray(self.part.owner(idx))
                loc = idx - p * self.part.n_local
                if is_set:
                    out[p, loc] = v
                else:
                    np.add.at(out, (p, loc), v)
        return out
