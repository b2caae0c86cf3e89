"""Row partitions of the distributed layer (numpy, host).

The port's own copy of hypre_tpu/parallel/partition.py (``RowPartition``
:19, ``GenPartition`` :46): hypre's 1-D block-row partition
(``row_starts``, ref: src/parcsr_mv/par_csr_matrix.h:51).  Every shard
holds ``n_local`` padded slots so that the shards' arrays stack into one
``(n_shards, n_local, ...)`` tensor; padding rows are decoupled
identity rows, and b = 0 there keeps them exactly zero through a solve.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Equal partition: shard p owns global rows [p n_local, (p+1)
    n_local), the last one padded past n_global."""

    n_global: int          # true (unpadded) global size
    n_shards: int
    n_local: int           # padded equal local size

    @staticmethod
    def create(n_global: int, n_shards: int) -> "RowPartition":
        n_local = -(-n_global // n_shards)
        return RowPartition(n_global, n_shards, n_local)

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.n_local

    def owner(self, gid):
        """Owning shard of (padded) global row ids."""
        return np.minimum(np.asarray(gid) // self.n_local, self.n_shards - 1)

    def local_index(self, gid):
        return np.asarray(gid) - self.owner(gid) * self.n_local

    def shard_starts(self) -> np.ndarray:
        return np.arange(self.n_shards + 1) * self.n_local


@dataclasses.dataclass(frozen=True)
class GenPartition:
    """Unequal contiguous partition: shard p owns global ids
    [starts[p], starts[p+1]) in local slots [0, count_p) of n_local
    padded slots.  The distributed setup's coarse partitions are of
    this kind: each shard keeps its own C points, as hypre does."""

    starts: tuple          # len n_shards + 1, ascending
    n_local: int           # padded local width (>= max count)

    @staticmethod
    def create(counts) -> "GenPartition":
        counts = np.asarray(counts, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)])
        return GenPartition(starts=tuple(int(s) for s in starts),
                            n_local=int(max(counts.max(initial=0), 1)))

    @property
    def n_shards(self) -> int:
        return len(self.starts) - 1

    @property
    def n_global(self) -> int:
        return int(self.starts[-1])

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.n_local

    def counts(self) -> np.ndarray:
        s = np.asarray(self.starts)
        return (s[1:] - s[:-1]).astype(np.int64)

    def owner(self, gid):
        s = np.asarray(self.starts)
        return np.clip(np.searchsorted(s, np.asarray(gid), side="right")
                       - 1, 0, self.n_shards - 1)

    def local_index(self, gid):
        s = np.asarray(self.starts)
        return np.asarray(gid) - s[self.owner(gid)]

    def shard_starts(self) -> np.ndarray:
        return np.asarray(self.starts)


def true_starts(part) -> np.ndarray:
    """Start of each shard's true rows, clipped to n_global (a
    RowPartition's padded tail folds into n_global)."""
    s = np.asarray(part.shard_starts(), dtype=np.int64)
    return np.minimum(s, part.n_global)


def true_counts(part) -> np.ndarray:
    s = true_starts(part)
    return s[1:] - s[:-1]


def padded_slot(gid, part) -> np.ndarray:
    """Position of global ids in the shard-major padded order:
    owner * n_local + local index."""
    gid = np.asarray(gid, dtype=np.int64)
    return part.owner(gid) * part.n_local + (gid - true_starts(part)[
        part.owner(gid)])
