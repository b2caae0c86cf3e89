"""Named-timer registry.

Analog of hypre's timing registry (`hypre_InitializeTiming` /
`hypre_BeginTiming` / `hypre_PrintTiming`, ref: src/utilities/timing.c:
38,241,328) plus the fixed-slot HYPRE_PROFILE wall timers
(ref: src/seq_mv/HYPRE_seq_mv.h:82-135).  CUDA work is asynchronous, so
a timer given a CUDA tensor synchronizes its device before it stops.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Timer:
    def __init__(self):
        self.wall = defaultdict(float)
        self.count = defaultdict(int)
        self._start = {}

    def begin(self, name: str):
        self._start[name] = time.perf_counter()

    def end(self, name: str, sync=None):
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.wall[name] += time.perf_counter() - self._start.pop(name)
        self.count[name] += 1

    @contextmanager
    def __call__(self, name: str):
        self.begin(name)
        result_holder = []
        try:
            yield result_holder
        finally:
            sync = result_holder[0] if result_holder else None
            self.end(name, sync)

    def report(self) -> str:
        lines = ["=" * 50]
        for name in sorted(self.wall):
            lines.append(
                f"{name:<34s} {self.wall[name]:10.4f} s  x{self.count[name]}"
            )
        lines.append("=" * 50)
        return "\n".join(lines)

    def clear(self):
        self.wall.clear()
        self.count.clear()
        self._start.clear()


timers = Timer()
