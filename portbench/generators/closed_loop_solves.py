"""Traffic of kind ``closed_loop_solves``: one caller solves back to
back, each call one solve of the next right-hand side of a ring made
from the seed on the card, from a zero guess, ended by a synchronize.

The traffic file gives the ring's size and range (``ring``, ``rhs``),
the warm-up solves, how many solutions the comparison samples
(``sample.solutions``) and the traced sub-window's takes (``trace``).

End-to-end values: ``solve_s``, the window's wall time over the solves
it completed, and ``solve_p95_s``, the 95th percentile of the solve
times (host clock around each solve).
"""
from __future__ import annotations

import random
import statistics
import time

import torch

from portbench import trace as tr


class Precond:
    """The preconditioner the window hands to the solver: one
    application of the program's.  It keeps the (r, z) of application
    number `keep` for the comparison and, when `timed`, records CUDA
    events around every application (read after the window)."""

    def __init__(self, apply, keep: int, timed: bool):
        self.apply, self.keep, self.timed = apply, keep, timed
        self.calls = 0
        self.events = []
        self.pair = None

    def __call__(self, r):
        if self.timed:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            z = self.apply(r)
            stop.record()
            self.events.append((start, stop))
        else:
            z = self.apply(r)
        if self.calls == self.keep:
            self.pair = (r, z)
        self.calls += 1
        return z


def make_ring(traffic: dict, n: int, seed: int, dtype, device) -> list:
    """The ring of right-hand sides, uniform in [low, high), from the
    seed on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lo, hi = traffic["rhs"]["low"], traffic["rhs"]["high"]
    return [(torch.rand(n, generator=g, dtype=torch.float64, device=device)
             * (hi - lo) + lo).to(dtype) for _ in range(traffic["ring"])]


def p95(values) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


class State:
    def __init__(self, program, traffic, seed, device, timed):
        self.program, self.traffic, self.seed = program, traffic, seed
        self.device = device
        self.ring = make_ring(traffic, program.n, seed, program.dtype,
                              device)
        # the application kept for the comparison: one of the first
        # solve's
        self.M = Precond(program.precondition,
                         random.Random(seed).randrange(8), timed)
        warm = Precond(program.precondition, -1, timed)
        for w in range(traffic["warmup_solves"]):
            program.solve(self.ring[w % len(self.ring)], warm)

    def b(self, k: int):
        return self.ring[k % len(self.ring)]


def start(program, traffic: dict, seed: int, device, timed: bool) -> State:
    """Set-up of the traffic: the ring and the warm-up solves."""
    return State(program, traffic, seed, device, timed)


def window(state: State, seconds: float) -> dict:
    """Solves back to back until `seconds` have passed.  Keeps a sample
    of the solutions drawn from the seed (reservoir), each with its
    right-hand side."""
    prog = state.program
    n_keep = state.traffic["sample"]["solutions"]
    pick = random.Random(state.seed ^ 0x5EED)
    kept = []
    times, iters, bad = [], [], 0
    k = 0
    prog.reset_counters()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        res = prog.solve(state.b(k), state.M)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        iters.append(res.iters)
        if not prog.solved(res):
            bad += 1
        if len(kept) < n_keep:
            kept.append((k, res.x))
        else:
            j = pick.randrange(k + 1)
            if j < n_keep:
                kept[j] = (k, res.x)
        k += 1
        if t1 >= deadline:
            break
    window_s = t1 - t_start
    return {"values": {"solve_s": window_s / len(times),
                       "solve_p95_s": p95(times)},
            "attempted": len(times), "failed": bad, "next": k,
            "times": times, "iters": iters, "counts": prog.counters(),
            "precond": state.M, "pair": state.M.pair,
            "answers": [(state.b(i), x) for i, x in kept]}


def profile(state: State, win: dict) -> dict:
    """The traced sub-window: whole solves under the profiler after the
    window (trace.profile_solves)."""
    prog = state.program
    return tr.profile_solves(
        lambda k: prog.solve(state.b(k), prog.precondition), win["next"],
        state.traffic["trace"], prog.served(), state.device, prog)
