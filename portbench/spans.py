"""The program's own spans (``hypre_tpu_torch.core.trace``) in a traced
run, and what the span metrics read from them.

* The setup spans: the tracer on (no mirror) around the program's
  build; ``amg.setup_device`` and its ``setup.*`` stages.
* The span window: one ring round of solves with the tracer on, no
  mirror and no profiler; ``amg.cycle`` gives each preconditioner
  application's device time (CUDA events) and host time.  It has to
  come before the traced sub-window: after a torch.profiler session the
  process launches more slowly (on the H100, out22's solves took 7-10%
  longer and its cycles' device time 9-14% more), and a host-bound
  cycle's device time holds the card's waits for the host.
* The span take: whole solves under torch.profiler with the tracer on
  and mirrored, so that the spans are ``user_annotation`` ranges on the
  profiler's clock beside the kernels.  One small launch before the
  solves takes the profiler's start-up (milliseconds in the first
  launch of a session), and the take's records start with the first
  launch inside a ``pcg.solve``.  Each idle gap between device records
  is charged to the innermost span that holds the runtime launch of the
  record that ends it (found by its correlation id): ``krylov`` (a
  ``pcg.*`` span), ``fine`` (``amg.level`` 0), ``coarse``
  (``amg.level`` 1 and deeper, the coarse solve included), ``cycle``
  (``amg.cycle`` outside its levels) or ``none``.

``window_spans(state, win)`` (before the traced sub-window) and
``take_spans(state, win)`` (after it) make them for a
``closed_loop_solves`` state; the readers under ``metrics/`` read
``{"window": ..., "take": ...}`` as ``ctx["spans"]`` and the setup
spans as ``ctx["setup_spans"]``, and read None where a run has neither,
as a program without the tracer gives none.

    python3 -m portbench.spans --workload out22.solve --seed 7

runs one cell's set-up, a short window, the span window, ring rounds
with the tracer off and on in turns (its cost when on), the traced
sub-window and the span take, and prints the span metrics beside the
metrics they twin and the setup stages level by level.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from portbench import trace as tr

CATEGORIES = ("krylov", "fine", "coarse", "cycle", "none")
# the span metrics, by the name before the cell's suffix
NAMES = ("cycle_ms", "cycle_host_ms", "launches_per_iter", "krylov_idle_ms",
         "fine_idle_ms", "coarse_idle_ms", "setup_pmis_s", "setup_interp_s",
         "setup_rap_s")


def tracer():
    """The program's tracer module, or None in a program without one."""
    try:
        from hypre_tpu_torch.core import trace
    except ImportError:
        return None
    return trace


def category(label: str | None) -> str:
    """The layer of a mirrored span's label (``amg.level/3/down``)."""
    if label is None:
        return "none"
    parts = label.split("/")
    if parts[0] == "amg.level":
        return "fine" if int(parts[1]) == 0 else "coarse"
    if parts[0].startswith("pcg."):
        return "krylov"
    if parts[0] == "amg.cycle":
        return "cycle"
    return "none"


def _annotations(path: str) -> list:
    """The host's record_function ranges of an exported Chrome trace, as
    (start, end, name) in microseconds, sorted by start."""
    with open(path) as f:
        t = json.load(f)
    evs = t["traceEvents"] if isinstance(t, dict) else t
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "")) for e in evs
                  if e.get("cat") == "user_annotation")


def _innermost(ranges: list, starts: list, t: float):
    """The innermost range that holds time t (ranges nest: it is the
    holding one that starts last), or None."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s, e, name = ranges[j]
        if s <= t <= e:
            return name
    return None


def split(events: list, ranges: list, wall_s: float) -> dict:
    """One span take, from its device and runtime records `events`
    (trace._load_trace's) and the program's spans `ranges`
    (``_annotations``): its PCG iterations, the kernel launches inside
    them, each idle gap's seconds by the layer that launched the record
    ending it, and its busy and wall seconds (trace.take_summary's).
    Launches before the first ``pcg.solve`` and their records are not
    the take's."""
    first = min((s for s, _, n in ranges if n == "pcg.solve"), default=None)
    if first is not None:
        before = {e["corr"] for e in events if e["cat"] == "runtime"
                  and e["ts"] < first and e["corr"] is not None}
        events = [e for e in events
                  if not (e["cat"] == "runtime" and e["ts"] < first)
                  and not (e["cat"] in tr.DEVICE_CATS
                           and e["corr"] in before)]
    starts = [s[0] for s in ranges]
    iters = sorted((s, e) for s, e, n in ranges if n == "pcg.iter")
    iter_starts = [s for s, _ in iters]
    runtime = [e for e in events if e["cat"] == "runtime"]
    launches = 0
    for e in runtime:
        if "Launch" not in e["name"]:
            continue
        j = bisect.bisect_right(iter_starts, e["ts"]) - 1
        if j >= 0 and e["ts"] <= iters[j][1]:
            launches += 1
    rt_by_corr = {e["corr"]: e for e in runtime if e["corr"] is not None}
    idle = dict.fromkeys(CATEGORIES, 0.0)
    dev = sorted((e for e in events if e["cat"] in tr.DEVICE_CATS),
                 key=lambda e: e["ts"])
    end = None
    for e in dev:
        if end is not None and e["ts"] > end:
            rt = rt_by_corr.get(e["corr"])
            label = _innermost(ranges, starts, rt["ts"]) if rt else None
            idle[category(label)] += (e["ts"] - end) / 1e6
        end = e["ts"] + e["dur"] if end is None else max(
            end, e["ts"] + e["dur"])
    summary = tr.take_summary({"events": events, "wall": wall_s,
                               "counts": {}}, [])
    return {"iters": len(iters), "launches_in_iters": launches,
            "idle_s": idle, "busy_s": summary["busy_s"], "wall_s": wall_s,
            "lost": summary["lost"]}


def span_window(program, bs: list):
    """The records of one solve of each right-hand side in `bs`, with the
    tracer on (no mirror, no profiler); None without a tracer."""
    trace = tracer()
    if trace is None:
        return None
    trace.enable()
    try:
        for b in bs:
            program.solve(b, program.precondition)
        return trace.drain()
    finally:
        trace.disable()
        trace.drain()


def span_take(program, bs: list, device):
    """One solve of each right-hand side in `bs` under torch.profiler
    with the tracer on and mirrored; `split` of its trace, or None
    without a tracer."""
    from torch.profiler import ProfilerActivity, profile

    trace = tracer()
    if trace is None:
        return None
    tr._sync(device)
    trace.enable(mirror=True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device=device)
            tr._sync(device)
            t0 = time.perf_counter()
            for b in bs:
                program.solve(b, program.precondition)
            tr._sync(device)
            wall = time.perf_counter() - t0
    finally:
        trace.disable()
        trace.drain()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = tr._load_trace(path)
        ranges = _annotations(path)
    finally:
        os.remove(path)
    return split(events, ranges, wall)


def window_spans(state, win: dict):
    """The span window of a closed_loop_solves state: one ring round
    from the measured window's next right-hand side; None without a
    tracer."""
    k0 = win["next"]
    return span_window(state.program, [state.b(k) for k in
                                       range(k0, k0 + state.traffic["ring"])])


def take_spans(state, win: dict):
    """The span take of a closed_loop_solves state: the traffic's
    ``trace.solves_per_take`` solves; None without a tracer."""
    k0 = win["next"]
    n = state.traffic["trace"]["solves_per_take"]
    return span_take(state.program, [state.b(k) for k in range(k0, k0 + n)],
                     state.device)


def setup_spans(build):
    """build() with the tracer on (no mirror): (its result, the setup's
    records or None without a tracer)."""
    trace = tracer()
    if trace is None:
        return build(), None
    trace.enable()
    try:
        return build(), trace.drain()
    finally:
        trace.disable()
        trace.drain()


# -- what the readers read -------------------------------------------------

def cycles(ctx) -> list:
    s = ctx.get("spans")
    return [r for r in s["window"] if r["name"] == "amg.cycle"] if s else []


def take(ctx):
    s = ctx.get("spans")
    return s["take"] if s and s["take"] and s["take"]["iters"] else None


def idle_ms(ctx, cat: str):
    """Idle milliseconds per PCG iteration of the span take charged to
    layer `cat`."""
    t = take(ctx)
    return None if t is None else 1e3 * t["idle_s"][cat] / t["iters"]


def stage_s(ctx, name: str):
    """Seconds of all the setup spans called `name`, over the levels."""
    recs = ctx.get("setup_spans")
    if not recs:
        return None
    return sum(r["t1_ns"] - r["t0_ns"] for r in recs
               if r["name"] == name) / 1e9


# -- the probe -------------------------------------------------------------

def _median_solve_s(program, bs) -> float:
    times = []
    for b in bs:
        t0 = time.perf_counter()
        program.solve(b, program.precondition)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def tracing_cost(state, k0: int, rounds: int) -> dict:
    """Median solve seconds of ring rounds with the tracer off and on
    (no mirror), in turns off, on, on, off."""
    trace = tracer()
    ring = state.traffic["ring"]
    bs = [state.b(k) for k in range(k0, k0 + ring)]
    off, on = [], []
    for i in range(rounds):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            if traced:
                trace.enable()
                on.append(_median_solve_s(state.program, bs))
                trace.disable()
                trace.drain()
            else:
                off.append(_median_solve_s(state.program, bs))
    m_off, m_on = statistics.median(off), statistics.median(on)
    return {"off_s": off, "on_s": on,
            "cost_pct": 100.0 * (m_on - m_off) / m_off}


def stage_table(recs: list) -> list:
    """The setup's stage seconds level by level, from its spans."""
    rows = {}
    for r in recs:
        if r["name"].startswith("setup."):
            row = rows.setdefault(r["attrs"]["level"],
                                  {"level": r["attrs"]["level"]})
            row[r["name"][len("setup."):] + "_s"] = \
                (r["t1_ns"] - r["t0_ns"]) / 1e9
            if "btake" in r["attrs"]:
                row["btake"] = row.get("btake", 0) + r["attrs"]["btake"]
    return [rows[k] for k in sorted(rows)]


def measure(spec: dict, seed: int, seconds: float, device,
            cost_rounds: int = 6) -> dict:
    """One cell's set-up with the setup spans, a window of `seconds`,
    the span window, the cost of the tracer when on, the traced
    sub-window and the span take."""
    from portbench import harness

    cfg, traffic = spec["config"], spec["traffic"]
    gen = harness.module("generators", traffic["kind"])
    program, setup_recs = setup_spans(
        lambda: harness.build_program(cfg, device))
    state = gen.start(program, traffic, seed, device,
                      device.type == "cuda")
    win = gen.window(state, seconds)
    ctx = {"device_setup_s": program.setup_s, "window": win,
           "counts": win.get("counts"), "precond": win.get("precond"),
           "traffic": traffic, "device": device,
           "setup_spans": setup_recs}
    window = window_spans(state, win)
    cost = tracing_cost(state, win["next"], cost_rounds)
    ctx["profile"] = gen.profile(state, win)
    ctx["spans"] = {"window": window, "take": take_spans(state, win)}
    suffix = ".p95" if "solve_s" not in {m["name"] for m in
                                         spec["end_to_end"]} else ".solve"
    metrics = {}
    for name in NAMES + ("precond_ms", "idle_share"):
        full = name if name.startswith("setup_") else name + suffix
        metrics[full] = harness.reader(full).read(ctx)
    t = take(ctx)
    whole = [r for r in setup_recs if r["name"] == "amg.setup_device"]
    covered = sum(r["t1_ns"] - r["t0_ns"] for r in setup_recs
                  if r["name"].startswith("setup."))
    split_s = sum(t["idle_s"][c] for c in ("krylov", "fine", "coarse"))
    out = {
        "workload": spec["cell"]["name"], "seed": seed,
        "metrics": metrics,
        "take": t,
        "take_idle_s": t["wall_s"] - t["busy_s"],
        "split_over_take_idle": split_s / (t["wall_s"] - t["busy_s"]),
        "cycle_over_precond": (metrics["cycle_ms" + suffix]
                               / metrics["precond_ms" + suffix]
                               if metrics["precond_ms" + suffix] else None),
        "setup_device_s": (whole[0]["t1_ns"] - whole[0]["t0_ns"]) / 1e9,
        "setup_covered": covered / (whole[0]["t1_ns"] - whole[0]["t0_ns"]),
        "stages": stage_table(setup_recs),
        "tracing": cost,
        "window_solves": win["attempted"], "device": str(device)}
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
        out["power_limit"] = harness.power_limit()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--cost-rounds", type=int, default=6)
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args(argv)
    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    out = measure(harness.cell_spec(args.workload), args.seed, args.seconds,
                  torch.device("cuda", 0), args.cost_rounds)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
