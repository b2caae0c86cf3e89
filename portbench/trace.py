"""The traced sub-window: whole solves under torch.profiler, retaken
until every operator each declared kernel serves has enough traced
launches, and what the per-layer metrics read from it.

Each take resets the program's launch counters, runs whole solves
under the profiler, and reads CUPTI's records from the exported Chrome
trace (kernels with their launch grid, copies, sets, and the host's
runtime calls that each device record answers).  A kernel record is
given to the operator it served by its kernel's name (the counter's
name: ``stencil_matvec``, ``csr_spmv``) and, where a kernel serves more
than one operator, by its launch's thread count (grid times block),
which covers the operator's rows times its threads a row.  The tracer
may drop records; a take that dropped some still counts, and takes go
on until each operator has ``min_launches_per_op`` traced launches.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import Counter

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _load_trace(path: str) -> list:
    with open(path) as f:
        tr = json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    out = []
    for e in evs:
        cat = e.get("cat")
        if cat in DEVICE_CATS or cat in ("cuda_runtime", "cuda_driver",
                                         "cpu_op"):
            a = e.get("args", {})
            out.append({"cat": "runtime" if cat in ("cuda_runtime",
                                                    "cuda_driver") else cat,
                        "name": e.get("name", ""), "ts": float(e["ts"]),
                        "dur": float(e.get("dur", 0.0)),
                        "corr": a.get("correlation"), "grid": a.get("grid"),
                        "block": a.get("block")})
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def torch_take(run_solve, k0: int, n: int, device, program) -> dict:
    """n whole solves under torch.profiler; the records, the host wall
    time of the take and the program's launch counters over it."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        program.reset_counters()
        t0 = time.perf_counter()
        for k in range(k0, k0 + n):
            run_solve(k)
        _sync(device)
        wall = time.perf_counter() - t0
        counts = program.counters()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = _load_trace(path)
    finally:
        os.remove(path)
    return {"events": events, "wall": wall, "counts": counts}


def attribute(ev: dict, served: list):
    """The served operator a kernel record belongs to, or None."""
    fam = [s for s in served if s["kernel"] in ev["name"]
           and s["type_name"] in ev["name"]]
    if len(fam) <= 1:
        return fam[0] if fam else None
    g, b = ev.get("grid") or [0], ev.get("block") or [0]
    threads = 1
    for x in list(g) + list(b):
        threads *= int(x)
    per_block = 1
    for x in b:
        per_block *= int(x)
    hit = [s for s in fam if s["threads"] is not None
           and threads - per_block < s["threads"] <= threads]
    return hit[0] if len(hit) == 1 else None


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _base(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    m = re.search(r"(\w+)\s*[<(]", name.replace("(anonymous namespace)", ""))
    return m.group(1) if m else name[:60]


def _enclosing(cpu_ops, starts, t: float):
    """Name of the innermost host op that holds time t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        s, e, name = cpu_ops[j]
        if s <= t <= e:
            return name
    return None


def take_summary(take: dict, served: list) -> dict:
    """Per take: busy seconds (the union of device records, plus the
    launches whose record the tracer lost at the take's mean kernel
    time), the traced launches and seconds of each operator, and the
    idle gaps by what the host was doing."""
    evs = take["events"]
    dev = [e for e in evs if e["cat"] in DEVICE_CATS]
    kern = [e for e in dev if e["cat"] == "kernel"]
    have = {e["corr"] for e in dev if e["corr"] is not None}
    runtime = [e for e in evs if e["cat"] == "runtime"]
    lost = [e for e in runtime if e["corr"] is not None
            and e["corr"] not in have and "Launch" in e["name"]]
    mean_k = (sum(e["dur"] for e in kern) / len(kern)) if kern else 0.0
    busy_us = _union((e["ts"], e["ts"] + e["dur"]) for e in dev) \
        + len(lost) * mean_k
    ops = {}
    unknown = 0
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        s = attribute(e, served)
        if s is None:
            if any(x["kernel"] in e["name"] for x in served):
                unknown += 1
            continue
        o = ops.setdefault(s["key"], {"traced": 0, "us": 0.0})
        o["traced"] += 1
        o["us"] += e["dur"]
    # idle gaps, each named by the host op that launched the record
    # ending it
    rt_by_corr = {e["corr"]: e for e in runtime if e["corr"] is not None}
    cpu = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                 if e["cat"] == "cpu_op")
    starts = [c[0] for c in cpu]
    gaps = {}
    dev.sort(key=lambda e: e["ts"])
    end = None
    for e in dev:
        if end is not None and e["ts"] > end:
            rt = rt_by_corr.get(e["corr"])
            host = _enclosing(cpu, starts, rt["ts"]) if rt else None
            label = host or ("launch of " + _base(e["name"]))
            gaps[label] = gaps.get(label, 0.0) + (e["ts"] - end)
        end = max(end or e["ts"], e["ts"] + e["dur"])
    return {"busy_s": busy_us / 1e6, "wall_s": take["wall"], "ops": ops,
            "unattributed": unknown, "lost": len(lost),
            "counts": take["counts"], "by_name_s":
                {k: v / 1e6 for k, v in by_name.items()},
            "gaps_s": {k: v / 1e6 for k, v in gaps.items()}}


def enough(summaries: list, served: list, need: int) -> bool:
    traced = {}
    for s in summaries:
        for k, o in s["ops"].items():
            traced[k] = traced.get(k, 0) + o["traced"]
    return all(traced.get(s["key"], 0) >= need for s in served)


def profile_solves(run_solve, k0: int, tcfg: dict, served: list, device,
                   program, take=torch_take) -> dict:
    """Takes of whole solves until `enough`, at most max_takes; the
    pooled result every traced metric reads.  `program` gives the
    launch counters (reset_counters(), counters())."""
    sums = []
    k = k0
    for _ in range(tcfg["max_takes"]):
        sums.append(take_summary(
            take(run_solve, k, tcfg["solves_per_take"], device, program),
            served))
        k += tcfg["solves_per_take"]
        if enough(sums, served, tcfg["min_launches_per_op"]):
            break
    ops, by_name, gaps, counted = {}, Counter(), Counter(), Counter()
    for s in sums:
        for key, o in s["ops"].items():
            p = ops.setdefault(key, {"traced": 0, "us": 0.0})
            p["traced"] += o["traced"]
            p["us"] += o["us"]
        by_name.update(s["by_name_s"])
        gaps.update(s["gaps_s"])
        counted.update(s["counts"])
    kernel_of = {x["key"]: x["kernel"] for x in served}
    traced = Counter()
    for key, o in ops.items():
        traced[kernel_of[key]] += o["traced"]
    return {"takes": len(sums),
            "complete": enough(sums, served, tcfg["min_launches_per_op"]),
            "busy_s": sum(s["busy_s"] for s in sums),
            "window_s": sum(s["wall_s"] for s in sums),
            "ops": ops, "served": served,
            "launches": {"takes": len(sums), "traced": dict(traced),
                         "counted": dict(counted),
                         "lost_records": sum(s["lost"] for s in sums),
                         "unattributed": sum(s["unattributed"]
                                             for s in sums)},
            "breakdown": {"device_ops": [[n[:200], v] for n, v
                                         in by_name.most_common(10)],
                          "idle_gaps": [[n[:200], v] for n, v
                                        in gaps.most_common(10)]}}
