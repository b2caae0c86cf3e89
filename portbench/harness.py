"""One run of one cell: set-up, the measured window, the traced
sub-window and the comparison with the reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name, so that a new cell, metric, solver
or kind of traffic is new files and BENCHMARK.json entries:

* ``configs/<config>.json``: the configuration.  Its ``program`` key
  names the module under ``programs/`` that builds the system under
  test, ``build(cfg, dtype, device)``; its ``checks`` key the module
  under ``checks/`` whose ``compare(program, window, cfg, traffic,
  seed, device)`` gives each compared number with its limit.
* ``traffic/<traffic>.json``: the traffic mix.  Its ``kind`` names the
  module under ``generators/`` with ``start(program, traffic, seed,
  device, timed)`` (the traffic's set-up), ``window(state, seconds)``
  (the measured window: its end-to-end values by name under "values",
  "attempted", "failed", and what the readers and the comparison read)
  and ``profile(state, window)`` (the traced sub-window).
* ``metrics/<metric>.py`` (or the part of the name before its first
  dot): the reader of a per-layer metric, ``read(ctx) -> float | None``.

The cell's entries come from BENCHMARK.json at the root of the
checkout.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload: str, manifest: dict | None = None) -> dict:
    """The cell's entry, its configuration and traffic files, and the
    metrics it reports in an untraced and in a traced run."""
    m = manifest or load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in m["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    e2e = [x for x in m["end_to_end"]
           if workload in x.get("workloads", [workload])]
    names = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if (workload in x["workloads"] if "workloads" in x
                 else x["moves"] in names)]
    return {"cell": cell,
            "config": load_json(HERE, "configs", cell["config"] + ".json"),
            "traffic": load_json(HERE, "traffic", cell["traffic"] + ".json"),
            "end_to_end": e2e, "per_layer": layer}


def module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the harness."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.exists(path):
        raise SystemExit(f"no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader module of a per-layer metric."""
    for stem in (metric, metric.split(".")[0]):
        if os.path.exists(os.path.join(HERE, "metrics", stem + ".py")):
            return module("metrics", stem)
    raise SystemExit(f"no reader for metric {metric!r} under metrics/")


def build_program(cfg: dict, device, dtype: torch.dtype | None = None):
    """The configuration's program, in its stated precision unless
    `dtype` is given."""
    dtype = dtype or getattr(torch, cfg["precision"])
    return module("programs", cfg["program"]).build(cfg, dtype, device)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, t0: float,
             device: torch.device) -> dict:
    """One run; returns the result line's object (without printing)."""
    cfg, traffic = spec["config"], spec["traffic"]
    gen = module("generators", traffic["kind"])
    checks = module("checks", cfg["checks"])
    program = build_program(cfg, device)
    state = gen.start(program, traffic, seed, device,
                         trace and device.type == "cuda")
    setup_s = time.perf_counter() - t0
    cpu0 = cpu_times()
    win = gen.window(state, seconds)
    cpu1 = cpu_times()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    ctx = {"device_setup_s": program.setup_s, "window": win,
           "counts": win.get("counts"), "precond": win.get("precond"),
           "traffic": traffic, "device": device}
    if trace:
        ctx["profile"] = gen.profile(state, win)

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, **win["values"]}
        for m in spec["end_to_end"]:
            if m["name"] not in values:
                raise RuntimeError(
                    f"metric {m['name']}: the traffic generator "
                    f"{traffic['kind']} gives no such value")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            mod = reader(m["name"])
            v = mod.read(ctx)
            if v is None:
                raise RuntimeError(
                    f"metric {m['name']}: its reader found nothing to read "
                    f"in this run ({mod.__doc__.strip()})")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    found = checks.compare(program, win, cfg, traffic, seed, device)
    print(f"portbench: comparison {time.perf_counter() - t_check:.1f} s; "
          f"window: {steal_share(cpu0, cpu1)}", file=sys.stderr)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec["cell"]["chips"], "memory_peak_bytes": peak}
    out = {"correct": passed(found), "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace:
        prof = ctx["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = prof["breakdown"]
        out["launches"] = {"window": win.get("counts"), **prof["launches"]}
    out["checks"] = found
    return out


def passed(found: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in found.values())


FORBIDDEN = ("jax", "jaxlib", "flax", "hypre_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (hypre_tpu_torch is not hypre_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def host() -> str:
    """The host's CPU model, cores and load averages, for reading the
    spread of host-bound cells."""
    model = "?"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), "?")
        with open("/proc/loadavg") as f:
            load = " ".join(f.read().split()[:3])
    except OSError:
        load = "?"
    return f"{model}, {os.cpu_count()} cpus, load {load}"


def cpu_times() -> tuple:
    """The machine's CPU time counters (/proc/stat's first line), this
    process's CPU seconds and the host clock."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            counters = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        counters = []
    return counters, ru.ru_utime + ru.ru_stime, time.perf_counter()


def steal_share(a: tuple, b: tuple) -> str:
    """Between two readings: the cores this process kept busy, and the
    shares of the machine's CPU time that were busy and that the
    hypervisor took (steal)."""
    cores = (b[1] - a[1]) / max(b[2] - a[2], 1e-9)
    out = f"this process {cores:.2f} cores"
    if len(a[0]) < 8 or len(b[0]) < 8:
        return out
    d = [y - x for x, y in zip(a[0], b[0])]
    total = sum(d[:8]) or 1
    busy = total - d[3] - d[4]
    return (out + f", machine busy {100 * busy / total:.1f}% of "
            f"{os.cpu_count()} cpus, steal {100 * d[7] / total:.2f}%")


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
