"""The port's tracer: named spans on the host clock, kept in memory.

Call sites guard every span with ``if trace.on:``, so with the tracer
off a span boundary costs one attribute test: no object, no clock read,
no CUDA event and no profiler range.  The tracer never synchronizes the
card on the traced path; ``drain()`` synchronizes once, when the caller
reads the records.

    trace.enable()                  # mirror=True: profiler ranges too
    tok = trace.begin("pcg.iter")   # device=x: CUDA events on x's stream
    ...
    trace.end(tok, iters=3)
    records = trace.drain()

Each record is a dict: ``id``, ``parent`` (the span open when it began),
``solve`` (the id of the enclosing ``pcg.solve``), ``name``, ``t0_ns``
and ``t1_ns`` (``time.perf_counter_ns``), ``attrs``, and ``device_ms``
(the CUDA events' elapsed time, or None).  With ``mirror=True`` each
span opened by ``begin`` also enters a ``torch.profiler.record_function``
range named ``name`` followed by its begin attributes, e.g.
``amg.level/3/down``, so that under an active profiler the spans land in
the same trace as the kernels, on the profiler's clock.

``add(name, t0_ns, t1_ns, **attrs)`` records a span from clock readings
the caller already made (the device setup's stage times): one reading,
two views.  Such a span has no device time and no profiler range.
"""
from __future__ import annotations

from time import perf_counter_ns

import torch
from torch.profiler import record_function

on = False
_mirror = False
_records: list = []
_stack: list = []
_next_id = 0


def enable(mirror: bool = False) -> None:
    """Start recording; with `mirror`, also enter a profiler range per
    span."""
    global on, _mirror
    on, _mirror = True, mirror
    _stack.clear()


def disable() -> None:
    global on, _mirror
    on, _mirror = False, False


def _open(name: str, attrs: dict) -> dict:
    global _next_id
    _next_id += 1
    top = _stack[-1] if _stack else None
    rec = {"id": _next_id, "parent": top["id"] if top else None,
           "solve": top["solve"] if top else None, "name": name,
           "t0_ns": None, "t1_ns": None, "attrs": attrs, "device_ms": None}
    if name == "pcg.solve":
        rec["solve"] = rec["id"]
    _records.append(rec)
    return rec


def begin(name: str, device: torch.Tensor | None = None, **attrs) -> dict:
    """Open a span; returns the token that `end` closes.  `device`, a
    CUDA tensor, adds a CUDA event pair on its current stream."""
    rec = _open(name, attrs)
    if _mirror:
        rec["_rf"] = record_function("/".join([name,
                                               *map(str, attrs.values())]))
        rec["_rf"].__enter__()
    if device is not None and device.is_cuda:
        stream = torch.cuda.current_stream(device.device)
        rec["_events"] = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True), stream)
        rec["_events"][0].record(stream)
    _stack.append(rec)
    rec["t0_ns"] = perf_counter_ns()
    return rec


def end(tok: dict, **attrs) -> None:
    """Close the span `tok`, adding `attrs` to its attributes."""
    tok["t1_ns"] = perf_counter_ns()
    if "_events" in tok:
        tok["_events"][1].record(tok["_events"][2])
    rf = tok.pop("_rf", None)
    if rf is not None:
        rf.__exit__(None, None, None)
    tok["attrs"].update(attrs)
    # spans that an exception left open inside this one close with it
    while _stack and _stack.pop() is not tok:
        pass


def add(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """Record a closed span from the caller's own clock readings."""
    rec = _open(name, attrs)
    rec["t0_ns"], rec["t1_ns"] = t0_ns, t1_ns


def drain() -> list:
    """The records so far, emptying the buffer.  Spans with CUDA events
    get their device time after one synchronize of each card."""
    global _records
    recs, _records = _records, []
    timed = [r for r in recs if "_events" in r and r["t1_ns"] is not None]
    for dev in {r["_events"][2].device for r in timed}:
        torch.cuda.synchronize(dev)
    for r in timed:
        e0, e1, _ = r.pop("_events")
        r["device_ms"] = e0.elapsed_time(e1)
    return recs
