"""Mean host time (ms) of one preconditioner application in the span
window: the host clock of the program's ``amg.cycle`` spans, what
issuing one application costs the host (spans.py)."""
from portbench import spans


def read(ctx):
    ns = [r["t1_ns"] - r["t0_ns"] for r in spans.cycles(ctx)]
    return sum(ns) / len(ns) / 1e6 if ns else None
