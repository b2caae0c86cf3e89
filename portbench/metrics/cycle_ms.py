"""Mean device time (ms) of one preconditioner application in the span
window: the CUDA events of the program's ``amg.cycle`` spans, the
in-program twin of precond_ms (spans.py)."""
from portbench import spans


def read(ctx):
    ms = [r["device_ms"] for r in spans.cycles(ctx)]
    return sum(ms) / len(ms) if ms and None not in ms else None
