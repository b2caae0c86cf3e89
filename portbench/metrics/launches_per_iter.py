"""Runtime kernel launches inside the program's ``pcg.iter`` spans, per
iteration of the span take (spans.py)."""
from portbench import spans


def read(ctx):
    t = spans.take(ctx)
    return None if t is None else t["launches_in_iters"] / t["iters"]
