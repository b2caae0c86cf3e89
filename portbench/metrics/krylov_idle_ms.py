"""Idle device time (ms) per PCG iteration of the span take whose ending
launch lies in a ``pcg.*`` span outside ``amg.cycle``: PCG's own vector
updates, dots and norms (spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "krylov")
