"""Idle device time (ms) per PCG iteration of the span take whose ending
launch lies in an ``amg.level`` span of level 1 or deeper, the coarse
solve included (spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "coarse")
