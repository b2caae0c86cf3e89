"""Seconds of the device setup's ``setup.pmis`` spans, summed over the
levels: host clock, each ending at the stage's own synchronize
(spans.py)."""
from portbench import spans


def read(ctx):
    return spans.stage_s(ctx, "setup.pmis")
