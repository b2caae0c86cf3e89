"""The device's idle share (%) of the traced sub-window: 1 - busy /
wall, busy from the trace's device records with lost launches added
back (trace.take_summary)."""


def read(ctx):
    p = ctx.get("profile")
    if not p or p["window_s"] <= 0 or not 0 < p["busy_s"] <= p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
