"""Mean device time (ms) of one preconditioner application in the
window: CUDA events recorded around each application by the window's
preconditioner wrapper, read after the window's last synchronize."""


def read(ctx):
    ev = ctx["precond"].events
    if not ev:
        return None
    return sum(a.elapsed_time(b) for a, b in ev) / len(ev)
