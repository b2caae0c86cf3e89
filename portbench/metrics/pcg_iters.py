"""Mean PCG iterations over the window's solves, as pcg returned them."""


def read(ctx):
    it = ctx["window"]["iters"]
    return sum(it) / len(it) if it else None
