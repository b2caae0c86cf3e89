"""K1 (stencil_matvec): its share of its bytes bound over the window's
launches (roofline.kernel_share)."""
from portbench.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "stencil_matvec")
