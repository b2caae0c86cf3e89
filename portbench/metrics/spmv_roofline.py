"""K2 (csr_spmv): its share of its bytes bound over the window's
launches, each operator's traced device time scaled to its counted
launches (roofline.kernel_share)."""
from portbench.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "csr_spmv")
