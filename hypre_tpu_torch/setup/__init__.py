from hypre_tpu_torch.setup.strength import strength_matrix  # noqa: F401
from hypre_tpu_torch.setup.coarsen import pmis, C_PT, F_PT, SF_PT  # noqa: F401
from hypre_tpu_torch.setup.interp import direct_interp, truncate_interp  # noqa: F401
from hypre_tpu_torch.setup.l1norms import l1_norms  # noqa: F401
from hypre_tpu_torch.setup.device_amg import (  # noqa: F401
    DEll, dell_from_scipy, dell_stencil, dell_to_scipy,
    iter_device_hierarchy,
)
