"""Structured-grid solvers of the port: the struct matrix and its
matvec, PFMG, SMG (cyclic reduction line solves), SparseMSG, SysPFMG,
FAC and multi-box grids.  The distributed struct solvers (ParPFMG,
ParSMG, ParSysPFMG on z-slabs) are in ``struct.par_struct``."""
from hypre_tpu_torch.struct.grid import (  # noqa: F401
    StructMatrix, struct_laplacian, struct_matrix_from_stencil,
    struct_matvec,
)
from hypre_tpu_torch.struct.pfmg import PFMG, PfmgConfig  # noqa: F401
from hypre_tpu_torch.struct.smg import SMG, SmgConfig  # noqa: F401
from hypre_tpu_torch.struct.sparse_msg import (  # noqa: F401
    SparseMSG, SparseMSGConfig,
)
from hypre_tpu_torch.struct.sys_pfmg import SysPFMG  # noqa: F401
from hypre_tpu_torch.struct.fac import FAC, FacConfig  # noqa: F401
from hypre_tpu_torch.struct.boxes import (  # noqa: F401
    Box, BoxArray, BoxManager, StructGrid,
)
