from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG  # noqa: F401
from hypre_tpu_torch.solvers.krylov import KrylovResult, pcg  # noqa: F401
from hypre_tpu_torch.solvers.krylov_more import bicgstab, gmres  # noqa: F401
