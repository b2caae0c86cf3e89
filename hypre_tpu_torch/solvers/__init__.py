from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG  # noqa: F401
from hypre_tpu_torch.solvers.krylov import PcgResult, pcg  # noqa: F401
