from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG  # noqa: F401
from hypre_tpu_torch.solvers.krylov import KrylovResult, pcg  # noqa: F401
from hypre_tpu_torch.solvers.krylov_more import (  # noqa: F401
    bicgstab, cgnr, cogmres, flexgmres, gmres, lgmres,
)
from hypre_tpu_torch.solvers.hybrid import (  # noqa: F401
    HybridConfig, HybridResult, hybrid_solve,
)
from hypre_tpu_torch.solvers.lobpcg import LobpcgResult, lobpcg  # noqa: F401
from hypre_tpu_torch.solvers.fsai import FSAI, FsaiConfig  # noqa: F401
from hypre_tpu_torch.solvers.parasails import (  # noqa: F401
    ParaSails, ParaSailsConfig,
)
from hypre_tpu_torch.solvers.ilu import ILU, IluConfig  # noqa: F401
from hypre_tpu_torch.solvers.schwarz import Schwarz, SchwarzConfig  # noqa: F401
from hypre_tpu_torch.solvers.mgr import MGR, MgrConfig  # noqa: F401
from hypre_tpu_torch.solvers.ams import AMS, AmsConfig  # noqa: F401
from hypre_tpu_torch.solvers.ams import ADS, AME  # noqa: F401
