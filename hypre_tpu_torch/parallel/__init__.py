"""The distributed layer: row partitions, halo-exchange schedules and
their executors (stacked shards in one process, or torch.distributed),
ParCSR matrices, and the distributed setup, IJ assembly and AMG-DD."""
from hypre_tpu_torch.parallel.partition import (  # noqa: F401
    GenPartition, RowPartition,
)
from hypre_tpu_torch.parallel.comm import (  # noqa: F401
    CommPkg, DistComm, StackedComm, build_comm_pkg,
)
from hypre_tpu_torch.parallel.parcsr import (  # noqa: F401
    ParCSR, ParStencilOp, par_dot, par_matvec, par_stencil_matvec,
    parcsr_from_scipy, shard_vector, unshard_vector,
)
