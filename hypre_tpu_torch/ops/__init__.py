from hypre_tpu_torch.ops.dia import (  # noqa: F401
    DiaMatrix, dia_from_scipy, dia_matvec, dia_matvec_plain,
)
from hypre_tpu_torch.ops.formats import (  # noqa: F401
    CsrMatrix, DenseMatrix, SparseOp, StencilOp, matmat, matvec,
    sparse_op_from_dell, sparse_op_from_scipy,
)
from hypre_tpu_torch.ops.btake import (  # noqa: F401
    btake, btake_rows, btake_rows_plain,
)
from hypre_tpu_torch.ops.spmv import (  # noqa: F401
    csr_spmm, csr_spmm_plain, csr_spmv, csr_spmv_plain,
)
from hypre_tpu_torch.ops.stencil import (  # noqa: F401
    stencil_matvec, stencil_matvec_plain, stencil_op,
)
