from hypre_tpu_torch.gen.laplace import (  # noqa: F401
    stencil_matrix, laplacian, laplacian_9pt, laplacian_27pt, difconv,
    rotate_7pt, vardifconv,
)
