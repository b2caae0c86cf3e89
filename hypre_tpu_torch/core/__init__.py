from hypre_tpu_torch.core.config import (  # noqa: F401
    Config, get_config, get_device, set_config,
)
from hypre_tpu_torch.core.errors import (  # noqa: F401
    HypreTpuError, ConvergenceError, ArgumentError, get_error, set_error,
    clear_error, ERROR_GENERIC, ERROR_MEMORY, ERROR_ARG, ERROR_CONV,
)
