"""Error system.

Analog of hypre's global error flag + bitmask codes
(ref: src/utilities/error.h:17-30; codes HYPRE_ERROR_{GENERIC,MEMORY,
ARG,CONV} at src/utilities/HYPRE_utilities.h:147-151).  Python callers
get exceptions; solver drivers additionally record the global flag so
the hypre polling style (`HYPRE_GetError`) has an equivalent.
"""
from __future__ import annotations

ERROR_GENERIC = 1
ERROR_MEMORY = 2
ERROR_ARG = 4
ERROR_CONV = 256  # solver did not converge

_error_flag = 0


class HypreTpuError(RuntimeError):
    code = ERROR_GENERIC


class ArgumentError(HypreTpuError):
    code = ERROR_ARG


class ConvergenceError(HypreTpuError):
    code = ERROR_CONV


def set_error(code: int) -> None:
    global _error_flag
    _error_flag |= code


def get_error() -> int:
    return _error_flag


def clear_error() -> None:
    global _error_flag
    _error_flag = 0
