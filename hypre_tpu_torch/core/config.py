"""Global handle / configuration.

The port's analog of hypre's process-wide handle (`hypre_Handle`,
ref: src/utilities/handle.h:34-81 and HYPRE_Initialize,
src/utilities/general.c:376).  The knobs are the floating dtype of
values and the device the solve phase runs on.

The device is ``cuda`` unless the caller asks for the CPU
(``set_config(Config(device="cpu"))``, as the tests do).  With no card
and no such request, ``get_device()`` raises: the port never carries on
silently on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.core.errors import HypreTpuError


@dataclasses.dataclass
class Config:
    """Library-wide configuration, the `hypre_Handle` analog.

    real_dtype: value dtype of the solve phase.  float64 mirrors
                hypre's default build and is the card's native f64;
                float32 mirrors --enable-single.  Setup always runs in
                f64: on the host (setup) or on the device
                (setup_device).
    device:     "cuda" (default) or "cpu".
    """

    real_dtype: torch.dtype = torch.float64
    device: str = "cuda"


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg


def get_device() -> torch.device:
    """The configured device; raises if it is a card that is absent."""
    dev = torch.device(get_config().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HypreTpuError(
            "hypre_tpu_torch runs on a CUDA device by default and none "
            "is available; call set_config(Config(device='cpu')) to run "
            "on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU):
    the setup's stage timings end with it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def as_real(x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A vector as a tensor of the configured dtype on the configured
    device (numpy input is copied; a matching tensor is returned as is)."""
    dtype = dtype or get_config().real_dtype
    dev = get_device()
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
