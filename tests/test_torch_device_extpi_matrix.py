"""The port's ext+i interpolation on the device setup against
hypre_tpu's, on the CPU, on the stage tests' matrices that are no
stencil (a convection-diffusion matrix and a random SPD one); the
stencil operators are in test_torch_device_extpi.py."""
import pytest
import torch

from hypre_tpu_torch import Config, set_config
from torch_port_helpers import (
    STAGE_MATRICES, check_extpi_equal, stage_operators,
)

torch.set_num_threads(1)
OPS = stage_operators(STAGE_MATRICES)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


@pytest.mark.parametrize("max_elmts", [0, 4])
@pytest.mark.parametrize("name", list(OPS))
def test_extpi_interp_equal(name, max_elmts):
    check_extpi_equal(OPS[name], max_elmts)
