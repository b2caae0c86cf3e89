"""The port's ext+i interpolation on the device setup
(hypre_tpu_torch/setup/device_amg.py device_extpi_interp) against
hypre_tpu's, on the CPU, stage by stage as in test_torch_device_amg.py,
on the stencil operators (the matrices that are no stencil are in
test_torch_device_extpi_matrix.py, a file of its own to keep each file's
run short): the same operator, strong mask and CF go into both; P within
1e-12 of its largest entry."""
import pytest
import torch

from hypre_tpu_torch import Config, set_config
from torch_port_helpers import (
    STAGE_STENCILS, check_extpi_equal, stage_operators,
)

torch.set_num_threads(1)
OPS = stage_operators(STAGE_STENCILS)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


@pytest.mark.parametrize("max_elmts", [0, 4])
@pytest.mark.parametrize("name", list(OPS))
def test_extpi_interp_equal(name, max_elmts):
    check_extpi_equal(OPS[name], max_elmts)
