"""The port's whole device hierarchy against hypre_tpu's, on the CPU:
the 27-pt Laplacian on an 8^3 grid, whose rows hold many entries equal
in exact arithmetic, so that ext+i truncation keeps the same entries
only if the values agree to the last bit.  As
test_torch_device_hierarchy.py does for the 7-pt grid: level sizes and
CF bit for bit; A, P and R within 1e-12 of their largest entry."""
import pytest
import torch
from torch_port_helpers import (
    HIERARCHY_CHECKS, LAPLACE_27PT, check_device_hierarchy,
    port_device_hierarchy, ref_device_hierarchy,
)

torch.set_num_threads(1)
GRID = (8, 8, 8)


@pytest.fixture(scope="module")
def pair():
    return (ref_device_hierarchy(GRID, LAPLACE_27PT),
            *port_device_hierarchy(GRID, LAPLACE_27PT))


@pytest.mark.parametrize("which", HIERARCHY_CHECKS)
def test_27pt_hierarchy_equals_reference(pair, which):
    check_device_hierarchy(*pair, which)
