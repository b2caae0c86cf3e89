"""The port's whole device hierarchy against hypre_tpu's, on the CPU:
the 7-pt Laplacian on a 10x9x8 grid (the 27-pt grid is in
test_torch_device_hierarchy_27pt.py, a file of its own to keep each
file's run short).

The reference side chains hypre_tpu's stage functions the way its
iter_device_hierarchy does, with small explicit chunks
(torch_port_helpers.ref_device_hierarchy); the port runs its own
iter_device_hierarchy and BoomerAMG.setup_device.  Level sizes and CF
bit for bit; A, P and R within 1e-12 of their largest entry (the port
sums in the reference's order, so they in fact agree exactly)."""
import pytest
import torch
from torch_port_helpers import (
    HIERARCHY_CHECKS, LAPLACE_7PT, check_device_hierarchy,
    port_device_hierarchy, ref_device_hierarchy,
)

torch.set_num_threads(1)
GRID = (10, 9, 8)


@pytest.fixture(scope="module")
def pair():
    return (ref_device_hierarchy(GRID, LAPLACE_7PT),
            *port_device_hierarchy(GRID, LAPLACE_7PT))


@pytest.mark.parametrize("which", HIERARCHY_CHECKS)
def test_7pt_hierarchy_equals_reference(pair, which):
    check_device_hierarchy(*pair, which)
