"""The port's host setup under the long-range interpolations (classical
0, standard 8, standard with separate weights 9, extended 14) builds
hypre_tpu's hierarchy bit for bit, with the OpenMP lr_interp kernel and
with its numpy twin, on the 7-pt and the 27-pt Laplacian (a 27-pt row
has the distance-2 couplings that separate the variants)."""
import pytest
import torch
from torch_port_helpers import check_host_hierarchy, set_native

from hypre_tpu_torch.gen import laplacian, laplacian_27pt

torch.set_num_threads(1)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("interp", [0, 8, 9, 14])
@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_lr_interp_hierarchy_matches_reference(monkeypatch, stencil,
                                               interp, native):
    set_native(monkeypatch, native)
    A = laplacian(14, 13, 12) if stencil == "7pt" else \
        laplacian_27pt(11, 10, 10)
    check_host_hierarchy(A, interp_type=interp, coarsen_type="pmis",
                         p_max_elmts=4)
