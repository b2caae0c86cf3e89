"""The port's host setup under the coarsenings beyond PMIS and HMIS
(CLJP, Falgout, Ruge-Stueben, CGC, compatible relaxation) builds
hypre_tpu's hierarchy bit for bit: CF, P, R and every coarse A, level by
level, with the OpenMP kernels on and off (CLJP and the Ruge-Stueben
second pass are native in both packages; the off switch moves the
strength, interpolation and RAP around them to numpy)."""
import pytest
import torch
from torch_port_helpers import check_host_hierarchy, set_native

from hypre_tpu_torch.gen import laplacian, laplacian_27pt

torch.set_num_threads(1)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("coarsen", ["cljp", "falgout", "ruge", "cgc",
                                     "cr"])
def test_coarsening_hierarchy_matches_reference(monkeypatch, coarsen,
                                                native):
    set_native(monkeypatch, native)
    check_host_hierarchy(laplacian(14, 13, 12), coarsen_type=coarsen,
                         interp_type=6)


@pytest.mark.parametrize("coarsen", ["cljp", "falgout"])
def test_coarsening_27pt_matches_reference(coarsen):
    check_host_hierarchy(laplacian_27pt(12, 12, 12), coarsen_type=coarsen,
                         interp_type=3)
