"""The port's host setup under aggressive coarsening (multipass 4 and
8, the 2-stage 5 and 7 of out.17 and out.21), non-Galerkin coarse
operators and systems AMG (unknown-based and nodal) builds hypre_tpu's
hierarchy bit for bit, with the OpenMP kernels on and off.  The 2-stage
options run on the 27-pt Laplacian, as out.17 does."""
import pytest
import torch
from torch_port_helpers import (
    check_host_hierarchy, coupled_system, set_native,
)

from hypre_tpu_torch.gen import laplacian, laplacian_27pt

torch.set_num_threads(1)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("agg_interp", [4, 5, 7, 8])
def test_aggressive_hierarchy_matches_reference(monkeypatch, agg_interp,
                                                native):
    set_native(monkeypatch, native)
    A = laplacian_27pt(12, 12, 12) if agg_interp in (5, 7) else \
        laplacian(16, 15, 14)
    check_host_hierarchy(A, agg_num_levels=1, agg_interp_type=agg_interp,
                         interp_type=6, coarsen_type="pmis")


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("tols", [dict(nongalerk_tol_all=0.05),
                                  dict(nongalerk_tol=(0.0, 0.1),
                                       nongalerk_tol_all=0.02)],
                         ids=["all", "per_level"])
def test_nongalerkin_hierarchy_matches_reference(monkeypatch, tols, native):
    set_native(monkeypatch, native)
    check_host_hierarchy(laplacian(14, 13, 12), interp_type=6, **tols)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("nodal", [0, 1, 3])
def test_systems_hierarchy_matches_reference(monkeypatch, nodal, native):
    set_native(monkeypatch, native)
    check_host_hierarchy(coupled_system(16, nf=3, eps=0.1), interp_type=6,
                         num_functions=3, nodal=nodal)
