"""The port's AIR restriction and GSMG interpolation against
hypre_tpu's, level by level.

Both solve many small dense systems: the reference with
jnp.linalg.solve, the port with numpy's LAPACK in f64 (it may not
import JAX).  The two may round the last bits differently, so R, P and
the coarse operators are held to 1e-12 of each operator's largest entry
while the CF splits and every sparsity pattern must be equal; the
values that need no solve (one-point P, the strength, the coarsening)
then agree exactly by construction.  AIR runs on the advection-dominated
problem of tests/test_air.py, GSMG on the 7-pt Laplacian."""
import pytest
import torch
from torch_port_helpers import check_host_hierarchy, set_native

from hypre_tpu_torch.gen import difconv, laplacian

torch.set_num_threads(1)
TOL = 1e-12


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("restr", [1, 2, 3, 4])
def test_air_hierarchy_matches_reference(monkeypatch, restr, native):
    set_native(monkeypatch, native)
    A = difconv(16, 16, 1, cx=1e-3, cy=1e-3, ax=1.0, ay=0.5, atype=0)
    check_host_hierarchy(A, tol=TOL, restr_type=restr)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_gsmg_hierarchy_matches_reference(monkeypatch, native):
    set_native(monkeypatch, native)
    check_host_hierarchy(laplacian(12, 12, 12), tol=TOL, gsmg=4,
                         num_samples=5)
