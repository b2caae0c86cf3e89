"""Relax 10 (Gauss-Seidel in the topological order of A's dependency
graph, an exact forward sweep on the permuted operator) against
hypre_tpu's, f64, on the 16^3 Laplacian of test_torch_cycles.py: one
cycle to 1e-12 relative, and the standalone AMG iteration (relax 10 is
a one-sided sweep, so not a PCG preconditioner) with the same iteration
count and x to 1e-10.  The reference runs under jax.jit: eagerly its
wavefront solves compile one XLA op per shape."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import amg_pair, rel_diff

from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.solvers.amg import topo_order

torch.set_num_threads(1)
N = 16


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def test_topo_order_matches_reference():
    from hypre_tpu.gen import difconv

    for A in (difconv(9, 8, 1, ax=1.0, ay=0.5, atype=0),
              difconv(6, 5, 4)):
        np.testing.assert_array_equal(topo_order(A), ref_amg._topo_order(A))


def test_topo_gs_cycle_and_solve_match_reference():
    ref, port = amg_pair(N, relax_type=10)
    f = np.random.default_rng(5).standard_normal(N ** 3)
    want = np.asarray(jax.jit(ref_amg.amg_cycle)(ref.hierarchy,
                                                 jnp.asarray(f)))
    got = port.precondition(torch.from_numpy(f)).numpy()
    assert rel_diff(got, want) <= 1e-12
    b = np.ones(N ** 3)
    x_ref, it_ref, _ = ref.solve(b, tol=1e-7, max_iter=60)
    x, it, rel = port.solve(b, tol=1e-7, max_iter=60)
    assert it == int(it_ref) and rel <= 1e-7
    assert rel_diff(x.numpy(), np.asarray(x_ref)) <= 1e-10
