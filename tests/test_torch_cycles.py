"""The port's smoothers and cycles beyond Jacobi and the V-cycle against
hypre_tpu's amg_cycle, f64.

Both packages set up the same 16^3 Laplacian on the host (bit for bit,
tests/test_torch_setup.py and the breadth tests), then one cycle of
each takes the same right-hand side: relax 5, 11, 12, 16 and 30,
CF-ordered relaxation (relax_order 1), the W and F cycles, and the
additive, mult-additive (additive from level 1, multiplicative above)
and simple cycles.  The results agree to 1e-12 relative (the orders of
the sums differ), and PCG with each as its preconditioner takes the
same number of iterations.  Relax 10 has a file of its own
(test_torch_topo_gs.py), to keep each file's run short."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import amg_pair, rel_diff

from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu.solvers import pcg as ref_pcg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import pcg

torch.set_num_threads(1)
N = 16

CASES = {
    "relax5": dict(relax_type=5),
    "relax11": dict(relax_type=11), "relax12": dict(relax_type=12),
    "relax16": dict(relax_type=16), "relax30": dict(relax_type=30),
    "cf_order_jacobi": dict(relax_type=18, relax_order=1),
    "cf_order_two_stage": dict(relax_type=11, relax_order=1),
    "W": dict(cycle_type="W"), "F": dict(cycle_type="F"),
    "W_cheby": dict(cycle_type="W", relax_type=16),
    "additive": dict(additive=0), "mult_additive": dict(additive=1),
    "additive_range": dict(additive=1, add_last_lvl=2),
    "simple": dict(simple=0),
}


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


@pytest.mark.parametrize("case", list(CASES))
def test_one_cycle_matches_reference(case):
    ref, port = amg_pair(N, stencil=case == "relax16", **CASES[case])
    f = np.random.default_rng(5).standard_normal(N ** 3)
    want = np.asarray(jax.jit(ref_amg.amg_cycle)(ref.hierarchy,
                                                 jnp.asarray(f)))
    got = port.precondition(torch.from_numpy(f)).numpy()
    assert np.isfinite(got).all()
    assert rel_diff(got, want) <= 1e-12


@pytest.mark.parametrize("case", list(CASES))
def test_pcg_iterations_match_reference(case):
    ref, port = amg_pair(N, **CASES[case])
    b = np.ones(N ** 3)
    res_ref = ref_pcg(ref_op(ref_laplacian(N, N, N)), b, M=ref, tol=1e-8,
                      max_iter=300)
    res = pcg(sparse_op_from_scipy(laplacian(N, N, N)), b, M=port,
              tol=1e-8, max_iter=300)
    assert res.iters == int(res_ref.iters)
    assert res.relres <= 1e-8

