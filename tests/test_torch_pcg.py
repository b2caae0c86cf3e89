"""The slice end to end: AMG-PCG at 24^3 in the port and in hypre_tpu.

The grid, solver and interpolation types are those of
tests/golden/solvers.jobs:7-8 (ij -n 24 24 24 -solver 1 -interptype 6
and 3), run through the ij driver's calls: hypre_tpu's BoomerAMG and
pcg on sparse_op_from_scipy(A), b = ones, tol 1e-8.  The smoother is
the out.14 l1-Jacobi (relax 18), the one the port carries; coarsening
is HMIS (the ij default) and PMIS (out.14).  The port takes the same
matrix, once with its level 0 as the analytic stencil and once as CSR.
Iteration counts must be equal; x agrees to f64 rel 1e-10."""
import numpy as np
import pytest
import torch
from torch_port_helpers import LAPLACE_7PT, rel_diff

from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import AmgConfig as RefConfig
from hypre_tpu.solvers import BoomerAMG as RefAMG
from hypre_tpu.solvers import pcg as ref_pcg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg

torch.set_num_threads(1)
N = 24


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def _reference(interp, coarsen, b):
    A = ref_laplacian(N, N, N)
    amg = RefAMG(RefConfig(interp_type=interp, coarsen_type=coarsen,
                           relax_type=18)).setup(A)
    res = ref_pcg(ref_op(A), b, M=amg, tol=1e-8, max_iter=1000)
    return int(res.iters), np.asarray(res.x), float(res.relres)


@pytest.mark.parametrize("level0", ["stencil", "csr"])
@pytest.mark.parametrize("coarsen", ["hmis", "pmis"])
@pytest.mark.parametrize("interp", [6, 3])
def test_amg_pcg_matches_reference(interp, coarsen, level0):
    b = np.ones(N ** 3)
    it_ref, x_ref, rel_ref = _reference(interp, coarsen, b)
    A = laplacian(N, N, N)
    stencil = ((N, N, N), LAPLACE_7PT) if level0 == "stencil" else None
    amg = BoomerAMG(AmgConfig(interp_type=interp, coarsen_type=coarsen,
                              relax_type=18)).setup(A, fine_stencil=stencil)
    op = amg.hierarchy.levels[0].A if stencil else sparse_op_from_scipy(A)
    res = pcg(op, b, M=amg, tol=1e-8, max_iter=1000)
    assert res.iters == it_ref
    assert res.relres <= 1e-8
    assert abs(res.relres - rel_ref) <= 1e-6 * rel_ref
    assert bool(torch.isfinite(res.x).all())
    assert rel_diff(res.x.numpy(), x_ref) <= 1e-10
    true = np.linalg.norm(b - A @ res.x.numpy()) / np.linalg.norm(b)
    assert true <= 1e-8


def test_unpreconditioned_cg_matches_reference():
    n = 12
    b = np.random.default_rng(8).standard_normal(n ** 3)
    ref = ref_pcg(ref_op(ref_laplacian(n, n, n)), b, tol=1e-10,
                  max_iter=500)
    res = pcg(sparse_op_from_scipy(laplacian(n, n, n)), b, tol=1e-10,
              max_iter=500)
    assert res.iters == int(ref.iters)
    assert rel_diff(res.x.numpy(), np.asarray(ref.x)) <= 1e-10


def test_zero_rhs_takes_no_iterations():
    A = laplacian(10, 10, 10)
    amg = BoomerAMG(AmgConfig(interp_type=6)).setup(A)
    res = pcg(sparse_op_from_scipy(A), np.zeros(1000), M=amg)
    assert res.iters == 0 and res.relres == 0.0
    assert torch.equal(res.x, torch.zeros(1000, dtype=torch.float64))


def test_callable_operator_and_preconditioner():
    A = laplacian(10, 10, 10)
    amg = BoomerAMG(AmgConfig(interp_type=6)).setup(A)
    op = sparse_op_from_scipy(A)
    b = np.ones(1000)
    a = pcg(op, b, M=amg, tol=1e-9)
    c = pcg(lambda v: torch.mv(op.vals, v), b, M=amg.precondition, tol=1e-9)
    assert a.iters == c.iters
    assert rel_diff(c.x.numpy(), a.x.numpy()) <= 1e-12
