"""The port's GMRES and BiCGSTAB against hypre_tpu's.

13^3 convection-diffusion (nonsymmetric), preconditioned by BoomerAMG
(HMIS, ext+i, l1-Jacobi) or by the diagonal.  13^3 is past the 2048-row
dense limit, so both packages apply A as DIA with the same sums (bit
for bit, tests/test_torch_dia.py) and only the dot products' order
differs.  Iteration counts must be equal; x agrees to 1e-10 relative
and the final relative residual to rtol 1e-6: the two loops do the same
arithmetic in f64, the port's small Hessenberg system on the host.

BiCGSTAB with the diagonal alone is the exception: over its ~40 steps
its recurrence amplifies those last-bit differences of the dots.  On
this convection-diffusion problem even the iteration counts part (44
against 47); on the 13^3 Laplacian they agree, but the last residual
differs between the packages by up to 127% and x by up to 3e-8
(measured on two right-hand sides).  So it runs on the Laplacian and
is held to equal iterations, both residuals at the tolerance, and x
within 1e-6: within the bound of two solutions that both meet
||r|| <= 1e-8 ||b|| (cond(D^-1 A) ~ 1e2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import rel_diff

from hypre_tpu.gen import difconv as ref_difconv
from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu.solvers import krylov_more as ref_krylov
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.gen import difconv, laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import amg as port_amg
from hypre_tpu_torch.solvers import krylov_more

torch.set_num_threads(1)
N = 13
AMG = dict(coarsen_type="hmis", interp_type=6, relax_type=18)


def _problem(gen):
    return gen(N, N, N, ax=2.0, ay=-1.0, az=0.5)


@pytest.fixture(scope="module")
def ref_side():
    A = _problem(ref_difconv)
    amg = ref_amg.BoomerAMG(ref_amg.AmgConfig(**AMG)).setup(A)
    dinv = jnp.asarray(1.0 / A.diagonal())
    return {"A": A, "op": ref_op(A), "amg": amg,
            "ds": lambda r: dinv * r}


@pytest.fixture(scope="module")
def port_side():
    set_config(Config(device="cpu"))
    A = _problem(difconv)
    amg = port_amg.BoomerAMG(port_amg.AmgConfig(**AMG)).setup(A)
    dinv = torch.from_numpy(1.0 / A.diagonal())
    return {"A": A, "op": sparse_op_from_scipy(A), "amg": amg,
            "ds": lambda r: dinv * r}


SOLVERS = {"gmres5": ("gmres", {"k_dim": 5}),
           "gmres20": ("gmres", {"k_dim": 20}),
           "bicgstab": ("bicgstab", {})}


def _solve_both(ref_side, port_side, solver, precond):
    set_config(Config(device="cpu"))
    name, kw = SOLVERS[solver]
    b = np.random.default_rng(3).standard_normal(N ** 3)
    want = getattr(ref_krylov, name)(ref_side["op"], jnp.asarray(b),
                                     M=ref_side[precond], tol=1e-8,
                                     max_iter=500, **kw)
    got = getattr(krylov_more, name)(port_side["op"], b,
                                     M=port_side[precond], tol=1e-8,
                                     max_iter=500, **kw)
    assert got.iters == int(want.iters)
    assert got.relres <= 1e-8
    return got, want


@pytest.mark.parametrize("solver,precond", [
    ("gmres5", "amg"), ("gmres5", "ds"), ("gmres20", "amg"),
    ("gmres20", "ds"), ("bicgstab", "amg")])
def test_solver_matches_reference(ref_side, port_side, solver, precond):
    got, want = _solve_both(ref_side, port_side, solver, precond)
    assert got.relres == pytest.approx(float(want.relres), rel=1e-6)
    assert rel_diff(got.x.numpy(), np.asarray(want.x)) <= 1e-10


def test_bicgstab_ds_converges_with_reference():
    set_config(Config(device="cpu"))
    A = laplacian(N, N, N)
    dinv = 1.0 / A.diagonal()
    ref_side = {"op": ref_op(A), "ds": lambda r: jnp.asarray(dinv) * r}
    port_side = {"op": sparse_op_from_scipy(A),
                 "ds": lambda r: torch.from_numpy(dinv) * r}
    got, want = _solve_both(ref_side, port_side, "bicgstab", "ds")
    assert float(want.relres) <= 1e-8
    assert rel_diff(got.x.numpy(), np.asarray(want.x)) <= 1e-6
