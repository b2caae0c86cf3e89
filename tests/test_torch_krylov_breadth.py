"""The port's FlexGMRES, LGMRES, COGMRES and CGNR against hypre_tpu's.

One problem for the file (the reference compiles each solver's
while_loop once): the 13^3 convection-diffusion operator for the GMRES
variants, the 13^3 Laplacian for CGNR (its default A^T = A), each
preconditioned by BoomerAMG (HMIS, ext+i, l1-Jacobi) or by the
diagonal.  13^3 is past the 2048-row dense limit, so both packages
apply A as DIA with the same sums and only the dot products' order
differs.  Iteration counts must be equal and x agree to 1e-10
relative.

DS-CGNR is the exception: CG on the normal equations of the
diagonally scaled Laplacian takes ~210 steps, over which its recurrence
amplifies those last-bit differences of the dots (the last residuals
differ by ~3%, x by ~8e-10).  It is held to equal iterations, both
residuals at the tolerance, and x within 1e-8: inside the 2e-8 cond(A)
(~1.4e-6) bound of two solutions that both meet ||r|| <= 1e-8 ||b||."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import rel_diff

from hypre_tpu.gen import difconv as ref_difconv
from hypre_tpu.gen import laplacian as ref_laplacian
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
# solver: (its problem, keyword arguments)
SOLVERS = {"flexgmres": ("difconv", {"k_dim": 5}),
           "lgmres": ("difconv", {"k_dim": 5, "aug_dim": 2}),
           "cogmres": ("difconv", {"k_dim": 5}),
           "cgnr": ("laplacian", {})}


def _matrix(gens, name):
    difc, lap = gens
    return difc(N, N, N, ax=2.0, ay=-1.0, az=0.5) if name == "difconv" \
        else lap(N, N, N)


@pytest.fixture(scope="module")
def sides():
    set_config(Config(device="cpu"))
    ref, port = {}, {}
    for name in ("difconv", "laplacian"):
        A = _matrix((ref_difconv, ref_laplacian), name)
        amg = ref_amg.BoomerAMG(ref_amg.AmgConfig(**AMG)).setup(A)
        dinv = jnp.asarray(1.0 / A.diagonal())
        ref[name] = {"op": ref_op(A), "amg": amg,
                     "ds": lambda r, d=dinv: d * r}
        A = _matrix((difconv, laplacian), name)
        amg = port_amg.BoomerAMG(port_amg.AmgConfig(**AMG)).setup(A)
        dinv = torch.from_numpy(1.0 / A.diagonal())
        port[name] = {"op": sparse_op_from_scipy(A), "amg": amg,
                      "ds": lambda r, d=dinv: d * r}
    return ref, port


@pytest.mark.parametrize("precond", ["amg", "ds"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_matches_reference(sides, solver, precond):
    x_tol = 1e-8 if (solver, precond) == ("cgnr", "ds") else 1e-10
    set_config(Config(device="cpu"))
    ref, port = sides
    problem, kw = SOLVERS[solver]
    b = np.random.default_rng(5).standard_normal(N ** 3)
    want = getattr(ref_krylov, solver)(
        ref[problem]["op"], jnp.asarray(b), M=ref[problem][precond],
        tol=1e-8, max_iter=400, **kw)
    got = getattr(krylov_more, solver)(
        port[problem]["op"], b, M=port[problem][precond], tol=1e-8,
        max_iter=400, **kw)
    assert got.iters == int(want.iters)
    assert got.relres <= 1e-8 and float(want.relres) <= 1e-8
    assert rel_diff(got.x.numpy(), np.asarray(want.x)) <= x_tol
